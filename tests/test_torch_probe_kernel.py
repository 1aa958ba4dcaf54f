"""The tile-shape probe kernel against its plain version on the card.

Imports only torch, numpy and the port, so it runs on the GPU machine, which
has no JAX (``--noconftest`` skips the JAX-pinning conftest there):

    python3 -m pytest --noconftest -q -m cuda tests/test_torch_probe_kernel.py

Without a card every test skips (the CPU suite holds the plain version
against the TPU kernel in interpret mode in test_torch_probe.py).

Limit: ``PROBE_RTOL`` * sum|s| with ``PROBE_RTOL`` = 1e-6: the kernel and the
plain version add iters * M * N signed f32 terms in different orders (each
thread of the kernel keeps a running sum of ~1000 terms an iteration), and
the products are exact. On an H100 the readings were at most 1e-8 * sum|s|;
an 8 x 8 piece of the product left out of every iteration moves the sum by
25 times the limit or more at the 512 x 512 shapes.
"""

import numpy as np
import pytest
import torch

from image_editing_framework_torch.tools import bench_attn_layouts as tprobe

PROBE_RTOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernel runs only there")
    return torch.device("cuda")


def _abs_sum(a, b, contract, iters):
    (ca,), (cb,) = contract
    s = (a.float() if ca == 1 else a.float().T) @ (b.float() if cb == 1 else b.float().T).T
    return iters * s.abs().sum().item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64, 128])
@pytest.mark.parametrize("name", sorted(tprobe.LAYOUTS))
def test_probe_kernel_matches_plain_version(cuda_device, name, d):
    a, b, contract = tprobe.operands(d, np.random.RandomState(d), cuda_device)[name]
    iters, blocks = 3, 5
    before = tprobe.probe.launches
    out = tprobe.probe(a, b, contract, iters, blocks)
    torch.cuda.synchronize()
    assert tprobe.probe.launches == before + 1
    ref = tprobe.probe_reference(a, b, contract, iters)
    assert out.shape == (blocks,) and (out == out[0]).all()  # every block computes the same sum
    assert abs(out[0].item() - ref.item()) <= PROBE_RTOL * _abs_sum(a, b, contract, iters)


@pytest.mark.cuda
def test_probe_kernel_small_and_ragged_shapes(cuda_device):
    """Extents off the 16-row and 16-deep tiles (padded with zeros in shared
    memory) and a zero iteration count."""
    g = torch.Generator(device=cuda_device).manual_seed(1)

    def rand(*shape):
        return torch.randn(*shape, device=cuda_device, generator=g).to(torch.bfloat16)

    cases = [(rand(24, 40), rand(64, 40), ((1,), (1,))), (rand(40, 24), rand(40, 128), ((0,), (0,))),
             (rand(128, 72), rand(72, 24), ((1,), (0,)))]
    for a, b, contract in cases:
        out = tprobe.probe(a, b, contract, 2, 2)
        ref = tprobe.probe_reference(a, b, contract, 2)
        assert abs(out[0].item() - ref.item()) <= PROBE_RTOL * _abs_sum(a, b, contract, 2)
        assert tprobe.probe(a, b, contract, 0, 1).item() == 0.0


@pytest.mark.cuda
def test_probe_kernel_refuses_what_it_does_not_take(cuda_device):
    """No fallback on the card: an unsupported layout or size raises."""
    a = torch.zeros(512, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        tprobe.probe(a.T.contiguous(), a, ((0,), (1,)), 1)  # lhs strided, rhs plain
    with pytest.raises(ValueError, match="does not take"):
        tprobe.probe(a[:100], a[:100], ((1,), (1,)), 1)  # streamed rows not a multiple of 64
    with pytest.raises(ValueError, match="contiguous"):
        tprobe.probe(a[:, :32], a[:, :32], ((1,), (1,)), 1)


@pytest.mark.cuda
def test_probe_time_is_linear_in_iters(cuda_device):
    a, b, contract = tprobe.operands(64, np.random.RandomState(0), cuda_device)["s_lane"]
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    r = tprobe.probe_layout(a, b, contract, blocks, lo=256, hi=1280)
    assert r["us_per_iter"] > 0 and 0.8 < r["linearity"] < 1.25, r


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(tprobe.LAYOUTS))
def test_probe_kernel_across_the_rings_wrap(cuda_device, name):
    """Iteration counts that are no multiple of the ring's depth, so that the
    slots' barriers change phase in the middle of an iteration (the 512 x
    512 layouts at 5 iterations; a 24-row rescaled operand, one slot an
    iteration, at 7)."""
    a, b, contract = tprobe.operands(64, np.random.RandomState(7), cuda_device)[name]
    cases = [(a, b, contract, 5)]
    if name == "s_lane":
        cases.append((a[:24].contiguous(), b[:64].contiguous(), contract, 7))
    for a, b, contract, iters in cases:
        out = tprobe.probe(a, b, contract, iters, 3)
        ref = tprobe.probe_reference(a, b, contract, iters)
        assert (out == out[0]).all()
        assert abs(out[0].item() - ref.item()) <= PROBE_RTOL * _abs_sum(a, b, contract, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(tprobe.LAYOUTS))
def test_probe_kernel_reruns_bit_for_bit(cuda_device, name):
    """No atomics and a fixed order of the sum: two launches on the same
    operands give the same bits."""
    a, b, contract = tprobe.operands(40, np.random.RandomState(3), cuda_device)[name]
    first = tprobe.probe(a, b, contract, 4, 8)
    second = tprobe.probe(a, b, contract, 4, 8)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_the_kernels_plan_is_the_tools(cuda_device):
    """``mma_probe_plan`` in the built library and ``plan`` in the tool agree
    on every layout and head dim, on the ragged shapes and on refusals."""
    shapes = []
    for name, (contract, a_shape, b_shape) in tprobe.LAYOUTS.items():
        (ca,), (cb,) = contract
        for d in tprobe.HEAD_DIMS:
            a, b = a_shape(d), b_shape(d)
            shapes.append((ca == 0, cb == 0, a[1 - ca], b[1 - cb], a[ca]))
    shapes += [(False, False, 24, 64, 40), (True, True, 24, 128, 40), (False, True, 128, 24, 72),
               (True, False, 64, 512, 64), (False, False, 100, 100, 64), (False, True, 64, 512, 64),
               (False, False, 256, 512, 512), (False, False, 512, 1024, 512)]
    for shape in shapes:
        want = tprobe.plan(*shape)
        if want is not None:
            want = {key: want[key] for key in tprobe.PLAN_FIELDS}
        assert tprobe.kernel_plan(*shape) == want, shape

"""The tile-shape probe's plain version against the TPU probe kernel.

``tools/bench_attn_layouts.py`` (the JAX tool, loaded by path and not
edited) defines ``_probe_kernel``; here it runs through ``pl.pallas_call`` in
interpret mode on the CPU, on small operands and a handful of iterations,
for the four contractions of the attention products. The port's
``probe_reference`` takes the same numpy-seeded bf16 operands.

Tolerance: both sum ``iters * M * N`` signed f32 terms in their own order, so
the limit is relative to the sum of the terms' magnitudes:
``RTOL_ABS_SUM`` * sum|s| with ``RTOL_ABS_SUM`` = 1e-6, about sqrt(terms)
f32 roundings of a term's size (20480 terms here). The products themselves
are exact in f32 (bf16 x bf16). An f64 sum of the same terms sizes the error
of each side. One 8 x 8 piece of the product left out moves the sum by far
more than the limit.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from image_editing_framework_torch.tools import bench_attn_layouts as tprobe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_ABS_SUM = 1e-6
ITERS = 5
N, D = 64, 16  # a small tile and head dim, the four layouts in the tool's shapes

SHAPES = {
    "s_lane": (((1,), (1,)), (N, D), (N, D)),
    "s_sub": (((0,), (0,)), (D, N), (D, N)),
    "pv_lane": (((1,), (0,)), (N, N), (N, D)),
    "pv_sub": (((1,), (1,)), (D, N), (N, N)),
}


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_bench_attn_layouts",
                                                  os.path.join(ROOT, "tools", "bench_attn_layouts.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _operands(name):
    _, a_shape, b_shape = SHAPES[name]
    rng = np.random.RandomState(sorted(SHAPES).index(name))
    return rng.randn(*a_shape).astype(np.float32), rng.randn(*b_shape).astype(np.float32)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _exact(a, b, contract, iters):
    """(f64 sum of the terms, f64 sum of their magnitudes) on bf16 operands."""
    (ca,), (cb,) = contract
    a64, b64 = _bf16(a).double(), _bf16(b).double()
    s = (a64 if ca == 1 else a64.T) @ (b64 if cb == 1 else b64.T).T
    return iters * s.sum().item(), iters * s.abs().sum().item()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_probe_reference_matches_the_pallas_kernel(jax_tool, name):
    contract = SHAPES[name][0]
    a, b = _operands(name)
    kernel = functools.partial(jax_tool._probe_kernel, iters=ITERS, dn=contract)
    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32), interpret=True)(
        jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    out = np.asarray(out)
    assert (out == out[0, 0]).all()  # the kernel fills its block with acc
    ref = tprobe.probe_reference(_bf16(a), _bf16(b), contract, ITERS)
    assert ref.shape == (1,) and ref.dtype == torch.float32
    exact, abs_sum = _exact(a, b, contract, ITERS)
    limit = RTOL_ABS_SUM * abs_sum
    assert abs(ref.item() - out[0, 0]) <= limit, (ref.item(), out[0, 0], limit)
    assert abs(ref.item() - exact) <= limit and abs(out[0, 0] - exact) <= limit
    assert abs(exact) > 100 * limit  # the sum itself is far above the limit


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_limit_rejects_a_dropped_piece(name):
    """Leaving one 8 x 8 piece of the product out of every iteration moves
    the sum by more than the limit for most pieces (the median piece)."""
    contract = SHAPES[name][0]
    a, b = _operands(name)
    (ca,), (cb,) = contract
    a32, b32 = _bf16(a).float(), _bf16(b).float()
    s = (a32 if ca == 1 else a32.T) @ (b32 if cb == 1 else b32.T).T
    m, n = s.shape
    pieces = s.reshape(m // 8, 8, n // 8, 8).sum(dim=(1, 3)).abs()
    limit = RTOL_ABS_SUM * s.abs().sum().item()
    assert pieces.median().item() > 10 * limit


def test_probe_on_cpu_takes_the_plain_version_per_block():
    a, b = _operands("s_lane")
    out = tprobe.probe(_bf16(a), _bf16(b), ((1,), (1,)), 3, blocks=4)
    assert out.shape == (4,) and (out == out[0]).all()
    assert out[0].item() == tprobe.probe_reference(_bf16(a), _bf16(b), ((1,), (1,)), 3).item()
    assert tprobe.probe(_bf16(a), _bf16(b), ((1,), (1,)), 0).item() == 0.0


def test_the_smaller_operand_is_the_one_rescaled(monkeypatch):
    """With a scale large enough to move bf16 values, rescaling a (the
    smaller operand, or the lhs on a tie) and rescaling b differ: the plain
    version follows the kernel's rule."""
    monkeypatch.setattr(tprobe, "_scale", lambda i: 1.0 + 0.25 * i)
    for name, perturbed in (("s_lane", "a"), ("pv_lane", "b"), ("pv_sub", "a")):
        contract = SHAPES[name][0]
        a, b = (_bf16(x) for x in _operands(name))
        got = tprobe.probe_reference(a, b, contract, 3).item()
        (ca,), (cb,) = contract
        want = 0.0
        for i in range(3):
            ai = (a.float() * (1.0 + 0.25 * i)).to(torch.bfloat16) if perturbed == "a" else a
            bi = (b.float() * (1.0 + 0.25 * i)).to(torch.bfloat16) if perturbed == "b" else b
            s = (ai.double() if ca == 1 else ai.double().T) @ (bi.double() if cb == 1 else bi.double().T).T
            want += s.sum().item()
        assert abs(got - want) <= 1e-5 * abs(want) + 1e-3, (name, got, want)


def test_scale_is_f32_arithmetic():
    assert tprobe._scale(0) == 1.0
    assert tprobe._scale(1000) == float(np.float32(1.0) + np.float32(1e-9) * np.float32(1000))
    assert tprobe._scale(30) == 1.0  # 3e-8 is below half an f32 ulp of 1


def test_probe_refuses_bad_operands():
    a, b = (_bf16(x) for x in _operands("s_lane"))
    with pytest.raises(TypeError, match="bf16"):
        tprobe.probe(a.float(), b.float(), ((1,), (1,)), 1)
    with pytest.raises(ValueError, match="contraction"):
        tprobe.probe(a, b, ((1,), (0,)), 1)
    with pytest.raises(ValueError, match="iters"):
        tprobe.probe(a, b, ((1,), (1,)), -1)


def test_layout_operands_have_the_jax_tools_shapes(jax_tool):
    assert (tprobe.BQ, tprobe.BK) == (jax_tool.BQ, jax_tool.BK)
    ops = tprobe.operands(40, np.random.RandomState(0), "cpu")
    assert sorted(ops) == sorted(tprobe.LAYOUTS)
    assert ops["s_lane"][0].shape == (512, 40) and ops["s_sub"][0].shape == (40, 512)
    assert ops["pv_lane"][0].shape == (512, 512) and ops["pv_lane"][1].shape == (512, 40)
    assert ops["pv_sub"][0].shape == (40, 512) and ops["pv_sub"][1].shape == (512, 512)
    assert torch.equal(ops["s_sub"][0], ops["s_lane"][0].T) and torch.equal(ops["pv_sub"][0], ops["pv_lane"][1].T)
    assert all(a.is_contiguous() and b.is_contiguous() and a.dtype == torch.bfloat16 for a, b, _ in ops.values())


def test_timing_needs_the_card():
    a, b = (_bf16(x) for x in _operands("s_lane"))
    with pytest.raises(RuntimeError, match="card"):
        tprobe.probe_layout(a, b, ((1,), (1,)), blocks=1)

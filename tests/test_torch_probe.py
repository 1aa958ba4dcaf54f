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


def _layout_args(name, d):
    (ca,), (cb,) = tprobe.LAYOUTS[name][0]
    a_shape, b_shape = tprobe.LAYOUTS[name][1](d), tprobe.LAYOUTS[name][2](d)
    return ca == 0, cb == 0, a_shape[1 - ca], b_shape[1 - cb], a_shape[ca]


@pytest.mark.parametrize("d", [40, 64, 128])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_of_each_layout(name, d):
    """The table the kernel follows: the scores stream the rescaled a
    against a resident b (K-major stored plain, MN-major stored
    transposed); the weighted sums stream P in 64-deep K chunks against the
    rescaled V (MN-major) or V^T (K-major, the sum of the transposed
    product), at the wgmma width d."""
    q = tprobe.plan(*_layout_args(name, d))
    kp = -(-d // 16) * 16
    want = {
        "s_lane": dict(cls="s", a_is_b=0, ta=0, tb=0, m=512, n=512, k=d, kp=kp, np=512, rescaled="a",
                       l2_bytes_per_iter=512 * d * 2),
        "s_sub": dict(cls="s", a_is_b=0, ta=1, tb=1, m=512, n=512, k=d, kp=kp, np=512, rescaled="a",
                      l2_bytes_per_iter=512 * d * 2),
        "pv_lane": dict(cls="pv", a_is_b=0, ta=0, tb=1, m=512, n=d, k=512, kp=512, np=d,
                        rescaled="b", l2_bytes_per_iter=(512 + d) * 512 * 2),
        "pv_sub": dict(cls="pv", a_is_b=1, ta=0, tb=0, m=512, n=d, k=512, kp=512, np=d, rescaled="a",
                       l2_bytes_per_iter=(512 + d) * 512 * 2),
    }[name]
    assert {key: q[key] for key in want} == want
    assert q["ring"] >= 2 and q["smem"] <= tprobe.MAX_SMEM
    if q["cls"] == "pv":  # P alone is 512 KB: it streams, and as many slots as fit ring it
        slot = (q["m"] + (-(-q["np"] // 64) * 64 if q["tb"] else q["np"])) * tprobe.CHUNK * 2
        assert q["ring"] == min(tprobe.MAX_RING_PV, (tprobe.MAX_SMEM - 1024 - tprobe.barrier_bytes(tprobe.MAX_RING_PV)) // slot)


def test_plan_of_the_ragged_shapes_and_refusals():
    """The kernel test's ragged shapes (a 24-row rescaled operand padded to
    one 64-row chunk and b to one 128-column piece; K = 72 in two 64-deep
    chunks, V's 24 columns padded to the narrowest wgmma width, 32) and what
    the kernel refuses."""
    q = tprobe.plan(False, False, 24, 64, 40)
    assert (q["cls"], q["m"], q["n"], q["kp"], q["np"], q["rescaled"]) == ("s", 24, 64, 48, 128, "a")
    q = tprobe.plan(True, True, 24, 128, 40)
    assert (q["cls"], q["ta"], q["tb"], q["kp"], q["np"]) == ("s", 1, 1, 48, 128)
    q = tprobe.plan(False, True, 128, 24, 72)
    assert (q["cls"], q["m"], q["n"], q["kp"], q["np"], q["rescaled"]) == ("pv", 128, 24, 128, 32, "b")
    assert tprobe.plan(True, False, 512, 512, 64) is None  # lhs strided, rhs plain
    assert tprobe.plan(False, False, 100, 100, 64) is None  # the larger operand's rows not a multiple of 64
    assert tprobe.plan(False, True, 64, 512, 64) is None  # plain x transposed with the smaller operand on the left
    assert tprobe.plan(False, False, 512, 512, 60) is None  # K not a multiple of 8
    assert tprobe.plan(False, False, 256, 512, 512) is None  # the PV plan's B wider than 128


def _sum_through_plan(a, b, contract, iters):
    """The kernel's arithmetic, step by step in the plan's order: the
    product laid out as the plan says (the transposed one where ``a_is_b``),
    K and B's rows zero-padded, each slot's partial product summed on its
    own (a 64-row chunk of A against all of B in the S plan, a 64-deep K
    chunk in the PV plan), one running f32 sum."""
    q = tprobe.plan_for(a, b, contract)
    (ca,), (cb,) = contract
    total = torch.zeros((), dtype=torch.float32)
    for i in range(iters):
        s = tprobe._scale(i)
        ai = (a.float() * s).to(a.dtype) if q["rescaled"] == "a" else a
        bi = (b.float() * s).to(b.dtype) if q["rescaled"] == "b" else b
        lhs, rhs = tprobe._rows_by_k(ai, ca).float(), tprobe._rows_by_k(bi, cb).float()
        if q["a_is_b"]:
            lhs, rhs = rhs, lhs
        assert lhs.shape == (q["m"], q["k"]) and rhs.shape == (q["n"], q["k"])
        lhs = torch.nn.functional.pad(lhs, (0, q["kp"] - q["k"]))
        rhs = torch.nn.functional.pad(rhs, (0, q["kp"] - q["k"], 0, q["np"] - q["n"]))
        if q["cls"] == "s":
            parts = [lhs[r:r + tprobe.CHUNK] @ rhs.T for r in range(0, q["m"], tprobe.CHUNK)]
        else:
            parts = [lhs[:, c:c + tprobe.CHUNK] @ rhs[:, c:c + tprobe.CHUNK].T for c in range(0, q["kp"], tprobe.CHUNK)]
        for part in parts:
            total = total + part.sum()
    return total


@pytest.mark.parametrize("d", [40, 64, 128])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_sum_through_the_plan_is_the_plain_version(name, d):
    a, b, contract = tprobe.operands(d, np.random.RandomState(d), "cpu")[name]
    iters = 2
    got = _sum_through_plan(a, b, contract, iters).item()
    ref = tprobe.probe_reference(a, b, contract, iters).item()
    (ca,), (cb,) = contract
    s = (a.double() if ca == 1 else a.double().T) @ (b.double() if cb == 1 else b.double().T).T
    assert abs(got - ref) <= RTOL_ABS_SUM * iters * s.abs().sum().item(), (got, ref)

"""The port's ring, Ulysses and 2D attention (``parallel/ring_attention.py``)
against the JAX package's, in f32 on the CPU.

The port's side runs in rank processes (``torch_cp_workers.py``: gloo
groups of 2 and 4 ranks, started once for the file), each rank on its own
shards of the same numpy inputs; the JAX side runs its ``shard_map``
functions (``use_flash=False``) on ``n`` of the suite's virtual CPU devices.
The ranks' output shards, put together by the chunk each rank holds, are
held to JAX's global output within ``ATOL`` = 2e-5, the JAX package's own
limit for these functions; gradients of ``sum((out - tgt)^2)`` within
``GRAD_RTOL`` = 2e-5 of the largest gradient element (f32 sums in another
order).

The merge of two -inf estimates is where the two differ on purpose: the
port's gives (0, -inf), JAX's NaN. A ring whose first two shards' keys are
all -inf is held to the plain masked softmax here, and JAX's gives NaN.
"""

import concurrent.futures
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from image_editing_framework_torch.parallel import ring_attention as ra
from image_editing_framework_tpu.parallel import ring_attention as jra
from torch_cp_workers import RING_CASES, launch, ring_inputs

ATOL = 2e-5
GRAD_RTOL = 2e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: each rank's results} for groups of 2 and 4 ranks, run side by
    side."""
    tmp = tmp_path_factory.mktemp("ring")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {world: pool.submit(launch, "ring", world, tmp) for world in (2, 4)}
        return {world: f.result() for world, f in futures.items()}


def _assemble(results, key, like):
    """The ranks' shards of ``key`` put together along the sequence."""
    out = np.zeros_like(like)
    count = len(results)
    size = out.shape[2] // count
    for res in results:
        i = int(res[key.split("/")[0] + "/chunk"])
        out[:, :, i * size:(i + 1) * size] = res[key]
    return out


def _jax_fn(mode, world, bias):
    if mode == "ulysses_ring":
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("tensor", "data"))
        return lambda q, k, v: jra.ulysses_ring_attention(q, k, v, mesh, "tensor", "data", bias=bias)
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    fn = jra.ulysses_self_attention if mode == "ulysses" else jra.ring_self_attention
    return lambda q, k, v: fn(q, k, v, mesh, "data", bias=bias)


def _cases(grad):
    return [pytest.param(name, world, id=f"{name}-{world}") for name, case in RING_CASES.items()
            if case[-1] == grad and name != "ring_neg_inf_shards" for world in case[-2]]


@pytest.mark.parametrize("name,world", _cases(grad=False))
def test_forward_matches_jax(ranks, name, world):
    q, k, v, bias, _ = ring_inputs(name)
    mode = RING_CASES[name][7]
    ref = np.asarray(_jax_fn(mode, world, None if bias is None else jnp.asarray(bias))(q, k, v))
    out = _assemble(ranks[world], f"{name}/out", ref)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,world", _cases(grad=True))
def test_gradients_match_jax_grad(ranks, name, world):
    q, k, v, bias, tgt = ring_inputs(name)
    mode = RING_CASES[name][7]
    fn = _jax_fn(mode, world, None if bias is None else jnp.asarray(bias))
    ref_out = np.asarray(fn(q, k, v))
    np.testing.assert_allclose(_assemble(ranks[world], f"{name}/out", ref_out), ref_out, atol=ATOL, rtol=0)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum((fn(q, k, v) - tgt) ** 2), argnums=(0, 1, 2)))(q, k, v)
    for t, ref in zip(("dq", "dk", "dv"), grads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(_assemble(ranks[world], f"{name}/{t}", ref), ref,
                                   atol=GRAD_RTOL * np.abs(ref).max(), rtol=0, err_msg=t)


def _masked_softmax(q, k, v, bias):
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k) / math.sqrt(q.shape[-1]) + bias[:, None, None, :]
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


def test_ring_through_neg_inf_shards(ranks):
    """Keys 0..63 of 128 at -inf on 4 ranks: every row's first two merges
    meet two -inf estimates. The port's ring is the masked softmax over the
    live keys; JAX's ring gives NaN there."""
    name = "ring_neg_inf_shards"
    q, k, v, bias, _ = ring_inputs(name)
    ref = _masked_softmax(q, k, v, bias)
    out = _assemble(ranks[4], f"{name}/out", ref.astype(np.float32))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert np.isnan(np.asarray(_jax_fn("ring", 4, jnp.asarray(bias))(q, k, v))).any()


def test_merge_of_two_neg_inf_estimates():
    o = torch.randn(1, 2, 3, 4)
    lse = torch.full((1, 2, 3), -math.inf)
    out, m = ra._merge(o, lse, o * 2, lse)
    assert torch.equal(out, torch.zeros_like(o)) and torch.equal(m, lse)
    # one side -inf: the other side as it is
    lse2 = torch.randn(1, 2, 3)
    out, m = ra._merge(o, lse, o * 2, lse2)
    torch.testing.assert_close(out, o * 2, atol=0, rtol=0)
    torch.testing.assert_close(m, lse2, atol=0, rtol=0)
    # JAX's merge of the same pair is NaN
    assert np.isnan(np.asarray(jra._merge(jnp.asarray(o.numpy()), jnp.asarray(lse.numpy()),
                                          jnp.asarray(o.numpy()), jnp.asarray(lse.numpy()))[0])).all()


def test_merge_matches_jax():
    rng = np.random.RandomState(3)
    o1, o2 = rng.standard_normal((2, 2, 3, 5, 8)).astype(np.float32)
    l1, l2 = rng.standard_normal((2, 2, 3, 5)).astype(np.float32) * 4
    out, lse = ra._merge(*map(torch.from_numpy, (o1, l1, o2, l2)))
    jout, jlse = jra._merge(*map(jnp.asarray, (o1, l1, o2, l2)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", [2, 4])
def test_ulysses_refuses_heads_off_the_ranks(ranks, world):
    """H = n + 1 heads on n ranks: every rank raises JAX's AssertionError,
    with its message, before any collective."""
    for res in ranks[world]:
        assert str(res["ulysses_bad_heads"]) == "Ulysses needs heads % devices == 0"

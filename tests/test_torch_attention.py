"""The port's attention dispatch against the JAX package's: self-attention
with P2P and multi-segment plans, and the explicit cross-attention path.

The JAX self-attention runs its Pallas kernel in interpret mode; the port's
runs the kernel's plain version on the CPU. Tolerance: atol 1e-5 in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from image_editing_framework_torch.ops import attention as tatt
from image_editing_framework_torch.ops import controls as tctl
from image_editing_framework_tpu.ops import attention as jatt
from image_editing_framework_tpu.ops import controls as jctl
from torch_port_helpers import n, t

ATOL = 1e-5


def _qkv(b, h, nn_, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, nn_, d).astype(np.float32) for _ in range(3))


def _p2p_steps(gate):
    """The JAX and port P2PStep for P = 2 prompts with the self gate set."""
    mapper = np.eye(77, dtype=np.float32)[None]
    ones = np.ones((1, 77), np.float32)
    j = jctl.P2PStep(jnp.asarray(mapper), jnp.asarray(ones), jnp.asarray(ones), jnp.asarray(ones),
                     jnp.asarray(gate), num_prompts=2)
    p = tctl.P2PStep(t(mapper), t(ones), t(ones), t(ones), gate, num_prompts=2)
    return j, p


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("d", [16, 40])
def test_self_attention_p2p_plan_matches_jax(gate, d):
    b, h, nn_ = 4, 2, 64
    q, k, v = _qkv(b, h, nn_, d, seed=d)
    site_j = jatt.AttnSite(layer=3, place="down", seq_len=nn_, is_cross=False)
    site_t = tatt.AttnSite(layer=3, place="down", seq_len=nn_, is_cross=False)
    jstep, tstep = _p2p_steps(gate)
    jplan, tplan = jstep.self_plan(site_j, b), tstep.self_plan(site_t, b)
    np.testing.assert_array_equal(n(tplan.q_idx), n(jplan.q_idx))
    np.testing.assert_array_equal(n(tplan.v_idx), n(jplan.v_idx))
    ref = jatt.self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jplan, use_flash=True)
    out = tatt.self_attention(t(q), t(k), t(v), tplan)
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=0)


def test_self_attention_multi_segment_plan_matches_jax():
    """Two K/V segments per element with one invalid segment: the plan's
    NEG_INF segment bias goes through the kernel's bias path."""
    b, h, nn_, d = 4, 2, 64, 16
    q, k, v = _qkv(b, h, nn_, d, seed=11)
    q_idx = np.arange(b, dtype=np.int32)
    k_idx = np.stack([np.zeros(b, np.int32), q_idx], axis=1)
    valid = np.array([[True, False], [True, True], [True, True], [False, True]])
    jplan = jatt.SelfAttnPlan(jnp.asarray(q_idx), jnp.asarray(k_idx), jnp.asarray(k_idx), jnp.asarray(valid))
    tplan = tatt.SelfAttnPlan(t(q_idx).long(), t(k_idx).long(), t(k_idx).long(), t(valid))
    ref = jatt.self_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jplan, use_flash=True)
    out = tatt.self_attention(t(q), t(k), t(v), tplan)
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=0)
    ident = tatt.self_attention(t(q), t(k), t(v), tatt.identity_plan(b))
    np.testing.assert_allclose(n(ident), n(tatt.self_attention(t(q), t(k), t(v), None)), atol=0, rtol=0)


def test_cross_attention_probs_and_heads_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 64, 32).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    jq, jk = jatt.split_heads(jnp.asarray(x), 2), jatt.split_heads(jnp.asarray(ctx), 2)
    tq, tk = tatt.split_heads(t(x), 2), tatt.split_heads(t(ctx), 2)
    np.testing.assert_array_equal(n(tq), n(jq))
    jp, tp = jatt.cross_attention_probs(jq, jk), tatt.cross_attention_probs(tq, tk)
    assert tp.dtype.is_floating_point and str(tp.dtype) == "torch.float32"
    np.testing.assert_allclose(n(tp), n(jp), atol=1e-6, rtol=0)
    jo, to = jatt.apply_probs(jp, jk), tatt.apply_probs(tp, tk)
    np.testing.assert_allclose(n(tatt.merge_heads(to)), n(jatt.merge_heads(jo)), atol=ATOL, rtol=0)

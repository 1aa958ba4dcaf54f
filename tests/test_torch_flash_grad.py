"""The port's flash-attention backward against the JAX package's.

On the CPU the port's backward is its plain version,
``flash_attention_bwd_reference``, the function the two CUDA kernels
compute. It is held against JAX ``flash_attention_bwd_block`` with the
Pallas backward kernels in interpret mode, both the classic pair
(``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``) and the transposed pair
(``_bwd_*_kernel_t``, no bias, d <= 64), on the same q, k, v, out, dO and
lse made with numpy. Tolerance: atol 2e-5 in f32 (sums taken in another
order; the gradients here are of order 1).

The port's autograd ``flash_attention`` (the ``FlashAttention`` Function,
whose backward is ``flash_attention_bwd``) is held against
``torch.autograd`` through the plain forward, within atol 1e-5.

A row whose every logit is -inf has lse -inf; the port gives it P = 0 and
zero gradients where the JAX kernels give NaN, so that case is held against
the definition only.

Through the whole tiny UNet (shared weights, f32, JAX ``use_flash=False``):
one null-text-inversion loss and its gradient in the embedding, within rtol
1e-5 and 1e-5 of max|g|, with every element's sign the same; and the
resetting NTI variant (SDXL's) against JAX ``_nti_scan``, with the
tolerance and the gradient margin of tests/test_torch_nti.py, which holds
the carrying variant. Each file compiles the JAX NTI once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch.core.config import NTIConfig as TNTIConfig
from image_editing_framework_torch.inversion import nti as tnti
from image_editing_framework_torch.ops import flash_attention as tfa
from image_editing_framework_tpu import cli as jcli
from image_editing_framework_tpu.core.config import NTIConfig as JNTIConfig
from image_editing_framework_tpu.core.scheduler import ddim_step as j_ddim_step
from image_editing_framework_tpu.inversion import nti as jnti
from image_editing_framework_tpu.ops import flash_attention as jfa
from torch_port_helpers import check_grad_margin, n, recorded_grads, shared_pipelines, t

ATOL_JAX = 2e-5
ATOL_AUTOGRAD = 1e-5


def _inputs(b, h, nq, nk, d, seed):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(b, h, nq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, nk, d).astype(np.float32) for _ in range(2))
    return q, k, v, g


def _bias(b, nk, seed):
    """NEG_INF segments that leave every row some live keys."""
    rng = np.random.RandomState(seed)
    bias = np.where(rng.rand(b, nk) < 0.3, jfa.NEG_INF, 0.0).astype(np.float32)
    bias[:, : nk // 4] = jfa.NEG_INF
    bias[:, nk // 4] = 0.0
    return bias


CASES = [
    # b, h, nq, nk, d, with_bias, blocks
    (1, 2, 128, 128, 40, False, None),  # SD1.5 64² head dim
    (1, 2, 128, 256, 64, False, None),  # Nq != Nk
    (2, 2, 128, 77, 64, False, None),  # 77 keys, one unpadded key block
    (2, 2, 128, 200, 16, False, (128, 128)),  # Nk padded to the key block in JAX
    (2, 2, 64, 77, 80, True, None),  # NEG_INF bias segments, classic kernels only
    (2, 2, 128, 200, 40, True, (128, 128)),  # bias + padded Nk
]


# every case through the classic JAX kernels, and the cases the transposed
# ones take (no bias, d <= 64) through those too
GRID = [c + (False,) for c in CASES] + [c + (True,) for c in CASES if not c[5] and c[4] <= 64]


@pytest.mark.parametrize("b,h,nq,nk,d,with_bias,blocks,transposed", GRID)
def test_bwd_reference_matches_jax_bwd_block(b, h, nq, nk, d, with_bias, blocks, transposed, monkeypatch):
    """``IEF_FLASH_BWD_T=1`` sends the JAX backward through the transposed
    kernels, ``0`` through the classic ones; the switch is read at trace
    time, so caches are cleared around it, as tests/test_flash_grad.py
    does."""
    q, k, v, g = _inputs(b, h, nq, nk, d, seed=nk + d)
    bias = _bias(b, nk, seed=d) if with_bias else None
    kw = dict(block_q=blocks[0], block_k=blocks[1]) if blocks else {}
    jb = jnp.asarray(bias) if with_bias else None
    out, lse = jfa.flash_attention_fwd_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, **kw)
    out, lse = np.asarray(out), np.asarray(lse)

    monkeypatch.setenv("IEF_FLASH_BWD_T", "1" if transposed else "0")
    assert jfa._use_bwd_t_layout(d, nq) == (transposed and not with_bias)
    jax.clear_caches()
    try:
        ref = jfa.flash_attention_bwd_block(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, jnp.asarray(out), jnp.asarray(g), jnp.asarray(lse),
            **kw,
        )
    finally:
        monkeypatch.delenv("IEF_FLASH_BWD_T")
        jax.clear_caches()
    got = tfa.flash_attention_bwd(t(q), t(k), t(v), t(bias) if with_bias else None, t(out), t(g), t(lse))
    for a, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert a.shape == r.shape and a.dtype == torch.float32
        np.testing.assert_allclose(n(a), n(r), atol=ATOL_JAX, rtol=0, err_msg=name)


@pytest.mark.parametrize(
    "b,h,nq,nk,d,with_bias",
    [(1, 2, 64, 64, 40, False), (2, 2, 48, 77, 16, False), (2, 3, 40, 100, 32, True), (1, 2, 70, 33, 80, True)],
)
def test_autograd_flash_matches_autograd_through_plain_forward(b, h, nq, nk, d, with_bias):
    q, k, v, g = _inputs(b, h, nq, nk, d, seed=3 + d)
    bias = t(_bias(b, nk, seed=5)) if with_bias else None

    def grads(fn):
        x = [t(a).requires_grad_(True) for a in (q, k, v)]
        out = fn(*x, bias)
        torch.autograd.backward(out, t(g))
        return out, [a.grad for a in x]

    out, got = grads(tfa.flash_attention)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    _, want = grads(tfa.flash_attention_reference)
    for a, r, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(a, r, atol=ATOL_AUTOGRAD, rtol=0, msg=name)


def test_flash_takes_the_function_only_when_a_gradient_is_wanted():
    """An inference pass (no grad, or no input that requires one) makes the
    lse-free call, as the P2P path needs; the lse never carries a gradient."""
    q, k, v, _ = (t(a) for a in _inputs(1, 2, 16, 24, 16, seed=1))
    assert tfa.flash_attention(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert tfa.flash_attention(qg, k, v).grad_fn is None
    out, lse = tfa.flash_attention(qg, k, v, return_lse=True)
    assert out.grad_fn is not None and not lse.requires_grad
    torch.testing.assert_close(lse, tfa.flash_attention(q, k, v, return_lse=True)[1], atol=0, rtol=0)


def test_all_neg_inf_row_gets_zero_gradients():
    q, k, v, g = (t(a) for a in _inputs(2, 2, 16, 24, 16, seed=4))
    bias = torch.zeros(2, 24)
    bias[1] = -float("inf")
    out, lse = tfa.flash_attention(q, k, v, bias, return_lse=True)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, bias, out, g, lse)
    for x in (dq, dk, dv):
        assert torch.isfinite(x).all() and torch.all(x[1] == 0)
    ref = tfa.flash_attention_bwd(q[:1], k[:1], v[:1], None, out[:1], g[:1], lse[:1])
    for a, r in zip((dq, dk, dv), ref):
        torch.testing.assert_close(a[:1], r, atol=0, rtol=0)


def test_bwd_reference_rounds_where_the_kernels_round():
    """bf16 inputs: dS is rounded to bf16 before dS·K and dSᵀ·Q, and P
    before Pᵀ·dO (flash_attention.py:420-423, :456-468 of the JAX package)."""
    q, k, v, g = (t(a).to(torch.bfloat16) for a in _inputs(1, 2, 32, 48, 16, seed=6))
    out, lse = tfa.flash_attention(q, k, v, return_lse=True)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, None, out, g, lse)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / 4.0
    p = torch.exp(s - lse[..., None])
    di = (out.float() * g.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(g.float(), v.float().transpose(-1, -2)) - di) / 4.0
    bf = torch.bfloat16
    expect = (
        torch.matmul(ds.to(bf).float(), k.float()).to(bf),
        torch.matmul(ds.to(bf).float().transpose(-1, -2), q.float()).to(bf),
        torch.matmul(p.to(bf).float().transpose(-1, -2), g.float()).to(bf),
    )
    for a, r in zip((dq, dk, dv), expect):
        assert a.dtype == bf
        torch.testing.assert_close(a, r, atol=0, rtol=0)


def test_grad_parity_limit_rejects_planted_faults():
    """``grad_parity_atol``, the limit the card-side check holds the bf16
    backward kernels to, lies below what each planted fault does at a
    4096-token, d=40 site (one query tile, two heads): di left out, one
    64-key tile skipped in dQ, one 64-query tile skipped in dK/dV."""
    q, k, v, g = (t(a).to(torch.bfloat16) for a in _inputs(1, 2, 64, 4096, 40, seed=8))
    out, lse = tfa.flash_attention(q, k, v, return_lse=True)
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, None, out, g, lse)
    tols = [tfa.grad_parity_atol(x) for x in (dq, dk, dv)]
    assert tols[0] == 2.0 ** -6 * dq.float().abs().max().item()
    assert tfa.grad_parity_atol(dq.float()) == 2.0 ** -14 * dq.float().abs().max().item()

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    # di left out (an all-zero O makes rowsum(O * dO) vanish): dQ reads it
    no_di = tfa.flash_attention_bwd(q, k, v, None, torch.zeros_like(out), g, lse)
    assert err(no_di[0], dq) > 4 * tols[0]
    # one key tile skipped in dQ: a -inf bias drops its keys from P
    bias = torch.zeros(1, 4096)
    bias[:, -64:] = -float("inf")
    skipped = tfa.flash_attention_bwd(q, k, v, bias, out, g, lse)
    assert err(skipped[0], dq) > 4 * tols[0]
    # one query tile skipped in dK/dV, at a 128-query site: its lse -inf
    q2, k2, v2, g2 = (t(a).to(torch.bfloat16) for a in _inputs(1, 2, 128, 1024, 80, seed=9))
    out2, lse2 = tfa.flash_attention(q2, k2, v2, return_lse=True)
    _, dk2, dv2 = tfa.flash_attention_bwd(q2, k2, v2, None, out2, g2, lse2)
    lse_skip = lse2.clone()
    lse_skip[:, :, 64:] = -float("inf")
    _, dk_s, dv_s = tfa.flash_attention_bwd(q2, k2, v2, None, out2, g2, lse_skip)
    assert err(dk_s, dk2) > 4 * tfa.grad_parity_atol(dk2) and err(dv_s, dv2) > 4 * tfa.grad_parity_atol(dv2)


def test_bwd_wrapper_counts_only_kernel_launches():
    q, k, v, g = (t(a) for a in _inputs(1, 1, 8, 8, 16, seed=0))
    out, lse = tfa.flash_attention(q, k, v, return_lse=True)
    before = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches, tfa.flash_attention_bwd.copies)
    tfa.flash_attention_bwd(q, k, v, None, out, g, lse)  # CPU tensors: the plain version
    assert (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches, tfa.flash_attention_bwd.copies) == before
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd(q, k, v, None, out, g, lse[..., :4])
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_bwd(*(x.to("meta") for x in (q, k, v)), None, out.to("meta"), g.to("meta"),
                                lse.to("meta"))


# ---------------------------------------------------------------------------
# through the UNet: null-text inversion

STEPS, INNER, GS = 4, 3, 7.5
PROMPT = "a cat sitting on the grass"
IMAGE = (np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)
ATOL_EMB = 1e-3  # see tests/test_torch_nti.py


@pytest.fixture(scope="module")
def nti_case():
    """Shared tiny pipelines, the JAX DDIM inversion of IMAGE (trajectory and
    context as numpy) and the JAX resetting NTI of it."""
    jpipe, tpipe = shared_pipelines(num_steps=STEPS)
    _, traj, _ = jcli.invert(jpipe, IMAGE, PROMPT, "ddim", "p2p", use_flash=False)
    ctx, _ = jpipe.encode_prompts([PROMPT])
    traj, ctx = np.asarray(traj), np.asarray(ctx)
    cfg = JNTIConfig(num_inner_steps=INNER)
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    reset = jnti._nti_scan(
        jpipe.unet, jpipe.unet_params, jpipe.scheduler, jnp.asarray(traj), jnp.asarray(ctx[1:]),
        jnp.asarray(ctx[:1]), f32(GS), f32(cfg.base_lr), f32(cfg.lr_decay_span), f32(cfg.epsilon),
        None, None, INNER, True, False,
    )
    return jpipe, tpipe, traj, ctx, np.asarray(reset)


def test_nti_loss_and_grad_match_jax(nti_case):
    """Step 0's loss and its gradient in the embedding, through the UNet:
    the port's ``nti_loss`` under autograd (the flash Function's backward at
    every self-attention site that depends on the embedding) against
    ``jax.value_and_grad`` of JAX ``loss_fn`` (nti.py:86-90)."""
    import jax

    jpipe, tpipe, traj, ctx, _ = nti_case
    sched = jpipe.scheduler
    lat, target, t0 = jnp.asarray(traj[-1]), jnp.asarray(traj[STEPS - 1]), sched.timesteps[0]
    eps_c, _ = jpipe.unet_apply(lat, t0, jnp.asarray(ctx[1:]), use_flash=False)

    def loss_fn(u):
        eps_u, _ = jpipe.unet_apply(lat, t0, u, use_flash=False)
        prev = j_ddim_step(sched, eps_u + jnp.float32(GS) * (eps_c - eps_u), 0, lat)
        return jnp.mean((prev - target) ** 2)

    j_loss, j_grad = jax.jit(jax.value_and_grad(loss_fn))(jnp.asarray(ctx[:1]))

    with torch.no_grad():
        t_eps_c = tpipe.unet(t(traj[-1]), int(tpipe.scheduler.timesteps[0]), t(ctx[1:]))[0]
    np.testing.assert_allclose(n(t_eps_c), n(eps_c), atol=1e-5, rtol=0)
    u = t(ctx[:1]).requires_grad_(True)
    loss = tnti.nti_loss(tpipe.unet, tpipe.scheduler, 0, t(traj[-1]), t(traj[STEPS - 1]), t_eps_c, u, GS)
    (g,) = torch.autograd.grad(loss, u)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    scale = float(jnp.abs(j_grad).max())
    assert scale > 0
    np.testing.assert_allclose(n(g), n(j_grad), atol=1e-5 * scale, rtol=0)
    assert np.array_equal(np.sign(n(g)), np.sign(n(j_grad)))




def test_nti_loop_reset_each_step_matches_jax(nti_case, monkeypatch):
    """With ``reset_each_step`` (SDXL's variant) every step starts again from
    the original embedding, where the SD variant carries the optimised one
    on; against JAX ``_nti_scan(reset_each_step=True)``."""
    _, tpipe, traj, ctx, jax_reset = nti_case
    grads = recorded_grads(monkeypatch)
    seq = tnti._nti_loop(tpipe.unet, tpipe.scheduler, t(traj), t(ctx[1:]), t(ctx[:1]), GS,
                         TNTIConfig(num_inner_steps=INNER), reset_each_step=True)
    monkeypatch.undo()
    check_grad_margin(grads, STEPS * INNER)
    np.testing.assert_allclose(n(seq), jax_reset, atol=ATOL_EMB, rtol=0)
    carried = tnti._nti_loop(tpipe.unet, tpipe.scheduler, t(traj), t(ctx[1:]), t(ctx[:1]), GS,
                             TNTIConfig(num_inner_steps=INNER), reset_each_step=False)
    torch.testing.assert_close(seq[0], carried[0], atol=0, rtol=0)  # step 0 starts from the same point
    assert not torch.allclose(seq[1:], carried[1:], atol=10 * ATOL_EMB)

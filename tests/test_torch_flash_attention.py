"""The port's flash-attention forward against the JAX package's.

On the CPU the port's ``flash_attention`` is its plain version; the JAX
side runs the Pallas kernels in interpret mode, both the classic kernel
(d = 80, or any bias) and the transposed one (d <= 64 without bias).
Tolerance: atol 1e-5 in f32 (sums taken in another order).

Masking semantics the two share: keys past Nk do not exist for the softmax;
NEG_INF is a finite logit, so a row masked by it everywhere averages V with
equal weights. The JAX kernel pads Nk to its key block and gives such a row
equal weights over the padded keys too, a TPU padding artefact; the
fully-masked case is therefore checked at an Nk the JAX kernel does not pad
(77 keys, one block). A row whose every logit is -inf returns 0 in the port
(the ``l == 0`` guard); the JAX kernel gives NaN there, so that case is held
against the definition only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch.ops import flash_attention as tfa
from image_editing_framework_tpu.ops import flash_attention as jfa
from torch_port_helpers import n, t

ATOL = 1e-5


def _qkv(b, h, nq, nk, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, m, d).astype(np.float32) for m in (nq, nk, nk))


def _bias(b, nk, seed, full_row=False):
    rng = np.random.RandomState(seed)
    bias = np.where(rng.rand(b, nk) < 0.4, jfa.NEG_INF, 0.0).astype(np.float32)
    bias[:, : nk // 4] = jfa.NEG_INF  # a masked segment
    bias[:, nk // 4] = 0.0  # keep one live key per row
    if full_row:
        bias[0] = jfa.NEG_INF
    return bias


@pytest.mark.parametrize(
    "b,h,nq,nk,d,blocks",
    [
        (2, 2, 128, 128, 16, None),  # transposed-layout JAX kernel
        (1, 2, 128, 128, 40, None),  # SD1.5 64² head dim (transposed layout)
        (2, 2, 64, 64, 80, None),  # SD1.5 32² head dim (classic layout)
        (2, 2, 128, 200, 40, (128, 128)),  # Nk padded to the key block in JAX
    ],
)
def test_flash_matches_jax(b, h, nq, nk, d, blocks):
    q, k, v = _qkv(b, h, nq, nk, d, seed=d + nk)
    kw = dict(block_q=blocks[0], block_k=blocks[1]) if blocks else {}
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    out = tfa.flash_attention(t(q), t(k), t(v))
    np.testing.assert_allclose(n(out), n(ref), atol=ATOL, rtol=0)
    ref_o, ref_lse = jfa.flash_attention_fwd_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    out_o, out_lse = tfa.flash_attention(t(q), t(k), t(v), return_lse=True)
    np.testing.assert_allclose(n(out_o), n(ref_o), atol=ATOL, rtol=0)
    np.testing.assert_allclose(n(out_lse), n(ref_lse), atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "nk,d,blocks,full_row",
    [
        (200, 16, (128, 128), False),  # NEG_INF segments + padded Nk
        (200, 80, (128, 128), False),
        (77, 40, None, True),  # a fully NEG_INF-masked row, unpadded Nk
    ],
)
def test_flash_bias_matches_jax(nk, d, blocks, full_row):
    b, h, nq = 2, 2, 128
    q, k, v = _qkv(b, h, nq, nk, d, seed=7 + d)
    bias = _bias(b, nk, seed=d, full_row=full_row)
    kw = dict(block_q=blocks[0], block_k=blocks[1]) if blocks else {}
    jq, jk, jv, jb = (jnp.asarray(a) for a in (q, k, v, bias))
    ref = jfa.flash_attention(jq, jk, jv, jb, **kw)
    ref_o, ref_lse = jfa.flash_attention_fwd_lse(jq, jk, jv, jb, **kw)
    out_o, out_lse = tfa.flash_attention(t(q), t(k), t(v), t(bias), return_lse=True)
    np.testing.assert_allclose(n(out_o), n(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(n(out_o), n(ref_o), atol=ATOL, rtol=0)
    np.testing.assert_allclose(n(out_lse), n(ref_lse), atol=ATOL, rtol=0)
    if full_row:  # equal weights over the 77 keys
        expect = np.broadcast_to(v[0].mean(axis=1, keepdims=True), (h, nq, d))
        np.testing.assert_allclose(n(out_o)[0], expect, atol=ATOL, rtol=0)


def test_flash_all_neg_inf_row_returns_zero():
    q, k, v = _qkv(2, 2, 16, 24, 16, seed=3)
    bias = np.zeros((2, 24), np.float32)
    bias[1] = -np.inf
    out, lse = tfa.flash_attention(t(q), t(k), t(v), t(bias), return_lse=True)
    assert torch.all(out[1] == 0) and torch.all(torch.isneginf(lse[1]))
    ref = tfa.flash_attention(t(q[:1]), t(k[:1]), t(v[:1]))
    torch.testing.assert_close(out[:1], ref, atol=ATOL, rtol=0)


def test_flash_rounds_p_to_v_dtype():
    """bf16 inputs: P is rounded to bf16 before P·V (flash_attention.py:118-121
    of the JAX package), so the result equals the explicit computation with
    that rounding."""
    q, k, v = (t(a).to(torch.bfloat16) for a in _qkv(1, 2, 32, 48, 16, seed=5))
    out = tfa.flash_attention(q, k, v)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / 4.0
    p = torch.exp(s - s.amax(-1, keepdim=True))
    expect = (torch.matmul(p.to(torch.bfloat16).float(), v.float()) / p.sum(-1, keepdim=True)).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, expect, atol=0, rtol=0)


def test_bf16_parity_limit_rejects_a_skipped_key_tile():
    """``parity_atol``, the limit the card-side check holds the bf16 kernel
    to, lies below what one skipped 64-key tile does to the output at a
    4096-token, d=40 site (one query tile of it, two heads)."""
    q, k, v = (t(a).to(torch.bfloat16) for a in _qkv(1, 2, 64, 4096, 40, seed=6))
    ref = tfa.flash_attention(q, k, v)
    bias = torch.zeros(1, 4096)
    bias[:, -64:] = float("-inf")
    skipped = tfa.flash_attention(q, k, v, bias)
    tol = tfa.parity_atol(ref)
    assert tol == 2.0 ** -6 * ref.float().abs().max().item()
    assert (skipped.float() - ref.float()).abs().max().item() > 4 * tol
    assert tfa.parity_atol(ref.float()) == 1e-4


def test_flash_wrapper_counts_only_kernel_launches():
    q, k, v = (t(a) for a in _qkv(1, 1, 8, 8, 16, seed=0))
    before = tfa.flash_attention.launches
    tfa.flash_attention(q, k, v)  # CPU tensors: the plain version, no launch
    assert tfa.flash_attention.launches == before
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k[..., :8], v)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(*(x.to("meta") for x in (q, k, v)))

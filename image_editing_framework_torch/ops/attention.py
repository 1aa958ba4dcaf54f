"""Attention dispatch: fused self-attention + editable cross-attention.

Counterpart of ``image_editing_framework_tpu/ops/attention.py``:

* **Self-attention** never materialises probabilities. Every method's
  self-attention edit is a per-batch-element index remap of Q / K / V
  described by a ``SelfAttnPlan`` from the active control; the gathers feed
  the flash kernel (``ops/flash_attention.py``). Multi-segment K/V (MasaCtrl
  "union") concatenates gathered segments with an additive per-key bias
  masking invalid segments.

* **Cross-attention** (K = 77 text tokens) materialises f32 probabilities
  explicitly, because P2P edits them. It is plain tensor code, not a kernel.

* **Context parallelism** (``cp_mesh``): self-attention with its sequence
  split over the ranks of a mesh axis (``parallel/ring_attention.py``), the
  plan's gathers and biases first, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from image_editing_framework_torch.ops.flash_attention import NEG_INF, flash_attention
from image_editing_framework_torch.parallel.ring_attention import context_parallel_attention
from image_editing_framework_torch.utils import profiling

# The longest self-attention site of SD1.5 (64² latents) and SDXL (its first
# attention level at 64²); SD2.1 at 768² attends over 9216 tokens.
LONG_SEQ = 4096


@dataclasses.dataclass(frozen=True)
class AttnSite:
    """Static identity of one attention layer inside the UNet.

    ``layer`` is the transformer-block index in forward execution order
    (down -> mid -> up): 0..15 for SD.
    """

    layer: int
    place: str  # 'down' | 'mid' | 'up'
    seq_len: int
    is_cross: bool

    @property
    def key(self) -> str:
        return f"{self.place}_l{self.layer}_{'cross' if self.is_cross else 'self'}"


@dataclasses.dataclass(frozen=True)
class SelfAttnPlan:
    """Batch-index remap plan for one self-attention site.

    q_idx:  (B,)   source batch element for each element's queries.
    k_idx:  (B,S)  source batch elements for S concatenated K segments.
    v_idx:  (B,S)  same for V.
    valid:  (B,S)  False segments are masked out of the softmax.
    """

    q_idx: torch.Tensor
    k_idx: torch.Tensor
    v_idx: torch.Tensor
    valid: torch.Tensor


def identity_plan(batch: int, device=None) -> SelfAttnPlan:
    iota = torch.arange(batch, dtype=torch.int64, device=device)
    ones = torch.ones((batch, 1), dtype=torch.bool, device=device)
    return SelfAttnPlan(iota, iota[:, None], iota[:, None], ones)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, H*D) -> (B, H, N, D), a view (the kernel takes its strides)."""
    b, n, c = x.shape
    return x.view(b, n, num_heads, c // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def plan_operands(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    plan: Optional[SelfAttnPlan],
    bias: Optional[torch.Tensor] = None,
):
    """The (q, k, v, bias) that ``self_attention`` hands the flash kernel:
    the plan's gathers, S segments of K/V concatenated along the keys, and
    the segment bias (0 or NEG_INF per key, materialised (B, S·N) f32) added
    to ``bias``."""
    if plan is None:
        return q, k, v, bias
    b, h, n, d = q.shape
    q = q[plan.q_idx]
    s = plan.k_idx.shape[1]
    k = k[plan.k_idx.reshape(-1)].reshape(b, s, h, n, d)
    k = k.transpose(1, 2).reshape(b, h, s * n, d)
    v = v[plan.v_idx.reshape(-1)].reshape(b, s, h, n, d)
    v = v.transpose(1, 2).reshape(b, h, s * n, d)
    if s > 1:
        seg = torch.where(plan.valid, 0.0, NEG_INF).to(torch.float32)  # (B, S)
        seg = seg[:, :, None].expand(b, s, n).reshape(b, s * n)  # (B, S*N), materialised
        bias = seg if bias is None else bias + seg
    return q, k, v, bias


def self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    plan: Optional[SelfAttnPlan],
    bias: Optional[torch.Tensor] = None,
    cp_mesh=None,
    cp_axis="data",
    cp_mode: str = "ring",
) -> torch.Tensor:
    """Fused self-attention with optional batch-index remapping.

    q/k/v: (B, H, N, D). plan=None means no edit (skips the gathers).
    ``bias`` is an explicit per-key additive logit bias (B, Nk), added to any
    plan-segment bias (it addresses the post-gather key layout).

    ``cp_mesh`` (a ``DeviceMesh``) switches to context-parallel attention
    with the sequence split over ``cp_axis``: ``cp_mode`` 'ring' (K/V
    rotation), 'ulysses' (all-to-all head <-> sequence) or 'ulysses_ring'
    (both; ``cp_axis`` a (head_axis, seq_axis) pair, ("tensor", "data")
    unless given). q, k, v stay replicated here: the plan's gathers run
    first, then each rank takes its chunk of the gathered q, k, v and bias
    (``parallel/ring_attention.py context_parallel_attention``), and the
    output is all-gathered.

    A call whose query is longer than ``LONG_SEQ`` tokens counts
    ``attn_long_calls`` in the program's tracer (``utils/profiling.py``).
    """
    if q.shape[2] > LONG_SEQ:
        profiling.count("attn_long_calls")
    q, k, v, bias = plan_operands(q, k, v, plan, bias)
    if cp_mesh is None:
        return flash_attention(q, k, v, bias)
    return context_parallel_attention(q, k, v, bias, cp_mesh, cp_axis, cp_mode)


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    cp_mesh=None,
    cp_axis="data",
    cp_mode: str = "ring",
) -> torch.Tensor:
    """Attention with a per-key additive logit bias (B, Nk), contiguous f32
    — the masked MasaCtrl primitives (masactrl/model/attention_control.py:
    142-151). ``cp_mesh`` runs it context-parallel (the bias is split, and
    rotates or is gathered, with K)."""
    return self_attention(q, k, v, None, bias=bias, cp_mesh=cp_mesh, cp_axis=cp_axis, cp_mode=cp_mode)


def cross_attention_probs(q: torch.Tensor, k: torch.Tensor, sm_scale: Optional[float] = None) -> torch.Tensor:
    """Explicit f32 cross-attention probabilities (B, H, N, 77)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)).float() * sm_scale
    return torch.softmax(s, dim=-1)


def apply_probs(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.matmul(probs.to(v.dtype), v)

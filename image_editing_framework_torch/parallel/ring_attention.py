"""Context parallelism: ring, Ulysses and 2D attention over latent tokens.

Counterpart of ``image_editing_framework_tpu/parallel/ring_attention.py``.
The sequence of one self-attention site is split over the ranks of a mesh
axis; each rank holds N/n tokens of Q, K and V.

* **Ring** (``ring_self_attention``): the flash kernel runs each rank's
  queries against the K/V block it holds (``flash_attention(...,
  return_lse=True)``: ``csrc/flash_fwd.cu`` on the card, its plain version on
  the CPU), then K, V and the per-key bias rotate to the next rank, n - 1
  times, and the partial results merge by the two-estimate log-sum-exp
  combine. ``RingAttention`` is its exact backward: the K/V blocks rotate
  again, each block's (dk, dv) accumulator rides along with it and one final
  rotation sends it home; every block's gradient takes the *global* lse
  (``flash_attention_bwd``: ``csrc/flash_bwd.cu``), so the sum is the
  full-sequence gradient. The bias gets no gradient.
* **Ulysses** (``ulysses_self_attention``): an all-to-all makes each rank
  hold all tokens of H/n heads, the flash kernel runs locally, and the
  inverse all-to-all restores the sequence split. The bias is all-gathered.
* **2D** (``ulysses_ring_attention``): Ulysses over the head axis around a
  ring over the sequence axis.

The JAX package's ``use_flash`` switch has no counterpart: the same code
runs the kernels on CUDA tensors and their plain versions on CPU tensors.

**The per-rank contract.** ``torch.distributed`` has no global array, so the
functions above take *this rank's shards* where JAX's ``shard_map`` takes
global arrays and its ``in_specs``: q, k, v (B, H, N/n, D), the bias (B,
Nk/n) f32 or None, and they return this rank's (B, H, N/n, D) output shard.
Rank i of the axis's group holds sequence chunk i. In the 2D mode the rank
with head-axis index t and sequence-axis index d holds chunk ``t * sp + d``
(JAX's ``P(None, None, (head_axis, seq_axis), None)``: head axis major); the
head-axis all-to-all then gathers chunks in strided order, and the bias is
gathered in the same order. ``context_parallel_attention`` is the boundary
to replicated activations (the UNet's): each rank takes its chunk of the
full q, k, v and bias, runs one of the three, and all-gathers the output;
in the backward pass each rank's exact shard gradients are all-gathered.

Partial results merge as
    m = max(lse1, lse2); w_i = exp(lse_i - m)
    out = o1 w1/(w1+w2) + o2 w2/(w1+w2);  lse = m + log(w1 + w2)
with the weights cast to the output's dtype before the products, as JAX
rounds. Where both estimates are -inf (a row none of whose keys so far is
live: the kernel returns 0 and lse -inf for it) the merge gives (0, -inf),
where JAX's gives NaN.

**Collectives.** Every one goes through ``_rotate`` (``batch_isend_irecv``),
``_all_to_all`` (``all_to_all_single``), ``_all_gather``
(``all_gather_into_tensor``) or ``_broadcast_first`` (``broadcast``, for
``lockstep``). On a gloo group (a host transport) a CUDA
tensor is copied through host memory and back; on NCCL it is not. The
backend is the caller's (``parallel/mesh.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from image_editing_framework_torch.ops.flash_attention import flash_attention, flash_attention_bwd
from image_editing_framework_torch.parallel.mesh import axis as _axis

Axis = Union[str, Tuple[str, str]]


# ---------------------------------------------------------------------------
# collectives


def _host_staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _send_form(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor the transport takes: contiguous, in host memory on gloo."""
    return (x.cpu() if x.is_cuda and _host_staged(group) else x).contiguous()


def _rotate(tensors: Sequence[torch.Tensor], group) -> list:
    """Send each tensor to the next rank of ``group`` and receive the
    previous rank's (JAX's ``ppermute`` with ``(i, i + 1) % n``)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:  # a ring of one: the tensors stay
        return list(tensors)
    dst, src = dist.get_global_rank(group, (r + 1) % n), dist.get_global_rank(group, (r - 1) % n)
    sends = [_send_form(t, group) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = []
    for tag, (s, rv) in enumerate(zip(sends, recvs)):
        ops += [dist.P2POp(dist.isend, s, dst, group, tag), dist.P2POp(dist.irecv, rv, src, group, tag)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [rv.to(t.device) for rv, t in zip(recvs, tensors)]


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x: (n, ...); block j goes to rank j, and block j of the result came
    from rank j."""
    s = _send_form(x, group)
    out = torch.empty_like(s)
    dist.all_to_all_single(out, s, group=group)
    return out.to(x.device)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's x, in rank order."""
    s = _send_form(x, group)
    out = torch.empty((dist.get_world_size(group) * s.numel(),), dtype=s.dtype, device=s.device)
    dist.all_gather_into_tensor(out, s.reshape(-1), group=group)
    return out.view(-1, *x.shape).to(x.device)


def _broadcast_first(x: torch.Tensor, group) -> torch.Tensor:
    """x as the group's first rank holds it."""
    s = _send_form(x, group).clone()
    dist.broadcast(s, src=dist.get_global_rank(group, 0), group=group)
    return s.to(x.device)


def lockstep(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as the mesh's first rank holds it, on every rank (``mesh`` None:
    ``x``). A branch taken on a value read from the device, such as
    null-text inversion's early stop, is decided on it, so that every rank
    takes the same branch before the next collective even where replicated
    work differs by a rounding between processes."""
    if mesh is None:
        return x
    for name in mesh.mesh_dim_names:
        x = _broadcast_first(x, mesh.get_group(name))
    return x


def _gather_chunks(x: torch.Tensor, groups: Sequence, dim: int) -> torch.Tensor:
    """Concatenate every rank's chunk along ``dim``; ``groups`` minor axis
    first, so the chunks come out in ``index`` order (``_chunk``)."""
    for group in groups:
        x = torch.cat(_all_gather(x, group).unbind(0), dim=dim)
    return x


class _AllToAll(torch.autograd.Function):
    """``_all_to_all`` with its gradient: the same exchange of the
    cotangent's blocks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _ToShard(torch.autograd.Function):
    """Replicated -> this rank's chunk along ``dim`` (contiguous, so that the
    kernels and the transport take it as it is). Backward: every rank holds
    the exact gradient of its own chunk, so the replicated gradient is their
    all-gather."""

    @staticmethod
    def forward(ctx, x, groups, index, count, dim):
        ctx.groups, ctx.dim = groups, dim
        size = x.shape[dim] // count
        return x.narrow(dim, index * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_chunks(g, ctx.groups, ctx.dim), None, None, None, None


class _FromShards(torch.autograd.Function):
    """Every rank's chunk along ``dim`` -> the replicated whole. Backward:
    the cotangent is replicated (every rank computes the same loss), so
    this rank's share of it is its own chunk."""

    @staticmethod
    def forward(ctx, x, groups, index, dim):
        ctx.index, ctx.dim, ctx.size = index, dim, x.shape[dim]
        return _gather_chunks(x, groups, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size).contiguous(), None, None, None


# ---------------------------------------------------------------------------
# ring


def _merge(o1, lse1, o2, lse2):
    """Two-estimate log-sum-exp combine of (out, lse) pairs; (0, -inf) where
    both lse are -inf."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    w1 = torch.exp(lse1 - m_safe)
    w2 = torch.exp(lse2 - m_safe)
    den = w1 + w2
    live = den > 0
    den_safe = torch.where(live, den, torch.ones_like(den))
    r1 = torch.where(live, w1 / den_safe, torch.zeros_like(den))
    r2 = torch.where(live, w2 / den_safe, torch.zeros_like(den))
    o = o1 * r1[..., None].to(o1.dtype) + o2 * r2[..., None].to(o2.dtype)
    return o, m + torch.log(den)


def _rotate_blocks(k, v, bias, group, *acc):
    """K, V, the bias (where there is one) and the accumulators ``acc``,
    each rotated one rank on: (k, v, bias, *acc)."""
    got = _rotate([k, v] + ([] if bias is None else [bias]) + list(acc), group)
    if bias is not None:
        bias = got.pop(2)
    return (got[0], got[1], bias, *got[2:])


def _ring_forward(q, k, v, bias, group, sm_scale):
    """The forward rotation loop: local block attention, K/V (+bias)
    rotation, log-sum-exp merge. Returns (out, lse)."""
    out, lse = flash_attention(q, k, v, bias, sm_scale, return_lse=True)
    for _ in range(dist.get_world_size(group) - 1):
        k, v, bias = _rotate_blocks(k, v, bias, group)
        o_i, lse_i = flash_attention(q, k, v, bias, sm_scale, return_lse=True)
        out, lse = _merge(out, lse, o_i, lse_i)
    return out, lse


class RingAttention(torch.autograd.Function):
    """This rank's ring attention output, with the exact ring backward
    (JAX ``_make_ring_kernel_local``: ``ring_fwd`` / ``ring_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, group, sm_scale):
        out, lse = _ring_forward(q, k, v, bias, group, sm_scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.group, ctx.sm_scale = group, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse = ctx.saved_tensors
        group, sm_scale = ctx.group, ctx.sm_scale
        # Own block first; the (dk, dv) accumulators then rotate with their
        # K/V block, and one extra rotation returns each to its owner.
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, out, g, lse, sm_scale)
        kb, vb, bb = k, v, bias
        for _ in range(dist.get_world_size(group) - 1):
            kb, vb, bb, dk, dv = _rotate_blocks(kb, vb, bb, group, dk, dv)
            dq_i, dk_i, dv_i = flash_attention_bwd(q, kb, vb, bb, out, g, lse, sm_scale)
            dq, dk, dv = dq + dq_i, dk + dk_i, dv + dv_i
        dk, dv = _rotate([dk, dv], group)
        return dq, dk, dv, None, None, None


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def ring_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis_name: str = "data",
    sm_scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention with the sequence split over ``axis_name`` of
    ``mesh`` (a ``DeviceMesh``). This rank's shards: q (B, H, Nq/n, D),
    k/v (B, H, Nk/n, D) (Nk may differ from Nq: MasaCtrl-union concatenates
    segments), ``bias`` (B, Nk/n) per-key logit bias, rotating with K.
    Returns this rank's (B, H, Nq/n, D) output, differentiable in q, k, v."""
    group, _, _ = _axis(mesh, axis_name)
    return RingAttention.apply(q, k, v, bias, group, _scale(q, sm_scale))


# ---------------------------------------------------------------------------
# Ulysses


def _seq_to_head(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(B, H, N/n, D) -> (B, H/n, N, D): head block j goes to rank j, the
    received sequence chunks concatenate in rank order."""
    b, h, nl, d = x.shape
    y = _AllToAll.apply(x.reshape(b, n, h // n, nl, d).transpose(0, 1), group)
    return y.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * nl, d)


def _head_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """(B, H/n, N, D) -> (B, H, N/n, D), the inverse of ``_seq_to_head``."""
    b, hl, nn, d = x.shape
    y = _AllToAll.apply(x.reshape(b, hl, n, nn // n, d).permute(2, 0, 1, 3, 4), group)
    return y.transpose(0, 1).reshape(b, n * hl, nn // n, d)


def _gather_bias(bias: Optional[torch.Tensor], group) -> Optional[torch.Tensor]:
    """(B, Nk/n) -> (B, Nk) in rank order, contiguous f32."""
    if bias is None:
        return None
    with torch.no_grad():
        return _gather_chunks(bias, [group], dim=1)


def ulysses_self_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis_name: str = "data",
    sm_scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """All-to-all head <-> sequence reshard around a local flash attention.
    The same per-rank shards as ``ring_self_attention``; needs H % n == 0.
    Differentiable: the all-to-all's gradient is the inverse exchange, the
    kernel has its own."""
    group, _, n = _axis(mesh, axis_name)
    if q.shape[1] % n:
        raise AssertionError("Ulysses needs heads % devices == 0")
    qh, kh, vh = (_seq_to_head(t, group, n) for t in (q, k, v))
    out = flash_attention(qh, kh, vh, _gather_bias(bias, group), _scale(q, sm_scale))
    return _head_to_seq(out, group, n)


def ulysses_ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    head_axis: str = "tensor",
    seq_axis: str = "data",
    sm_scale: Optional[float] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """2D context parallelism: Ulysses over ``head_axis`` x ring over
    ``seq_axis``. This rank (head index t, sequence index d) holds sequence
    chunk ``t * sp + d`` of all heads; the head-axis all-to-all makes it hold
    H/hp heads of the chunks ``t' * sp + d`` (strided order, harmless: the
    softmax does not care about the keys' order as long as the bias is
    gathered in the same order), the ring covers the sequence axis, and the
    inverse all-to-all restores the layout."""
    hgroup, _, hp = _axis(mesh, head_axis)
    sgroup, _, _ = _axis(mesh, seq_axis)
    if q.shape[1] % hp:
        raise AssertionError("needs heads % head-axis size == 0")
    qh, kh, vh = (_seq_to_head(t, hgroup, hp) for t in (q, k, v))
    out = RingAttention.apply(qh, kh, vh, _gather_bias(bias, hgroup), sgroup, _scale(q, sm_scale))
    return _head_to_seq(out, hgroup, hp)


# ---------------------------------------------------------------------------
# the boundary to replicated activations

CP_MODES = ("ring", "ulysses", "ulysses_ring")


def _chunk(mesh, mode: str, axis: Axis):
    """(this rank's sequence chunk index, the chunk count, the groups to
    gather chunks over, minor axis first)."""
    if mode == "ulysses_ring":
        head_axis, seq_axis = axis if isinstance(axis, (tuple, list)) else ("tensor", "data")
        hgroup, t, hp = _axis(mesh, head_axis)
        sgroup, d, sp = _axis(mesh, seq_axis)
        return t * sp + d, hp * sp, [sgroup, hgroup], (head_axis, seq_axis)
    group, r, n = _axis(mesh, axis)
    return r, n, [group], axis


def context_parallel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    mesh,
    axis: Axis = "data",
    mode: str = "ring",
) -> torch.Tensor:
    """Attention of replicated (B, H, N, D) q, k, v (and (B, Nk) bias) with
    the sequence split over the mesh: each rank takes its chunk, runs
    ``mode`` ('ring', 'ulysses' or 'ulysses_ring'; the last over
    ``axis`` = (head_axis, seq_axis), ("tensor", "data") unless given), and
    the output chunks are all-gathered. Differentiable in q, k, v."""
    if mode not in CP_MODES:
        raise ValueError(f"cp_mode must be one of {CP_MODES}, got {mode!r}")
    index, count, groups, axis = _chunk(mesh, mode, axis)
    for name, t in (("q", q), ("k", k)):
        if t.shape[2] % count:
            raise ValueError(f"{name}'s sequence {t.shape[2]} does not split into {count} chunks")
    qs, ks, vs = (_ToShard.apply(t, groups, index, count, 2) for t in (q, k, v))
    bs = None
    if bias is not None:
        size = bias.shape[1] // count
        bs = bias.detach().narrow(1, index * size, size).float().contiguous()
    if mode == "ulysses_ring":
        out = ulysses_ring_attention(qs, ks, vs, mesh, *axis, bias=bs)
    else:
        fn = ulysses_self_attention if mode == "ulysses" else ring_self_attention
        out = fn(qs, ks, vs, mesh, axis, bias=bs)
    return _FromShards.apply(out, groups, index, 2)

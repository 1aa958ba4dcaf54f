"""Flash attention: the hand-written CUDA kernels and their plain versions.

Counterpart of ``image_editing_framework_tpu/ops/flash_attention.py``:
``flash_attention:828`` with its custom VJP (``_flash_fwd:777`` /
``_flash_bwd:801``), ``flash_attention_fwd_lse:872`` (``return_lse=True``)
and ``flash_attention_bwd_block:910`` (``flash_attention_bwd``). The TPU's
forward kernels (``_fwd_kernel``, ``_fwd_kernel_t``) are one kernel on the
card, ``csrc/flash_fwd.cu``; its backward kernels (``_bwd_dq_kernel`` /
``_bwd_dq_kernel_t`` and ``_bwd_dkv_kernel`` / ``_bwd_dkv_kernel_t``) are the
two kernels of ``csrc/flash_bwd.cu``.

Every wrapper dispatches on where its inputs lie:

* CUDA tensors launch the kernel, or the call raises. There is no fallback.
* CPU tensors take the plain PyTorch version (``flash_attention_reference``,
  ``flash_attention_bwd_reference``), which the CPU tests hold against JAX
  and the card-side check holds the kernel against.

``flash_attention`` on inputs that require grad (with grad enabled) runs
through ``FlashAttention``, a ``torch.autograd.Function`` whose forward keeps
the lse and whose backward is ``flash_attention_bwd``. Otherwise it makes the
lse-free call, so an inference pass launches the forward kernel alone.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

_KERNEL = "flash_fwd"
_BWD_KERNEL = "flash_bwd"
_DTYPES = (torch.bfloat16, torch.float32)

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
) -> Result:
    """Plain PyTorch version of the kernel, explicit f32 scores.

    ``softmax(q k^T * sm_scale + bias) v`` with the kernel's rules: the
    unnormalised probabilities are rounded to v's dtype before ``P·V``; a
    row whose every logit is -inf returns 0; ``lse = m + log(l)`` in f32.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    o = torch.where(l == 0, torch.zeros_like(o), o / l).to(q.dtype)
    if not return_lse:
        return o
    lse = (m + torch.log(torch.clamp(l, min=1e-37)))[..., 0]
    return o, lse


def parity_atol(ref: torch.Tensor) -> float:
    """Largest abs error the kernel may show against ``ref``, its plain
    version's output. f32: 1e-4. bf16: 2^-6 · max|ref|, two to four bf16
    ulps of the largest output. Both round O to bf16, and the kernel rounds
    P against a running max where the plain version uses the row's final
    max, so a sound kernel differs by about one ulp; a skipped key tile or a
    missing accumulator rescale moves O by several times the limit."""
    if ref.dtype == torch.float32:
        return 1e-4
    return 2.0 ** -6 * ref.float().abs().max().item()


def _check(q, k, v, bias):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, N, D)")
    b, h, nq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if bias is not None and tuple(bias.shape) != (b, k.shape[2]):
        raise ValueError(f"bias must be (B, Nk) = {(b, k.shape[2])}, got {tuple(bias.shape)}")


def _check_cuda(lib, q, *others, bias=None):
    """Raise unless the kernel takes these tensors as they are: one dtype
    (bf16 or f32), a supported head dim, and a contiguous, 16-byte aligned
    head dim on every operand (the kernels use 16-byte vector loads)."""
    tensors = (q,) + others
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in others):
        raise TypeError(f"flash kernels take bf16 or f32 operands of one dtype, got {[t.dtype for t in tensors]}")
    if not lib.flash_supports(q.shape[-1]):
        raise ValueError(f"flash kernels do not support head dim {q.shape[-1]}")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"operand on {t.device}, q on {q.device}")
        if not _aligned(t):
            raise ValueError(f"operand needs a contiguous, 16-byte aligned head dim; strides {t.stride()}")
    if bias is not None and (bias.dtype != torch.float32 or not bias.is_contiguous() or bias.device != q.device):
        raise ValueError("bias must be a contiguous f32 tensor on q's device")


def _check_stats(q, *stats):
    """lse and di: (B, H, Nq) contiguous f32 on q's device."""
    for t in stats:
        if t.shape != q.shape[:3] or t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"lse and di must be contiguous f32 {tuple(q.shape[:3])} on q's device")


def _aligned(t: torch.Tensor) -> bool:
    align = 16 // t.element_size()
    return t.stride(3) == 1 and not any(st % align for st in t.stride()[:3]) and t.data_ptr() % 16 == 0


def _bind(source: str, entry: str, n_ptr: int, n_strides: int):
    """The loaded library of ``csrc/<source>.cu`` and its C function
    ``entry`` with the ctypes signature set: pointers, (B, H, Nq, Nk, D),
    strides, scale, is_bf16, stream. ``lib.flash_supports`` is the
    library's head-dim test."""
    from image_editing_framework_torch.ops import _cuda

    lib = _cuda.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * n_ptr + [i32] * 5 + [i64] * n_strides + [ctypes.c_float, i32, ptr]
        fn.restype = i32
        supports = getattr(lib, source + "_supports")
        supports.argtypes, supports.restype = [i32], i32
        lib.flash_supports = supports
    return lib, fn


def _stream(t: torch.Tensor) -> int:
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def _strides(*tensors) -> list:
    return [st for t in tensors for st in t.stride()[:3]]


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _forward(q, k, v, bias, sm_scale, return_lse) -> Result:
    """The forward kernel (CUDA tensors) or its plain version (CPU)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, sm_scale, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    lib, fn = _bind(_KERNEL, _KERNEL, 6, 12)
    _check_cuda(lib, q, k, v, bias=bias)
    b, h, nq, d = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if return_lse else None
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), o.data_ptr(), _ptr(lse),
        b, h, nq, k.shape[2], d, *_strides(q, k, v, o),
        float(sm_scale), int(q.dtype == torch.bfloat16), _stream(q),
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with a gradient for q, k and v (the JAX
    ``_flash.defvjp(_flash_fwd, _flash_bwd)``). The forward keeps the lse;
    the backward recomputes P from it. The bias gets no gradient: it is a
    mask, and the JAX VJP gives it a zero cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale):
        o, lse = _forward(q, k, v, bias, sm_scale, True)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.sm_scale = sm_scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, o, do, lse, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
) -> Result:
    """``softmax(q k^T * sm_scale + bias) v`` by online softmax.

    Args:
      q: (B, H, Nq, D); k/v: (B, H, Nk, D), bf16 or f32 (one dtype).
      bias: optional (B, Nk) f32 per-key logit bias, broadcast over heads
        and queries; NEG_INF disables a key.
      sm_scale: defaults to 1/sqrt(D).
      return_lse: also return the (B, H, Nq) f32 log-sum-exp (which carries
        no gradient).
    Returns:
      (B, H, Nq, D) in q's dtype, and the lse when asked. Differentiable in
      q, k and v.
    """
    _check(q, k, v, bias)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o, lse = FlashAttention.apply(q, k, v, bias, sm_scale)
        return (o, lse) if return_lse else o
    return _forward(q, k, v, bias, sm_scale, return_lse)


# Forward kernel launches since the count was last set to 0.
flash_attention.launches = 0


# ---------------------------------------------------------------------------
# backward


def _bwd_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(O * dO) in f32, (B, H, Nq) contiguous; outside the
    kernels, as JAX computes it outside Pallas (``_bwd_impl:480``)."""
    return (o.float() * do.float()).sum(dim=-1)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the two backward kernels, explicit f32 math
    with their rounding points: ``P = exp(q k^T * sm_scale + bias - lse)``
    (0 where lse is -inf), ``dS = P * (dO v^T - di) * sm_scale``; dS is
    rounded to k's dtype before ``dS k`` and to q's before ``dS^T q``, P to
    dO's before ``P^T dO``. dO is first cast to q's dtype, as the JAX VJP
    does (``_flash_bwd:804``)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    do = do.to(q.dtype)
    di = _bwd_di(o, do)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    lse = lse.float()[..., None]
    p = torch.where(torch.isneginf(lse), torch.zeros_like(s), torch.exp(s - lse))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - di[..., None]) * sm_scale
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()).to(k.dtype)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float()).to(v.dtype)
    return dq, dk, dv


def grad_parity_atol(ref: torch.Tensor) -> float:
    """Largest abs error a backward kernel's output may show against
    ``ref``, its plain version's. bf16: 2^-6 · max|ref|, two to four bf16
    ulps of the largest gradient, as ``parity_atol``: both round dS (or P)
    and the result to bf16 at the same places, so a sound kernel differs by
    about one ulp. f32: 2^-14 · max|ref|, far above the f32 sums' order
    noise and far below a skipped tile or a missing di."""
    return 2.0 ** (-14 if ref.dtype == torch.float32 else -6) * ref.float().abs().max().item()


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    o: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` given its output ``o``, the
    output's cotangent ``do`` and the forward's lse (B, H, Nq); the
    signature of the JAX ``flash_attention_bwd_block``. With a global lse,
    the backward against one key block is that block's share of the full
    gradient, as ring attention sums it.

    CUDA tensors launch ``flash_bwd_dq`` and ``flash_bwd_dkv``; CPU tensors
    take ``flash_attention_bwd_reference``. dO may come as any view with a
    contiguous, 16-byte aligned head dim (autograd hands it back through
    ``merge_heads`` with strides (N·H·D, D, H·D, 1)); another layout is
    copied once, and ``flash_attention_bwd.copies`` counts it.
    """
    _check(q, k, v, bias)
    if o.shape != q.shape or do.shape != q.shape or tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"o, do must be {tuple(q.shape)} and lse {tuple(q.shape[:3])}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, bias, o, do, lse, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu tensors, got {q.device}")
    do = do.to(q.dtype)
    if not _aligned(do):
        do = do.contiguous()
        flash_attention_bwd.copies += 1
    lse = lse.float().contiguous()
    di = _bwd_di(o, do)
    dq = flash_bwd_dq(q, k, v, bias, do, lse, di, sm_scale)
    dk, dv = flash_bwd_dkv(q, k, v, bias, do, lse, di, sm_scale)
    return dq, dk, dv


# Copies of a dO whose layout the kernels do not take.
flash_attention_bwd.copies = 0


def flash_bwd_dq(q, k, v, bias, do, lse, di, sm_scale: float) -> torch.Tensor:
    """Launch ``flash_bwd_dq`` (CUDA tensors only): dQ = dS K."""
    lib, fn = _bind(_BWD_KERNEL, "flash_bwd_dq", 8, 15)
    _check_cuda(lib, q, k, v, do, bias=bias)
    _check_stats(q, lse, di)
    b, h, nq, d = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), _ptr(bias), lse.data_ptr(), di.data_ptr(),
        dq.data_ptr(), b, h, nq, k.shape[2], d, *_strides(q, k, v, do, dq),
        float(sm_scale), int(q.dtype == torch.bfloat16), _stream(q),
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed: CUDA error {err}")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, bias, do, lse, di, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_bwd_dkv`` (CUDA tensors only): dV = P^T dO and
    dK = dS^T Q."""
    lib, fn = _bind(_BWD_KERNEL, "flash_bwd_dkv", 9, 18)
    _check_cuda(lib, q, k, v, do, bias=bias)
    _check_stats(q, lse, di)
    b, h, nq, d = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), _ptr(bias), lse.data_ptr(), di.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, h, nq, k.shape[2], d, *_strides(q, k, v, do, dk, dv),
        float(sm_scale), int(q.dtype == torch.bfloat16), _stream(q),
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed: CUDA error {err}")
    flash_bwd_dkv.launches += 1
    return dk, dv


# Backward kernel launches since the counts were last set to 0.
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def launch_counts() -> Tuple[int, int, int]:
    """Every counted kernel's launches: (forward, dQ, dK/dV)."""
    return flash_attention.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches


def add_launches(counts: Tuple[int, int, int]) -> None:
    """Add ``counts``, ordered as ``launch_counts`` gives them, to the
    counters: the launches a CUDA graph's replay makes, which no Python call
    counts."""
    flash_attention.launches += counts[0]
    flash_bwd_dq.launches += counts[1]
    flash_bwd_dkv.launches += counts[2]

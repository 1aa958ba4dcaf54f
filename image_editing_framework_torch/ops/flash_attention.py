"""Flash-attention forward: the hand-written CUDA kernel and its plain version.

Counterpart of ``image_editing_framework_tpu/ops/flash_attention.py``
(inference forward only: ``flash_attention:828`` and
``flash_attention_fwd_lse:872``). The TPU's two forward kernels, the classic
``_fwd_kernel`` and the transposed ``_fwd_kernel_t``, compute one function;
on the card that function is one kernel, ``csrc/flash_fwd.cu``.

``flash_attention`` dispatches on where its inputs lie:

* CUDA tensors launch the kernel, or the call raises. There is no fallback.
* CPU tensors take ``flash_attention_reference``, the plain PyTorch version
  the CPU tests hold against JAX and the card-side check holds the kernel
  against.

Backward kernels (NTI, pix2pix-zero, training) come with a later slice, so a
CUDA input that requires grad is refused rather than answered without one.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple, Union

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

_KERNEL = "flash_fwd"
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


def _check_cuda(q, k, v, bias, lib):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes bf16 or f32 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash kernel has no backward yet: pass inputs that do not require grad")
    if not lib.flash_fwd_supports(q.shape[-1]):
        raise ValueError(f"flash kernel does not support head dim {q.shape[-1]}")
    # 16-byte vector loads: the head dim is contiguous and every row starts
    # on a 16-byte boundary.
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1 or any(st % align for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous, 16-byte aligned head dim; strides {t.stride()}")
    if bias is not None and (bias.dtype != torch.float32 or not bias.is_contiguous() or bias.device != q.device):
        raise ValueError("bias must be a contiguous f32 tensor on q's device")


def _bind(lib):
    fn = lib.flash_fwd
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 6 + [i32] * 5 + [i64] * 12 + [ctypes.c_float, i32, ptr]
        fn.restype = i32
        lib.flash_fwd_supports.argtypes = [i32]
        lib.flash_fwd_supports.restype = i32
    return fn


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
      return_lse: also return the (B, H, Nq) f32 log-sum-exp.
    Returns:
      (B, H, Nq, D) in q's dtype, and the lse when asked.
    """
    _check(q, k, v, bias)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, sm_scale, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {q.device}")
    from image_editing_framework_torch.ops import _cuda

    lib = _cuda.load(_KERNEL)
    fn = _bind(lib)
    _check_cuda(q, k, v, bias, lib)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, nq, d = q.shape
    nk = k.shape[2]
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        o.data_ptr(), lse.data_ptr() if lse is not None else None,
        b, h, nq, nk, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        float(sm_scale), int(q.dtype == torch.bfloat16), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


# Kernel launches since the count was last set to 0.
flash_attention.launches = 0

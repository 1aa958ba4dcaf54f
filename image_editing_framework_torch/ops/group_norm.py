"""GroupNorm over channels-last activations, with the SiLU that follows it
fused in: the hand-written CUDA kernel and its plain version.

The UNet's and the VAE's GroupNorms (``models/unet.py``, ``models/vae.py``)
are ``GroupNorm`` modules: ``nn.GroupNorm``'s parameters and diffusers keys,
called as ``norm(x, silu=True)`` where a SiLU follows. The JAX package's
GroupNorm is plain jnp code that XLA fuses with its SiLU, so the kernel
replaces no TPU kernel. Every call dispatches on where its input lies:

* CUDA tensors launch ``csrc/group_norm_nhwc.cu``, or the call raises. The
  input must be channels-last (NHWC memory, ``models/layout.py``), bf16 or
  f32, with weight and bias of its dtype. There is no fallback.
* CPU tensors take the plain version, ``group_norm_reference``
  (``F.group_norm``, then ``F.silu``), the arithmetic the CPU tests hold
  against JAX and the card-side check holds the kernel against.

On inputs that require grad (with grad enabled) the kernel runs through
``GroupNormNHWC``, whose backward is the kernel's own: it keeps x and the
per-group mean and rstd, recomputes the output, and gives the weight's and
bias's gradients only where they are asked for. On CPU tensors the Function
runs the kernels' plain versions (``group_norm_stats_reference``,
``group_norm_bwd_reference``: the same formulas, in f32, or f64 for f64
inputs), which the CPU tests gradcheck.

Counters (``utils/profiling.py count``): ``norm_calls`` for each call of a
``GroupNorm`` module on a CUDA tensor, ``norm_nhwc`` for each launch of the
forward kernel; a CUDA graph's replay counts neither.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from image_editing_framework_torch.utils import profiling

_KERNEL = "group_norm_nhwc"
_DTYPES = (torch.bfloat16, torch.float32)

_lib: Optional[ctypes.CDLL] = None


class Plan(NamedTuple):
    """The f32 workspace the kernels ask for at one shape
    (``group_norm_nhwc_plan``): the forward's, the backward's without and
    with the parameters' gradients."""

    fwd_work: int
    bwd_work: int
    bwd_work_params: int


# (N, HW, C, G, is_bf16) -> the shape's plan, or None where the kernel does not take it
_plans: Dict[Tuple[int, int, int, int, int], Optional[Plan]] = {}


def group_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
                         silu: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``F.group_norm`` (f32 statistics), then
    ``F.silu`` when ``silu``, each rounded to x's dtype."""
    y = F.group_norm(x, groups, weight, bias, eps)
    return F.silu(y) if silu else y


def _groups(x: torch.Tensor, groups: int) -> torch.Tensor:
    """x (N, C, H, W) as (N, G, C/G, H, W) in f32 (f64 for f64 x)."""
    n, c, h, w = x.shape
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    return x.to(acc).reshape(n, groups, c // groups, h, w)


def group_norm_stats_reference(x: torch.Tensor, groups: int, eps: float):
    """Plain version of the forward's statistics: (mean, rstd), (N, G),
    biased variance."""
    xg = _groups(x, groups).flatten(2)
    return xg.mean(-1), torch.rsqrt(xg.var(-1, unbiased=False) + eps)


def _normalised(x, weight, bias, mean, rstd, groups):
    """(x̂, z = γ·x̂ + β) in the statistics' precision, grouped."""
    xh = (_groups(x, groups) - mean[..., None, None, None]) * rstd[..., None, None, None]
    shape = (groups, x.shape[1] // groups, 1, 1)
    return xh, xh * weight.to(xh.dtype).reshape(shape) + bias.to(xh.dtype).reshape(shape)


def group_norm_bwd_reference(x, dy, weight, bias, mean, rstd, groups: int, silu: bool, params: bool = True):
    """Plain version of the backward kernels: (dx, dweight, dbias), with
    dz = dy·silu'(z) (dy without SiLU), g = γ·dz and
    dx = rstd·(g − mean_group(g) − x̂·mean_group(g·x̂)),
    dweight = Σ dz·x̂, dbias = Σ dz over samples and pixels; the parameters'
    gradients None unless ``params``."""
    xh, z = _normalised(x, weight, bias, mean, rstd, groups)
    dz = _groups(dy, groups)
    if silu:
        sg = torch.sigmoid(z)
        dz = dz * sg * (1 + z * (1 - sg))
    g = dz * weight.to(dz.dtype).reshape(groups, -1, 1, 1)
    dims = (2, 3, 4)
    c1, c2 = g.mean(dims, keepdim=True), (g * xh).mean(dims, keepdim=True)
    dx = (rstd[..., None, None, None] * (g - c1 - xh * c2)).reshape(x.shape).to(x.dtype)
    if not params:
        return dx, None, None
    return (dx, (dz * xh).sum((0, 3, 4)).reshape(-1).to(weight.dtype),
            dz.sum((0, 3, 4)).reshape(-1).to(bias.dtype))


def _bind() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from image_editing_framework_torch.ops import _cuda

        lib = _cuda.load(_KERNEL)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.group_norm_nhwc_plan.argtypes = [i32] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
        lib.group_norm_nhwc_plan.restype = i32
        lib.group_norm_nhwc_fwd.argtypes = [ptr] * 7 + [i32] * 4 + [ctypes.c_float, i32, i32, ptr]
        lib.group_norm_nhwc_fwd.restype = i32
        lib.group_norm_nhwc_bwd.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
        lib.group_norm_nhwc_bwd.restype = i32
        _lib = lib
    return _lib


def plan(n: int, hw: int, c: int, groups: int, dtype: torch.dtype) -> Optional[Plan]:
    """The kernel's tile for an (N, HW, C) activation in ``groups`` groups,
    or None where the kernel does not take the shape (C not a multiple of
    the groups or of the 16-byte vector, 8 bf16 or 4 f32 channels; more than
    1024 vectors a pixel or C over 6144; N over 65535). Builds the kernel on
    first use."""
    key = (n, hw, c, groups, int(dtype == torch.bfloat16))
    if key not in _plans:
        out = (ctypes.c_longlong * 3)()
        _plans[key] = Plan(*out) if _bind().group_norm_nhwc_plan(*key, out) else None
    return _plans[key]


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device (a capture's, inside one)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int) -> Plan:
    """Raise unless the kernel takes these tensors as they are; returns the
    shape's plan."""
    if x.dtype not in _DTYPES or weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"group_norm_nhwc takes bf16 or f32 x, weight and bias of one dtype, got "
                        f"{x.dtype}, {weight.dtype}, {bias.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last) or x.data_ptr() % 16:
        raise ValueError(f"group_norm_nhwc takes a channels-last (B, C, H, W) tensor, 16-byte aligned; got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    n, c, h, w = x.shape
    device = x.get_device()
    for t in (weight, bias):
        if t.dim() != 1 or t.shape[0] != c or not t.is_contiguous() or t.get_device() != device:
            raise ValueError(f"weight and bias must be contiguous ({c},) on {x.device}")
    p = plan(n, h * w, c, groups, x.dtype)
    if p is None:
        raise ValueError(f"group_norm_nhwc does not take C = {c} in {groups} groups at {x.dtype} (batch {n})")
    return p


def _launch(x, weight, bias, groups: int, eps: float, silu: bool):
    """The forward kernels on CUDA tensors: (y, stats), stats an f32 buffer
    that holds mean (N, G), then rstd (N, G), then the kernels' workspace."""
    p = _check_cuda(x, weight, bias, groups)
    n, c, h, w = x.shape
    y = torch.empty_like(x)  # channels-last, as x
    stats = torch.empty((2 * n * groups + p.fwd_work,), dtype=torch.float32, device=x.device)
    ptr = stats.data_ptr()
    err = _bind().group_norm_nhwc_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), ptr, ptr + 4 * n * groups,
        ptr + 8 * n * groups, n, h * w, c, groups, eps, silu, x.dtype == torch.bfloat16, _stream(x))
    if err != 0:
        raise RuntimeError(f"group_norm_nhwc_fwd launch failed: CUDA error {err}")
    profiling.count("norm_nhwc")
    return y, stats


def _forward(x, weight, bias, groups: int, eps: float, silu: bool):
    """The forward kernels (CUDA tensors) or their plain version (CPU): (y,
    mean, rstd), the statistics (N, G) f32 (f64 for f64 x on the CPU)."""
    if x.device.type == "cpu":
        mean, rstd = group_norm_stats_reference(x, groups, eps)
        z = _normalised(x, weight, bias, mean, rstd, groups)[1]
        return (F.silu(z) if silu else z).reshape(x.shape).to(x.dtype), mean, rstd
    y, stats = _launch(x, weight, bias, groups, eps, silu)
    n = x.shape[0] * groups
    return y, stats[:n].view(x.shape[0], groups), stats[n:2 * n].view(x.shape[0], groups)


def group_norm_nhwc_bwd(x, dy, weight, bias, mean, rstd, groups: int, silu: bool, params: bool = True):
    """The backward kernels (CUDA tensors; plain version on the CPU): (dx,
    dweight, dbias) from x, dy and the forward's statistics; the parameters'
    gradients are None unless ``params``. dy is taken channels-last (copied
    where it is not)."""
    if x.device.type == "cpu":
        return group_norm_bwd_reference(x, dy, weight, bias, mean, rstd, groups, silu, params)
    p = _check_cuda(x, weight, bias, groups)
    n, c, h, w = x.shape
    dy = dy.contiguous(memory_format=torch.channels_last)
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight) if params else None
    db = torch.empty_like(bias) if params else None
    work = torch.empty((p.bwd_work_params if params else p.bwd_work,), dtype=torch.float32, device=x.device)
    err = _bind().group_norm_nhwc_bwd(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        dx.data_ptr(), dw.data_ptr() if params else None, db.data_ptr() if params else None, work.data_ptr(),
        n, h * w, c, groups, silu, x.dtype == torch.bfloat16, _stream(x))
    if err != 0:
        raise RuntimeError(f"group_norm_nhwc_bwd launch failed: CUDA error {err}")
    return dx, dw, db


class GroupNormNHWC(torch.autograd.Function):
    """The kernel with its gradient for x, weight and bias (on CPU tensors,
    the kernels' plain versions)."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, silu):
        y, mean, rstd = _forward(x, weight, bias, groups, eps, silu)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.groups, ctx.silu = groups, silu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        need_w, need_b = ctx.needs_input_grad[1:3]
        dx, dw, db = group_norm_nhwc_bwd(x, dy, weight, bias, mean, rstd, ctx.groups, ctx.silu, need_w or need_b)
        return dx, dw if need_w else None, db if need_b else None, None, None, None


def group_norm_nhwc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
                    silu: bool = False) -> torch.Tensor:
    """``silu(group_norm(x))`` (or the GroupNorm alone): the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"group_norm_nhwc runs on cuda or cpu tensors, got {x.device}")
        return group_norm_reference(x, weight, bias, groups, eps, silu)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return GroupNormNHWC.apply(x, weight, bias, groups, eps, silu)
    return _launch(x, weight, bias, groups, eps, silu)[0]


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` (its parameters, keys and arithmetic) whose forward
    runs ``group_norm_nhwc``, with the SiLU that follows fused in when
    ``silu``."""

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        if x.is_cuda:
            profiling.count("norm_calls")
        return group_norm_nhwc(x, self.weight, self.bias, self.num_groups, self.eps, silu)

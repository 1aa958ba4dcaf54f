"""LPIPS perceptual distance (VGG16 backbone).

Counterpart of ``image_editing_framework_tpu/eval/lpips.py``. The reference
lists torchmetrics in its requirements but never computes metrics; the
quality targets need LPIPS, so the network lives here, VGG16 written out by
hand (no torchvision). Weights load from the standard PyTorch artifacts:

* torchvision ``vgg16`` state_dict (``features.N.{weight,bias}``),
* the LPIPS linear heads (``lin{i}.model.1.weight``) from the official
  richzhang/PerceptualSimilarity release,

through ``LPIPS.from_torch_files`` with the JAX package's key mapping, or
from one ``.safetensors`` file holding both (``LPIPS(path)``, the form the
validation runway and the sweep are given). The port's own modules are
named as the JAX package's (``vgg.conv_{i}``, ``lin_{i}``). Without weights
the module is a seeded random net for shape and behaviour tests. The net
runs in float32 on the device it is given (the card unless the caller asks
for the CPU), with TF32 off in its convolutions.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from image_editing_framework_torch.core.device import DeviceLike, resolve_device, true_f32

# VGG16 conv layout: (out_channels, torchvision features index)
_VGG16_CONVS: Tuple[Tuple[int, int], ...] = (
    (64, 0), (64, 2),
    (128, 5), (128, 7),
    (256, 10), (256, 12), (256, 14),
    (512, 17), (512, 19), (512, 21),
    (512, 24), (512, 26), (512, 28),
)
# feature taps after these conv indices (relu1_2 ... relu5_3)
_TAPS = (1, 3, 6, 9, 12)
_POOL_AFTER = (1, 3, 6, 9)  # maxpool follows these conv indices

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class VGG16Features(nn.Module):
    """torchvision's ``vgg16().features`` up to relu5_3: 3x3 convolutions
    with ReLU, 2x2 max pools; returns the five tapped activations."""

    def __init__(self):
        super().__init__()
        in_ch = 3
        for i, (ch, _) in enumerate(_VGG16_CONVS):
            setattr(self, f"conv_{i}", nn.Conv2d(in_ch, ch, 3, padding=1))
            in_ch = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, 3, H, W) -> the activations at ``_TAPS``, NCHW."""
        taps = []
        for i in range(len(_VGG16_CONVS)):
            x = F.relu(getattr(self, f"conv_{i}")(x))
            if i in _TAPS:
                taps.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 2, 2)
        return taps


class LPIPSNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, tap in enumerate(_TAPS):
            setattr(self, f"lin_{i}", nn.Conv2d(_VGG16_CONVS[tap][0], 1, 1, bias=False))

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b: (B, H, W, 3) in [-1, 1]. Returns (B,) distances."""
        shift = torch.as_tensor(_SHIFT, dtype=a.dtype, device=a.device)
        scale = torch.as_tensor(_SCALE, dtype=a.dtype, device=a.device)
        fa = self.vgg(((a - shift) / scale).permute(0, 3, 1, 2))
        fb = self.vgg(((b - shift) / scale).permute(0, 3, 1, 2))
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / torch.sqrt(torch.sum(xa**2, dim=1, keepdim=True) + 1e-10)
            nb = xb / torch.sqrt(torch.sum(xb**2, dim=1, keepdim=True) + 1e-10)
            total = total + torch.mean(getattr(self, f"lin_{i}")((na - nb) ** 2), dim=(1, 2, 3))
        return total


def _port_state(vgg_state: Mapping, lin_state: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``LPIPSNet`` state dict from a torchvision vgg16 state
    dict and the LPIPS linear heads (the JAX ``from_torch_files`` mapping;
    the layouts are PyTorch's on both sides, so nothing is transposed)."""
    def tensor(x):
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))

    state = {}
    for i, (_, tv_idx) in enumerate(_VGG16_CONVS):
        state[f"vgg.conv_{i}.weight"] = tensor(vgg_state[f"features.{tv_idx}.weight"])
        state[f"vgg.conv_{i}.bias"] = tensor(vgg_state[f"features.{tv_idx}.bias"])
    for i in range(len(_TAPS)):
        state[f"lin_{i}.weight"] = tensor(lin_state[f"lin{i}.model.1.weight"])  # (1, C, 1, 1)
    return state


def _random_state(net: LPIPSNet, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights: each convolution N(0, 2 / fan_in) (He, so the
    activations stay live through the 13 layers), biases 0, the linear
    heads |N(0, 1 / C)| (real LPIPS heads are non-negative)."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, value in sorted(net.state_dict().items()):
        if key.endswith(".bias"):
            state[key] = torch.zeros(value.shape)
            continue
        fan_in = value.shape[1] * value.shape[2] * value.shape[3]
        x = torch.randn(value.shape, generator=gen) * (2.0 / fan_in if key.startswith("vgg.") else 1.0 / fan_in) ** 0.5
        state[key] = x.abs() if key.startswith("lin_") else x
    return state


class LPIPS:
    """Callable LPIPS metric on ``device``.

    ``params``: None (a seeded random net), a state dict of the port's
    ``LPIPSNet``, or the path of one ``.safetensors`` file holding
    torchvision's ``features.N.*`` and LPIPS's ``linN.model.1.weight``
    (read by the port's own reader, through ``from_torch_files``'s
    mapping)."""

    def __init__(self, params: Union[None, str, os.PathLike, Mapping] = None, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None):
        from image_editing_framework_torch.models.loader import load_params, load_safetensors

        self.device, self.dtype = resolve_device(device), dtype
        with torch.device("meta"):
            net = LPIPSNet()
        if isinstance(params, (str, os.PathLike)):
            tensors = load_safetensors(os.fspath(params))
            params = _port_state(tensors, tensors)
        state = _random_state(net, 0) if params is None else params
        self.net = load_params(net, state, dtype, self.device, strict=True).eval().requires_grad_(False)

    @classmethod
    def from_torch_files(cls, vgg_state: Mapping, lin_state: Mapping, dtype: torch.dtype = torch.float32,
                         device: DeviceLike = None) -> "LPIPS":
        """Build from a torchvision vgg16 state_dict + LPIPS linear heads."""
        return cls(_port_state(vgg_state, lin_state), dtype=dtype, device=device)

    def _input(self, x) -> torch.Tensor:
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(self.device)
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 127.5 - 1.0
        return x.to(self.dtype)

    @torch.no_grad()
    def distances(self, a, b) -> torch.Tensor:
        """Each pair's distance, (B,) float32 on the CPU. a, b: uint8
        (B, H, W, 3) or float in [-1, 1], numpy or tensors."""
        with true_f32():
            return self.net(self._input(a), self._input(b)).float().cpu()

    def __call__(self, a, b) -> float:
        """The mean distance of the pairs. a, b: uint8 (B, H, W, 3) or
        float in [-1, 1]."""
        return float(torch.mean(self.distances(a, b)))

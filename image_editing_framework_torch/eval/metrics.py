"""Structure metrics of edit quality: MSE, PSNR, SSIM.

Counterpart of ``image_editing_framework_tpu/eval/metrics.py:22-70``. The
reference computes no metrics (PIE-Bench evaluation there is visual); the
sweep records these three between each source and its reconstruction. They
run on the CPU in float32 whatever the inputs' device: the sweep calls them
from worker threads, which must not touch the card's stream. uint8 images
are scaled to [0, 1]; float images are taken as they are.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _to_float(img) -> torch.Tensor:
    if isinstance(img, torch.Tensor):
        x = img.detach().cpu()
    else:
        x = torch.from_numpy(np.ascontiguousarray(img))
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


def mse(a, b) -> float:
    a, b = _to_float(a), _to_float(b)
    return float(torch.mean((a - b) ** 2))


def psnr(a, b) -> float:
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return 10.0 * math.log10(1.0 / m)


def ssim(a, b, window: int = 7) -> float:
    """Mean SSIM over channels: a ``window`` x ``window`` uniform window,
    VALID, each channel on its own; (H, W, C) or (B, H, W, C). The
    variances are differences of window means (``avg(x²) − μ²``), so the
    window sums stay in float32: a lower-precision convolution would cancel
    them away (the JAX version sets ``Precision.HIGHEST`` for the TPU)."""
    a, b = _to_float(a), _to_float(b)
    if a.dim() == 3:
        a = a[None]
    if b.dim() == 3:
        b = b[None]
    channels = a.shape[3]
    kernel = torch.full((channels, 1, window, window), 1.0 / (window * window), dtype=torch.float32)

    def avg(x):
        return F.conv2d(x.permute(0, 3, 1, 2), kernel, groups=channels)

    c1, c2 = 0.01**2, 0.03**2
    mu_a, mu_b = avg(a), avg(b)
    var_a = avg(a * a) - mu_a**2
    var_b = avg(b * b) - mu_b**2
    cov = avg(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return float(torch.mean(s))

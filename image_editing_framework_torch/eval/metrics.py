"""Metrics of edit quality: MSE, PSNR, SSIM and the CLIP score.

Counterpart of ``image_editing_framework_tpu/eval/metrics.py``. The
reference computes no metrics (PIE-Bench evaluation there is visual); the
sweep records the structure metrics between each source and its
reconstruction. They run on the CPU in float32 whatever the inputs'
device: the sweep calls them from worker threads, which must not touch the
card's stream. uint8 images are scaled to [0, 1]; float images are taken as
they are.

``CLIPScore`` (image-text alignment) runs both towers of a CLIP checkpoint
on the device it is given (the card unless the caller asks for the CPU), in
true float32, on the calling thread. LPIPS lives in ``eval/lpips.py``.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from image_editing_framework_torch.core.device import DeviceLike, resolve_device, true_f32


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


class CLIPScore:
    """CLIP image-text alignment score: 100 * max(cos(img_emb, txt_emb), 0).

    Loads both towers of a full CLIP checkpoint (HF layout: a directory with
    ``model.safetensors`` holding text_model.* / vision_model.* /
    *_projection plus a ``tokenizer/`` or top-level vocab files) on
    ``device``. Raises if unavailable: no metric number is ever made up.

    The towers' configurations are the JAX package's: ``CLIPTextConfig``
    with ``projection_dim`` of ``CLIP_VIT_B32_VISION`` (a 768-wide text
    tower, which ``openai/clip-vit-base-patch32``'s 512-wide one does not
    fit) and ``CLIP_VIT_B32_VISION``, read from ``models/clip.py`` when the
    scorer is built, so a test can replace them there.
    """

    def __init__(self, checkpoint_dir: str, dtype: torch.dtype = torch.float32, device: DeviceLike = None):
        from image_editing_framework_torch.models import clip, loader
        from image_editing_framework_torch.models.registry import _load
        from image_editing_framework_torch.models.tokenizer import CLIPTokenizer

        self.device, self.dtype = resolve_device(device), dtype
        ckpt = loader.load_safetensors(os.path.join(checkpoint_dir, "model.safetensors"))
        vision_cfg = clip.CLIP_VIT_B32_VISION
        self.text = _load(clip.CLIPTextModel, clip.CLIPTextConfig(projection_dim=vision_cfg.projection_dim), ckpt,
                          dtype, self.device)
        self.vision = _load(clip.CLIPVisionModel, vision_cfg, ckpt, dtype, self.device)
        self.image_size = vision_cfg.image_size
        tok_dir = checkpoint_dir
        if os.path.isdir(os.path.join(checkpoint_dir, "tokenizer")):
            tok_dir = os.path.join(checkpoint_dir, "tokenizer")
        self.tokenizer = CLIPTokenizer.from_dir(tok_dir)

    @torch.no_grad()
    def embeddings(self, images, prompts: Sequence[str]):
        """(image embeddings, text embeddings), each (B, projection_dim)
        float32 of unit length on the scorer's device. images: uint8 (B, H,
        W, 3), numpy or a tensor; prompts: B strings."""
        from image_editing_framework_torch.models.clip import clip_preprocess
        from image_editing_framework_torch.models.tokenizer import pad_token_ids

        x = images if isinstance(images, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(images))
        ids = torch.as_tensor(pad_token_ids(self.tokenizer, list(prompts)), dtype=torch.int64)
        with true_f32():
            px = clip_preprocess(x.to(self.device), self.image_size).to(self.dtype)
            img = self.vision(px)["image_embeds"].float()
            txt = self.text(ids.to(self.device))["pooled"].float()
        return (img / torch.linalg.vector_norm(img, dim=-1, keepdim=True),
                txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True))

    def scores(self, images, prompts: Sequence[str]) -> torch.Tensor:
        """Each image's score against its prompt, (B,) float32 on the CPU."""
        img, txt = self.embeddings(images, prompts)
        return (100.0 * torch.clamp_min((img * txt).sum(dim=-1), 0.0)).cpu()

    def __call__(self, images, prompts: Sequence[str]) -> float:
        """The mean score of ``images`` (uint8 (B, H, W, 3)) against
        ``prompts`` (B strings)."""
        return float(torch.mean(self.scores(images, prompts)))

"""Model bundle: tokenizer + text encoder + UNet + VAE + scheduler (SD path).

Counterpart of ``image_editing_framework_tpu/pipelines.py``. The modules hold
their own weights; every compute method runs under ``torch.no_grad`` on the
pipeline's device. Public tensors are NHWC, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from image_editing_framework_torch.core.device import DeviceLike, resolve_device
from image_editing_framework_torch.core.scheduler import DDIMSchedule, make_ddim_schedule
from image_editing_framework_torch.models.clip import CLIPTextModel
from image_editing_framework_torch.models.tokenizer import pad_token_ids
from image_editing_framework_torch.models.unet import UNet2DCondition
from image_editing_framework_torch.models.vae import AutoencoderKL


@dataclasses.dataclass
class SDPipeline:
    """A Stable Diffusion 1.x model instance on one device."""

    model_type: str
    unet: UNet2DCondition
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: Any
    scheduler: DDIMSchedule
    device: torch.device
    dtype: torch.dtype = torch.float32

    # ------------------------------------------------------------------ text

    def _token_ids(self, prompts: Sequence[str]) -> torch.Tensor:
        ids = pad_token_ids(self.tokenizer, list(prompts))
        return torch.as_tensor(ids, dtype=torch.int64, device=self.device)

    @torch.no_grad()
    def encode_prompts_sd(self, prompts: Sequence[str], negative_prompt: str = "") -> torch.Tensor:
        """(2P, 77, D) context = [uncond x P, cond x P]
        (reference get_context, p2p/inversion/ddim.py:43-57)."""
        p = len(prompts)
        emb = self.text_encoder(self._token_ids(list(prompts) + [negative_prompt] * p))["last_hidden_state"]
        return torch.cat([emb[p:], emb[:p]], dim=0)

    def encode_prompts(self, prompts: Sequence[str], negative_prompt: str = "") -> Tuple[torch.Tensor, None]:
        """Returns (context, added_cond); the SD path has no added_cond."""
        if self.model_type != "sd":
            raise NotImplementedError("only the SD path is ported so far")
        return self.encode_prompts_sd(prompts, negative_prompt), None

    # ----------------------------------------------------------------- image

    @torch.no_grad()
    def image2latent(self, image: np.ndarray) -> torch.Tensor:
        """uint8 HWC (or BHWC) image -> scaled latent mean, NHWC
        (p2p/inversion/ddim.py:35-41)."""
        if image.ndim == 3:
            image = image[None]
        x = torch.as_tensor(np.ascontiguousarray(image), device=self.device).to(self.dtype) / 127.5 - 1.0
        return self.vae.encode(x)

    @torch.no_grad()
    def latent2image(self, latents: torch.Tensor) -> np.ndarray:
        """NHWC latents -> uint8 numpy images (p2p/model/sd_utils.py:82-88)."""
        img = torch.clamp(self.vae.decode(latents.to(self.dtype)).float() / 2 + 0.5, 0.0, 1.0)
        return torch.round(img * 255).to(torch.uint8).cpu().numpy()

    # ------------------------------------------------------------------ unet

    @torch.no_grad()
    def unet_apply(self, latents, t, context, ctrl=None):
        return self.unet(latents, t, context, ctrl)


def _frozen(module: nn.Module) -> nn.Module:
    return module.eval().requires_grad_(False)


def _build(cls, config, device: torch.device, dtype: torch.dtype, seed: int) -> nn.Module:
    """``cls(config)`` on ``device`` in ``dtype`` with seeded random weights,
    built without a default initialisation (meta device first)."""
    from image_editing_framework_torch.models.weights import random_init_

    with torch.device("meta"):
        module = cls(config)
    module = module.to_empty(device=device)
    return _frozen(random_init_(module, seed).to(dtype))


def random_pipeline(
    sd_version: str = "1.5",
    num_steps: int = 50,
    dtype: torch.dtype = torch.bfloat16,
    seed: int = 0,
    device: DeviceLike = None,
) -> SDPipeline:
    """Production-SHAPE pipeline with deterministic random weights: the SD1.5
    UNet (859.5M params), CLIP ViT-L text encoder and full VAE, weights from
    ``random_init_`` (norm scales centred at 1 so the network is live) —
    identical compute cost to trained checkpoints."""
    from image_editing_framework_torch.models import configs
    from image_editing_framework_torch.models.clip import CLIP_VIT_L
    from image_editing_framework_torch.models.tokenizer import WordTokenizer
    from image_editing_framework_torch.models.vae import VAEConfig

    if sd_version not in ("1.4", "1.5"):
        raise NotImplementedError(f"sd_version {sd_version!r}: only SD1.x is ported so far")
    device = resolve_device(device)
    return SDPipeline(
        model_type="sd",
        unet=_build(UNet2DCondition, configs.SD15_UNET, device, dtype, seed),
        vae=_build(AutoencoderKL, VAEConfig(), device, dtype, seed + 1),
        text_encoder=_build(CLIPTextModel, CLIP_VIT_L, device, dtype, seed + 2),
        tokenizer=WordTokenizer(vocab_size=49408),
        scheduler=make_ddim_schedule(num_steps),
        device=device,
        dtype=dtype,
    )


def tiny_pipeline(
    num_steps: int = 50,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> SDPipeline:
    """Random-weight tiny SD pipeline for tests (TINY_UNET, TINY_VAE, a
    2-layer CLIP as wide as the UNet's cross-attention, 64-word vocab)."""
    from image_editing_framework_torch.models import configs
    from image_editing_framework_torch.models.clip import TINY_CLIP
    from image_editing_framework_torch.models.tokenizer import WordTokenizer
    from image_editing_framework_torch.models.vae import TINY_VAE

    device = resolve_device(device)
    unet_cfg = configs.TINY_UNET
    clip_cfg = dataclasses.replace(
        TINY_CLIP, hidden_size=unet_cfg.cross_attention_dim, projection_dim=None, vocab_size=64
    )
    return SDPipeline(
        model_type="sd",
        unet=_build(UNet2DCondition, unet_cfg, device, dtype, seed),
        vae=_build(AutoencoderKL, TINY_VAE, device, dtype, seed + 1),
        text_encoder=_build(CLIPTextModel, clip_cfg, device, dtype, seed + 2),
        tokenizer=WordTokenizer(vocab_size=64),
        scheduler=make_ddim_schedule(num_steps),
        device=device,
        dtype=dtype,
    )

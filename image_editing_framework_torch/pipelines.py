"""Model bundle: tokenizer + text encoder(s) + UNet + VAE + scheduler.

Counterpart of ``image_editing_framework_tpu/pipelines.py``. The modules hold
their own weights; every compute method runs under ``torch.no_grad`` on the
pipeline's device. Public tensors are NHWC, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from image_editing_framework_torch.utils.profiling import phase

from image_editing_framework_torch.core.device import DeviceLike, resolve_device
from image_editing_framework_torch.core.scheduler import DDIMSchedule, make_ddim_schedule
from image_editing_framework_torch.models.clip import CLIPTextModel
from image_editing_framework_torch.models.tokenizer import pad_token_ids
from image_editing_framework_torch.models.unet import UNet2DCondition
from image_editing_framework_torch.models.vae import AutoencoderKL, decode_tiled


@dataclasses.dataclass
class SDPipeline:
    """A Stable Diffusion model family instance on one device.

    model_type: 'sd' (1.4/1.5/2.1) or 'xl' (SDXL base/refiner).
    """

    model_type: str
    unet: UNet2DCondition
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: Any
    scheduler: DDIMSchedule
    device: torch.device
    dtype: torch.dtype = torch.float32
    text_encoder_2: Optional[CLIPTextModel] = None
    tokenizer_2: Any = None
    # SDXL refiner flavour: single bigG text tower (1280-wide context),
    # (orig, crop, aesthetic_score) time ids, real (non-zero) uncond encode.
    is_refiner: bool = False
    # The attached img2img refinement pipeline when this pipe was built as
    # sd_version='xl-refiner' beside an XL-base editing pipe.
    refiner: Optional["SDPipeline"] = None
    # Default latent tile size for decodes (None = full-frame decode). When
    # set, latent2image tiles unless an explicit tile_latent overrides it.
    decode_tile_latent: Optional[int] = None

    # ------------------------------------------------------------------ text

    def _token_ids(self, prompts: Sequence[str], tokenizer=None) -> torch.Tensor:
        ids = pad_token_ids(tokenizer or self.tokenizer, list(prompts))
        return torch.as_tensor(ids, dtype=torch.int64, device=self.device)

    @torch.no_grad()
    def encode_prompts_sd(self, prompts: Sequence[str], negative_prompt: str = "") -> torch.Tensor:
        """(2P, 77, D) context = [uncond x P, cond x P]
        (reference get_context, p2p/inversion/ddim.py:43-57)."""
        p = len(prompts)
        emb = self.text_encoder(self._token_ids(list(prompts) + [negative_prompt] * p))["last_hidden_state"]
        return torch.cat([emb[p:], emb[:p]], dim=0)

    @torch.no_grad()
    def encode_prompts_xl(
        self, prompts: Sequence[str], negative_prompt: str = ""
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """SDXL dual-encoder: returns (context (2P,77,2048), pooled (2P,1280)).

        Mirrors diffusers encode_prompt with force_zeros_for_empty_prompt:
        the unconditional context/pooled are zeros for an empty negative
        prompt (used via p2p/model/sd_utils.py:189-222) and the encoded
        negative prompt otherwise.
        """
        p = len(prompts)

        def encode(texts):
            out1 = self.text_encoder(self._token_ids(texts))
            out2 = self.text_encoder_2(self._token_ids(texts, self.tokenizer_2))
            return torch.cat([out1["penultimate"], out2["penultimate"]], dim=-1), out2["pooled"]

        cond, pooled = encode(list(prompts))
        if negative_prompt:
            uncond, upooled = encode([negative_prompt] * p)
        else:
            uncond, upooled = torch.zeros_like(cond), torch.zeros_like(pooled)
        return torch.cat([uncond, cond], dim=0), torch.cat([upooled, pooled], dim=0)

    @torch.no_grad()
    def encode_prompts_refiner(
        self, prompts: Sequence[str], negative_prompt: str = ""
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """SDXL-refiner single-tower encode: context = bigG penultimate
        (1280-wide), pooled from the same tower. The reference builds the
        refiner with force_zeros_for_empty_prompt=False
        (p2p/edit_real.py:80-88), so the unconditional half is the *encoded*
        empty prompt, not zeros."""
        p = len(prompts)
        ids = self._token_ids(list(prompts) + [negative_prompt] * p, self.tokenizer_2)
        tower = self.text_encoder if self.text_encoder_2 is None else self.text_encoder_2
        out = tower(ids)
        ctx, pooled = out["penultimate"], out["pooled"]
        return torch.cat([ctx[p:], ctx[:p]], dim=0), torch.cat([pooled[p:], pooled[:p]], dim=0)

    def encode_prompts(
        self, prompts: Sequence[str], negative_prompt: str = ""
    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
        """Returns (context, added_cond or None) for self.model_type;
        ``negative_prompt`` replaces the empty-string unconditional."""
        with phase("text_encode"):
            if self.model_type == "xl":
                encode = self.encode_prompts_refiner if self.is_refiner else self.encode_prompts_xl
                context, pooled = encode(prompts, negative_prompt)
                return context, {"text_embeds": pooled}
            return self.encode_prompts_sd(prompts, negative_prompt), None

    def add_time_ids(self, height: int, width: int, batch: int, aesthetic_score: float = 6.0) -> torch.Tensor:
        """SDXL addition time ids, (batch, 6 or 5) f32. Base: (orig_h,
        orig_w, crop_t, crop_l, target_h, target_w) (reference:
        p2p/inversion/ddim.py:66-76). Refiner: (orig_h, orig_w, crop_t,
        crop_l, aesthetic_score), 5 ids x 256 dims + 1280 pooled = the 2560
        projection input of SDXL_REFINER_UNET."""
        last = (aesthetic_score,) if self.is_refiner else (height, width)
        ids = torch.tensor([[height, width, 0, 0, *last]], dtype=torch.float32, device=self.device)
        return ids.expand(batch, -1)

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
    def latent2image(self, latents: torch.Tensor, tile_latent: Optional[int] = None) -> np.ndarray:
        """NHWC latents -> uint8 numpy images (p2p/model/sd_utils.py:82-88).

        ``tile_latent`` decodes in overlapping latent tiles of that size
        (``models/vae.py decode_tiled``), which bounds the decoder's
        activation memory. Defaults to the pipeline's ``decode_tile_latent``."""
        if tile_latent is None:
            tile_latent = self.decode_tile_latent
        latents = latents.to(self.dtype)
        img = self.vae.decode(latents) if tile_latent is None else decode_tiled(self.vae, latents, tile_latent)
        img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
        return torch.round(img * 255).to(torch.uint8).cpu().numpy()

    # ------------------------------------------------------------------ unet

    @torch.no_grad()
    def unet_apply(self, latents, t, context, ctrl=None, added_cond=None):
        return self.unet(latents, t, context, ctrl, added_cond)


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
    """Production-SHAPE pipeline with deterministic random weights: the
    architectures of SD1.4/1.5 (UNet 859.5M params + CLIP ViT-L), SD2.1
    (+ OpenCLIP-H), SDXL base (UNet + CLIP-L + bigG) and the SDXL refiner
    (its UNet + bigG alone), each with the full VAE; weights from
    ``random_init_`` (norm scales centred at 1 so the network is live),
    identical compute cost to trained checkpoints."""
    from image_editing_framework_torch.models import configs
    from image_editing_framework_torch.models.clip import CLIP_VIT_L, OPEN_CLIP_BIG_G, OPEN_CLIP_VIT_H
    from image_editing_framework_torch.models.tokenizer import WordTokenizer
    from image_editing_framework_torch.models.vae import VAEConfig

    unet_cfgs = {"1.4": configs.SD15_UNET, "1.5": configs.SD15_UNET, "2.1": configs.SD21_UNET,
                 "xl": configs.SDXL_UNET, "xl-refiner": configs.SDXL_REFINER_UNET}
    if sd_version not in unet_cfgs:
        raise ValueError(f"sd_version must be one of {sorted(unet_cfgs)}, got {sd_version!r}")
    device = resolve_device(device)
    is_refiner, is_xl = sd_version == "xl-refiner", sd_version.startswith("xl")
    tokenizer = WordTokenizer(vocab_size=49408)
    text2 = _build(CLIPTextModel, OPEN_CLIP_BIG_G, device, dtype, seed + 3) if is_xl else None
    if is_refiner:
        # the single bigG tower carries the full 1280-wide context and the
        # pooled embedding; the refiner has no CLIP-L tower
        text = text2
    else:
        text = _build(CLIPTextModel, OPEN_CLIP_VIT_H if sd_version == "2.1" else CLIP_VIT_L, device, dtype, seed + 2)
    return SDPipeline(
        model_type="xl" if is_xl else "sd",
        unet=_build(UNet2DCondition, unet_cfgs[sd_version], device, dtype, seed),
        vae=_build(AutoencoderKL, VAEConfig(), device, dtype, seed + 1),
        text_encoder=text,
        tokenizer=tokenizer,
        scheduler=make_ddim_schedule(num_steps),
        device=device,
        dtype=dtype,
        text_encoder_2=text2,
        tokenizer_2=tokenizer if is_xl else None,
        is_refiner=is_refiner,
    )


def tiny_pipeline(
    num_steps: int = 50,
    model_type: str = "sd",
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> SDPipeline:
    """Random-weight tiny pipeline for tests (TINY_*_UNET, TINY_VAE, 2-layer
    CLIP towers, 64-word vocab). model_type: 'sd', 'xl' (two towers, each
    half as wide as the UNet's cross-attention, the second with a 16-wide
    pooled projection) or 'xl-refiner' (one bigG-style tower, 5 time ids)."""
    from image_editing_framework_torch.models import configs
    from image_editing_framework_torch.models.clip import TINY_CLIP
    from image_editing_framework_torch.models.tokenizer import WordTokenizer
    from image_editing_framework_torch.models.vae import TINY_VAE

    unet_cfgs = {"sd": configs.TINY_UNET, "xl": configs.TINY_XL_UNET, "xl-refiner": configs.TINY_REFINER_UNET}
    if model_type not in unet_cfgs:
        raise ValueError(f"model_type must be one of {sorted(unet_cfgs)}, got {model_type!r}")
    device = resolve_device(device)
    is_refiner, is_xl = model_type == "xl-refiner", model_type != "sd"
    unet_cfg = unet_cfgs[model_type]
    ctx_dim = unet_cfg.cross_attention_dim
    tokenizer = WordTokenizer(vocab_size=64)
    clip_cfg = dataclasses.replace(
        TINY_CLIP, hidden_size=ctx_dim if is_refiner or not is_xl else ctx_dim // 2,
        projection_dim=16 if is_refiner else None, vocab_size=64,
    )
    text = _build(CLIPTextModel, clip_cfg, device, dtype, seed + 2)
    text2 = None
    if is_refiner:
        text2 = text  # the single tower serves as text_encoder_2 (bigG role)
    elif is_xl:
        text2 = _build(CLIPTextModel, dataclasses.replace(clip_cfg, projection_dim=16), device, dtype, seed + 3)
    return SDPipeline(
        model_type="xl" if is_xl else "sd",
        unet=_build(UNet2DCondition, unet_cfg, device, dtype, seed),
        vae=_build(AutoencoderKL, TINY_VAE, device, dtype, seed + 1),
        text_encoder=text,
        tokenizer=tokenizer,
        scheduler=make_ddim_schedule(num_steps),
        device=device,
        dtype=dtype,
        text_encoder_2=text2,
        tokenizer_2=tokenizer if is_xl else None,
        is_refiner=is_refiner,
    )

"""Image-to-image refinement (SDEdit-style partial denoising).

Counterpart of ``image_editing_framework_tpu/methods/img2img.py``. Covers the
XL refiner's role: the reference's ``xl-refiner`` branch loads a
StableDiffusionXLImg2ImgPipeline (p2p/edit_real.py:77-89); the equivalent
capability lives here: noise an image's latent to ``strength`` of the
schedule and denoise the tail. The refiner UNet's ``time_ids`` carry
(orig_size, crop, aesthetic_score) instead of target_size: 5 ids x 256 dims
+ 1280 pooled = the 2560 projection input of SDXL_REFINER_UNET.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from image_editing_framework_torch.core.scheduler import add_noise, ddim_step


def refiner_time_ids(height: int, width: int, batch: int, aesthetic_score: float = 6.0) -> torch.Tensor:
    """(orig_h, orig_w, crop_t, crop_l, aesthetic_score): the refiner's
    addition ids (5 x 256 time embeddings + 1280 pooled = 2560), on the CPU."""
    return torch.tensor([[height, width, 0, 0, aesthetic_score]], dtype=torch.float32).expand(batch, 5)


@torch.no_grad()
def img2img(
    pipe,
    image: np.ndarray,  # uint8 (H, W, 3) or (1, H, W, 3)
    prompt: str,
    strength: float = 0.3,
    guidance_scale: float = 7.5,
    noise: Optional[torch.Tensor] = None,  # the latent's shape
    generator: Optional[torch.Generator] = None,
    aesthetic_score: float = 6.0,
    negative_aesthetic_score: float = 2.5,
) -> np.ndarray:
    """Partial-denoise refinement of an existing image. The noise comes in
    as ``noise`` or is drawn from ``generator`` (on the pipeline's device);
    one of the two is required, so no global seed is read."""
    sched = pipe.scheduler
    s = sched.num_steps
    start = max(0, min(s - 1, int(s * (1.0 - strength))))

    latent = pipe.image2latent(image)
    if noise is None:
        if generator is None:
            raise ValueError("img2img needs its noise: pass noise= or generator=")
        noise = torch.randn(latent.shape, generator=generator, device=latent.device, dtype=latent.dtype)
    lat = add_noise(sched, latent, noise.to(latent), int(sched.timesteps[start]))

    context, added = pipe.encode_prompts([prompt])
    added_cond = None
    if pipe.model_type == "xl":
        hh, ww = latent.shape[1] * 8, latent.shape[2] * 8
        # The CFG batch is [uncond, cond]: the unconditional half gets
        # negative_aesthetic_score (diffusers StableDiffusionXLImg2ImgPipeline
        # ._get_add_time_ids with requires_aesthetics_score; defaults 6.0 /
        # 2.5). The base layout ignores the score.
        tids = torch.cat([pipe.add_time_ids(hh, ww, 1, negative_aesthetic_score),
                          pipe.add_time_ids(hh, ww, 1, aesthetic_score)])
        added_cond = {"text_embeds": added["text_embeds"], "time_ids": tids}

    for i in range(start, s):
        eps, _ = pipe.unet(torch.cat([lat, lat]), int(sched.timesteps[i]), context, None, added_cond)
        eps_u, eps_c = eps.chunk(2)
        lat = ddim_step(sched, eps_u + guidance_scale * (eps_c - eps_u), i, lat)
    return pipe.latent2image(lat)

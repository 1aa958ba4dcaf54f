"""Prompt-to-Prompt editor.

Counterpart of ``image_editing_framework_tpu/methods/p2p.py`` (reference:
p2p/model/sd_utils.py, controllers from p2p/model/attention_control.py). All
controller state is precomputed into a P2PControl; the denoising loop is a
loop over steps.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from image_editing_framework_torch.core.config import P2PConfig, SamplerConfig
from image_editing_framework_torch.methods import common
from image_editing_framework_torch.methods.base import LocalBlend, denoise
from image_editing_framework_torch.ops import schedules
from image_editing_framework_torch.ops.controls import build_p2p_control


def p2p_setup(pipe, prompts: Sequence[str], latent: torch.Tensor, cfg: P2PConfig, sampler: SamplerConfig):
    """Everything ``p2p_edit`` hands the denoise loop: (start latents,
    context, control, LocalBlend or None, added conditions or None)."""
    p = len(prompts)
    blend = None
    record_blend = cfg.blend_words is not None
    if record_blend:
        alpha = schedules.blend_alpha_layers(prompts, cfg.blend_words, pipe.tokenizer)
        blend = LocalBlend(torch.as_tensor(alpha, device=pipe.device), threshold=cfg.blend_threshold)
    ctrl = build_p2p_control(prompts, pipe.tokenizer, pipe.scheduler.num_steps, cfg, record_blend, pipe.device)
    context, added_cond = common.prepare_conditioning(pipe, prompts, sampler.height, sampler.width)
    return common.expand_latent(latent, p), context, ctrl, blend, added_cond


def p2p_edit(
    pipe,
    prompts: Sequence[str],
    latent: torch.Tensor,  # (1, h, w, 4) — inverted or sampled start latent
    cfg: P2PConfig = P2PConfig(),
    sampler: SamplerConfig = SamplerConfig(),
    uncond_seq: Optional[torch.Tensor] = None,  # (S, 77, D) NTI embeddings
    source_replay: Optional[torch.Tensor] = None,  # direct-inversion trajectory
) -> np.ndarray:
    """Run a P2P edit; returns uint8 images (P, H, W, 3) where row 0 is the
    source-branch reconstruction (the reference's inversion.png)."""
    latents0, context, ctrl, blend, added_cond = p2p_setup(pipe, prompts, latent, cfg, sampler)
    final = denoise(pipe, latents0, context, ctrl, guidance_scale=sampler.guidance_scale, blend=blend,
                    uncond_seq=uncond_seq, source_replay=source_replay, added_cond=added_cond)
    return pipe.latent2image(final)

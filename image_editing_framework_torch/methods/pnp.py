"""Plug-and-Play editor (spatial-feature + self-attention Q/K injection).

Counterpart of ``image_editing_framework_tpu/methods/pnp.py`` (reference:
pnp/model/sd_utils.py, PnP.__call__ and its NTI/XL variants; injection
semantics from pnp/model/register.py). Gates are per-step booleans;
injection is a batch-index remap at a static set of attention sites and the
ResNet hook at the feature sites.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from image_editing_framework_torch.core.config import PnPConfig, SamplerConfig
from image_editing_framework_torch.methods import common
from image_editing_framework_torch.methods.base import denoise
from image_editing_framework_torch.models import configs as model_configs
from image_editing_framework_torch.ops.controls import build_pnp_control


def pnp_edit(
    pipe,
    prompts: Sequence[str],  # [source_prompt, target_prompt]
    latent: torch.Tensor,  # (1, h, w, 4) — inverted or sampled start latent
    cfg: PnPConfig = PnPConfig(),
    sampler: SamplerConfig = SamplerConfig(),
    uncond_seq: Optional[torch.Tensor] = None,  # (S, 77, D) NTI embeddings
    source_replay: Optional[torch.Tensor] = None,  # direct-inversion trajectory
) -> np.ndarray:
    """Run a PnP edit; returns uint8 images (2, H, W, 3), row 0 the source
    branch's reconstruction."""
    if len(prompts) != 2:
        raise ValueError(f"PnP edits one (source, target) prompt pair, got {len(prompts)} prompts")
    sites = model_configs.pnp_sites_xl if pipe.model_type == "xl" else model_configs.pnp_sites_sd
    attn_layers, conv_keys = sites(pipe.unet.config)
    ctrl = build_pnp_control(pipe.scheduler.num_steps, cfg, attn_layers, conv_keys, device=pipe.device)
    context, added_cond = common.prepare_conditioning(pipe, prompts, sampler.height, sampler.width)
    final = denoise(pipe, common.expand_latent(latent, 2), context, ctrl, guidance_scale=sampler.guidance_scale,
                    uncond_seq=uncond_seq, source_replay=source_replay, added_cond=added_cond)
    return pipe.latent2image(final)

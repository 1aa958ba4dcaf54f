"""Shared editor plumbing."""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch


def grad_unet(pipe, latent_side: int, force: Optional[bool] = None) -> Callable:
    """The UNet callable to differentiate through at this scale (JAX
    ``methods/common.py:10 grad_unet``).

    Gradient programs (pix2pix-zero's guided step, NTI's inner Adam loop)
    backpropagate through the whole UNet. At XL 1024² (latent side 128) they
    take the UNet with every BasicTransformerBlock checkpointed: identical
    outputs and gradients, the blocks' activations recomputed in the
    backward pass instead of kept. Smaller programs keep the plain module.
    ``force`` overrides the rule.
    ``latent_side`` is what the JAX callers pass: pix2pix-zero passes
    ``latent.shape[1]`` of its NHWC latent, NTI the trajectory's height.
    """
    remat = force if force is not None else pipe.model_type == "xl" and latent_side >= 128
    return functools.partial(pipe.unet, remat=True) if remat else pipe.unet


def prepare_conditioning(
    pipe, prompts: Sequence[str], height: int, width: int, negative_prompt: str = ""
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Encode prompts: the (2P, 77, D) context and, for XL, the (2P, ...)
    added conditions (pooled text embeddings and time ids)."""
    context, added = pipe.encode_prompts(prompts, negative_prompt)
    added_cond = None
    if pipe.model_type == "xl":
        added_cond = {
            "text_embeds": added["text_embeds"],
            "time_ids": pipe.add_time_ids(height, width, context.shape[0]),
        }
    return context, added_cond


def expand_latent(latent: torch.Tensor, num_prompts: int) -> torch.Tensor:
    """One latent shared by all prompt branches (reference init_latent,
    p2p/model/sd_utils.py:13-21 / torch.cat([latent, latent]))."""
    if latent.shape[0] == num_prompts:
        return latent
    if latent.shape[0] != 1:
        raise ValueError(f"expected 1 or {num_prompts} latents, got {latent.shape[0]}")
    return latent.expand((num_prompts,) + tuple(latent.shape[1:]))

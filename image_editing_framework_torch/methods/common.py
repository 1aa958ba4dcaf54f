"""Shared editor plumbing (SD path)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch


def prepare_conditioning(
    pipe, prompts: Sequence[str], height: int, width: int, negative_prompt: str = ""
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Encode prompts: the (2P, 77, D) context and the added conditions,
    which the SD path has none of (SDXL's arrive with its slice)."""
    del height, width
    context, _ = pipe.encode_prompts(prompts, negative_prompt)
    return context, None


def expand_latent(latent: torch.Tensor, num_prompts: int) -> torch.Tensor:
    """One latent shared by all prompt branches (reference init_latent,
    p2p/model/sd_utils.py:13-21 / torch.cat([latent, latent]))."""
    if latent.shape[0] == num_prompts:
        return latent
    if latent.shape[0] != 1:
        raise ValueError(f"expected 1 or {num_prompts} latents, got {latent.shape[0]}")
    return latent.expand((num_prompts,) + tuple(latent.shape[1:]))

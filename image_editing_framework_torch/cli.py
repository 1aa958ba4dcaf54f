"""The shared logic of the editing entry points (inversion so far).

Counterpart of ``image_editing_framework_tpu/cli.py``: ``invert`` is the
normal entry that picks the inversion (DDIM, null-text or direct) for a real
image, with the reference's learning-rate schedules (``nti_config_for``).
The argument parsing and the per-method ``*_main`` entry points arrive with the
CLI slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from image_editing_framework_torch.core.config import NTIConfig
from image_editing_framework_torch.inversion.ddim import ddim_invert
from image_editing_framework_torch.inversion.nti import null_text_inversion

GUIDANCE_SCALE = 7.5
INVERSION_TYPES = ("ddim", "null-text", "direct")


def nti_config_for(method: str, pipe) -> NTIConfig:
    """lr schedule: p2p's XL variant uses 0.5*(1-i/500)
    (p2p/inversion/nti.py:50,69); the other methods' XL uses 5e-2*(1-i/100)
    (masactrl/inversion/nti.py:69); all SD variants use 1e-2*(1-i/100)."""
    if pipe.model_type == "xl":
        if method == "p2p":
            return NTIConfig(base_lr=0.5, lr_decay_span=500.0)
        return NTIConfig(base_lr=5e-2, lr_decay_span=100.0)
    return NTIConfig()


def invert(
    pipe, image: np.ndarray, source_prompt: str, inversion_type: str, method: str
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Invert a uint8 image under ``source_prompt``. Returns (start latent,
    inversion trajectory (S+1, 1, h, w, 4), per-step unconditional
    embeddings (S, 77, D) for ``null-text``, else None). ``direct``
    inversion hands the trajectory to the edit as ``source_replay``."""
    if inversion_type not in INVERSION_TYPES:
        raise ValueError(f"inversion type must be one of {INVERSION_TYPES}, got {inversion_type!r}")
    latent = pipe.image2latent(image)
    last, traj, context, added_cond = ddim_invert(pipe, latent, source_prompt)
    uncond_seq = None
    if inversion_type == "null-text":
        uncond_seq = null_text_inversion(pipe, traj, context, nti_config_for(method, pipe),
                                         guidance_scale=GUIDANCE_SCALE, added_cond=added_cond)
    return last, traj, uncond_seq

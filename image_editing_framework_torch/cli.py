"""The shared logic of the editing entry points.

Counterpart of ``image_editing_framework_tpu/cli.py``: ``invert`` is the
normal entry that picks the inversion (DDIM, null-text or direct) for a real
image, with the reference's learning-rate schedules (``nti_config_for``);
``run_method`` dispatches one edit to P2P, MasaCtrl, PnP or pix2pix-zero,
with the MasaCtrl command-line options merged by ``_masactrl_cli_kwargs``.
The argument parsing and the per-method ``*_main`` entry points arrive with
the CLI slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from image_editing_framework_torch.core.config import NTIConfig, P2PConfig, P2ZConfig, PnPConfig, SamplerConfig
from image_editing_framework_torch.inversion.ddim import ddim_invert
from image_editing_framework_torch.inversion.nti import null_text_inversion
from image_editing_framework_torch.methods.masactrl import default_masactrl_config, masactrl_edit
from image_editing_framework_torch.methods.p2p import p2p_edit
from image_editing_framework_torch.methods.p2z import p2z_edit
from image_editing_framework_torch.methods.pnp import pnp_edit

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


def _int_list(spec: Optional[str]):
    """``"1,2,3"`` -> (1, 2, 3); None or ``""`` -> None."""
    if spec is None or spec == "":
        return None
    return tuple(int(x) for x in spec.split(",") if x.strip() != "")


def _masactrl_cli_kwargs(args, pipe, method_kwargs: Optional[dict]) -> dict:
    """Merge the MasaCtrl-only command-line options (``neg_prompt``,
    ``step_idx``, ``layer_idx``) of ``args`` into ``method_kwargs``."""
    kw = dict(method_kwargs or {})
    if getattr(args, "neg_prompt", ""):
        kw.setdefault("neg_prompt", args.neg_prompt)
    step_idx = _int_list(getattr(args, "step_idx", None))
    layer_idx = _int_list(getattr(args, "layer_idx", None))
    if step_idx is not None or layer_idx is not None:
        base = kw.get("config") or default_masactrl_config(pipe)
        kw["config"] = dataclasses.replace(base, step_idx=step_idx, layer_idx=layer_idx)
    return kw


def run_method(
    method: str,
    pipe,
    prompts,
    latent: torch.Tensor,
    sampler: SamplerConfig,
    uncond_seq: Optional[torch.Tensor] = None,
    method_kwargs: Optional[dict] = None,
    source_replay: Optional[torch.Tensor] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dispatch one edit; returns (inversion image, edit image), uint8.

    ``source_replay`` (the inversion trajectory) enables direct inversion:
    the source branch replays its recorded latents each step, pinning the
    reconstruction to the input while the target branch edits freely;
    pix2pix-zero ignores it. ``method_kwargs`` go to the editor (``config``
    its configuration; pix2pix-zero's default recomputes the reference maps
    on XL pipelines, where keeping them would take ~25 GB at 1024²).
    """
    kw = dict(method_kwargs or {})
    if source_replay is not None and method != "p2z":
        kw.setdefault("source_replay", source_replay)
    if method == "p2p":
        cfg = kw.pop("config", P2PConfig())
        imgs = p2p_edit(pipe, prompts, latent, cfg, sampler, uncond_seq=uncond_seq, **kw)
    elif method == "masactrl":
        cfg = kw.pop("config", None) or default_masactrl_config(pipe)
        imgs = masactrl_edit(pipe, prompts, latent, cfg, sampler, uncond_seq=uncond_seq, **kw)
    elif method == "pnp":
        cfg = kw.pop("config", PnPConfig())
        imgs = pnp_edit(pipe, prompts, latent, cfg, sampler, uncond_seq=uncond_seq, **kw)
    elif method == "p2z":
        cfg = kw.pop("config", P2ZConfig(recompute_refs=pipe.model_type == "xl"))
        rec, edit = p2z_edit(pipe, prompts, latent, cfg, sampler, uncond_seq=uncond_seq, **kw)
        return rec[0], edit[0]
    else:
        raise ValueError(f"unknown method {method}")
    return imgs[0], imgs[1]

"""The editing entry points and their shared logic.

Counterpart of ``image_editing_framework_tpu/cli.py``. The reference ships
its scripts per method (edit_syn.py, edit_real.py) with identical plumbing;
here it lives once: ``edit_real_main`` / ``edit_syn_main`` parse the
reference's flags (``common_parser``), load the pipeline named by
``--sd_version`` through ``sd_mapping.py`` (``load_pipe``), and write
``./exp/*.png``; ``invert`` picks the inversion (DDIM, null-text or direct)
for a real image, with the reference's learning-rate schedules
(``nti_config_for``); ``run_method`` dispatches one edit to P2P, MasaCtrl,
PnP or pix2pix-zero, with the MasaCtrl command-line options merged by
``_masactrl_cli_kwargs``; ``test_main`` runs the PIE-Bench sweep
(``eval/sweep.py run_sweep``) with the reference test.py's flags.
``shims.py`` holds each method's defaults.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
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
from image_editing_framework_torch.utils.images import load_image, save_img

GUIDANCE_SCALE = 7.5
NUM_INFERENCE_STEPS = 50
OUT_PATH = "./exp"  # where the entry points write their images
INVERSION_TYPES = ("ddim", "null-text", "direct")


def common_parser(
    name: str,
    default_seed: int = 42,
    default_source: str = "a gray horse in the field",
    default_target: str = "a whie horse in the field",
    real: bool = True,
    default_inversion: str = "null-text",
    method: Optional[str] = None,
) -> argparse.ArgumentParser:
    """The reference's flags and defaults (p2p/edit_real.py:19-27).
    ``--device`` is the index of the CUDA card to run on."""
    p = argparse.ArgumentParser(name)
    p.add_argument("--sd_version", type=str, default="1.5")
    p.add_argument("--device", type=int, default=0)
    p.add_argument("--seed", type=int, default=default_seed)
    p.add_argument("--source_prompt", type=str, default=default_source)
    p.add_argument("--target_prompt", type=str, default=default_target)
    if real:
        p.add_argument("--source_image", type=str, default="./test.jpg")
        p.add_argument("--inversion_type", type=str, default=default_inversion)
    if method == "masactrl":
        # the reference controller's optional knobs
        # (masactrl/model/attention_control.py:16, sd_utils.py:73-77)
        p.add_argument("--neg_prompt", type=str, default="")
        p.add_argument("--step_idx", type=str, default=None,
                       help="comma-separated explicit step list (overrides start_step)")
        p.add_argument("--layer_idx", type=str, default=None,
                       help="comma-separated explicit layer list (overrides start_layer)")
    return p


def load_pipe(sd_version: str, dtype: torch.dtype = torch.bfloat16, device=None):
    """The pipeline ``sd_mapping.sd_maps[sd_version]`` names, with the
    reference's 50-step schedule, on ``device`` (the card by default)."""
    from image_editing_framework_torch.models.registry import load_pipeline

    return load_pipeline(sd_version, NUM_INFERENCE_STEPS, dtype=dtype, device=device)


def resolution_for(pipe) -> int:
    return 1024 if pipe.model_type == "xl" else 512


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


def _setup(method: str, args, method_kwargs: Optional[dict]):
    """(pipeline on the card ``--device`` names, method kwargs with the
    MasaCtrl flags merged, resolution, sampler); makes ``OUT_PATH``."""
    pipe = load_pipe(args.sd_version, device=torch.device("cuda", args.device))
    if method == "masactrl":
        method_kwargs = _masactrl_cli_kwargs(args, pipe, method_kwargs)
    res = resolution_for(pipe)
    os.makedirs(OUT_PATH, exist_ok=True)
    return pipe, method_kwargs, res, SamplerConfig(height=res, width=res, seed=args.seed)


def edit_real_main(method: str, argv=None, method_kwargs: Optional[dict] = None,
                   default_inversion: str = "null-text",
                   default_source: str = "a gray horse in the field",
                   default_target: str = "a whie horse in the field"):
    """Real-image edit (reference: */edit_real.py): load ``--source_image``
    at the model's resolution, invert it (``--inversion_type``), edit it
    from ``--source_prompt`` to ``--target_prompt``; writes
    ``./exp/{source,inversion,edit}.png``."""
    args = common_parser(f"{method} edit_real", real=True, default_inversion=default_inversion,
                         default_source=default_source, default_target=default_target,
                         method=method).parse_args(argv)
    pipe, method_kwargs, res, sampler = _setup(method, args, method_kwargs)
    image = load_image(args.source_image, res, res)
    save_img(image, os.path.join(OUT_PATH, "source.png"))
    latent, traj, uncond_seq = invert(pipe, image, args.source_prompt, args.inversion_type, method)
    replay = traj if args.inversion_type == "direct" else None
    inv_img, edit_img = run_method(method, pipe, [args.source_prompt, args.target_prompt], latent, sampler,
                                   uncond_seq, method_kwargs, source_replay=replay)
    save_img(inv_img, os.path.join(OUT_PATH, "inversion.png"))
    save_img(edit_img, os.path.join(OUT_PATH, "edit.png"))


def edit_syn_main(method: str, argv=None, method_kwargs: Optional[dict] = None,
                  default_seed: int = 8888,
                  default_source: str = "a photo of a house on a mountain",
                  default_target: str = "a photo of a house on a mountain at fall"):
    """Synthetic edit (reference: */edit_syn.py): one start latent from
    ``--seed``, denoised under ``--source_prompt`` and ``--target_prompt``;
    writes ``./exp/{source,edit}.png``.

    The start latent is ``torch.randn`` from
    ``torch.Generator(device).manual_seed(seed)`` on the pipeline's device,
    cast to its dtype. JAX's PRNG stream cannot be reproduced in torch, so a
    seed gives another image here than in the JAX package."""
    args = common_parser(f"{method} edit_syn", real=False, default_seed=default_seed,
                         default_source=default_source, default_target=default_target,
                         method=method).parse_args(argv)
    pipe, method_kwargs, res, sampler = _setup(method, args, method_kwargs)
    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    latent = torch.randn((1, res // 8, res // 8, 4), generator=gen, device=pipe.device).to(pipe.dtype)
    src_img, edit_img = run_method(method, pipe, [args.source_prompt, args.target_prompt], latent, sampler,
                                   None, method_kwargs)
    save_img(src_img, os.path.join(OUT_PATH, "source.png"))
    save_img(edit_img, os.path.join(OUT_PATH, "edit.png"))


def test_main(method: str, argv=None, method_kwargs: Optional[dict] = None):
    """PIE-Bench sweep (reference: */test.py): load ``--sd_version`` on the
    card, then ``run_sweep`` over ``--dataset_path`` into ``--exp_path``
    (categories 0-4 and 6-9, per image invert -> edit -> save, resumable,
    sharded by ``--shard_index`` / ``--shard_count``)."""
    p = argparse.ArgumentParser(f"{method} test")
    p.add_argument("--sd_version", type=str, default="1.5")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dataset_path", type=str, default="./PIE")
    p.add_argument("--exp_path", type=str, default="./test_exp")
    p.add_argument("--inversion_type", type=str, default="ddim")
    p.add_argument("--resume", action="store_true", default=True)
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--shard_count", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--inversion_path", type=str, default=None)
    p.add_argument("--save_inversions", type=str, default=None)
    args = p.parse_args(argv)
    pipe = load_pipe(args.sd_version)

    from image_editing_framework_torch.eval.sweep import run_sweep

    return run_sweep(
        pipe, method, args.dataset_path, args.exp_path, inversion_type=args.inversion_type, seed=args.seed,
        method_kwargs=method_kwargs, resume=args.resume, shard_index=args.shard_index,
        shard_count=args.shard_count, batch_size=args.batch_size, inversion_path=args.inversion_path,
        save_inversions=args.save_inversions,
    )

"""Batched multi-image editing: a group of images in one batch.

Counterpart of ``image_editing_framework_tpu/eval/batched.py``. The JAX
package ``vmap``s each image's edit over the group; here the group is folded
into the batch axis (``ops/controls.py``: B = G·2P, group-major), so every
denoising step is one UNet call for the whole group, and a group of G
launches the kernels one image launches, each at G times its batch. The
controls act within each image's block: P2P's token mappers and alphas are
stacked per image (``stack_controls``), so replace and refine, both 77 x 77
matrices, batch together; MasaCtrl's and PnP's gates depend on the config
alone, so one control serves the group. The batched editors run without
LocalBlend, as the JAX ones do.

Latents are NHWC ``(G, 1, h, w, 4)``; the editors return ``(G, 2, H, W, 3)``
uint8 numpy arrays, [reconstruction, edit] per image.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from image_editing_framework_torch.core.config import MasaCtrlConfig, NTIConfig, P2PConfig, P2ZConfig, PnPConfig
from image_editing_framework_torch.inversion.ddim import _invert_scan
from image_editing_framework_torch.inversion.nti import null_text_inversion, null_text_inversion_batch
from image_editing_framework_torch.methods import common
from image_editing_framework_torch.methods.base import _denoise_scan
from image_editing_framework_torch.methods.masactrl import default_masactrl_config
from image_editing_framework_torch.methods.p2z import _guided_scan_group
from image_editing_framework_torch.models import configs as model_configs
from image_editing_framework_torch.ops import controls as ctl
from image_editing_framework_torch.ops.controls import stack_controls
from image_editing_framework_torch.utils.profiling import phase


def _encode_pairs(pipe, prompt_pairs: Sequence[Sequence[str]], latents: torch.Tensor):
    """Contexts (G, 2P, 77, D) and per-image XL added conditions (or None)
    for G prompt tuples in one text-encoder call. The XL time ids come from
    the latents' spatial size, as in the serial inversion."""
    flat = [p for pair in prompt_pairs for p in pair]  # [s0, t0, s1, t1, ...]
    g, pp = len(prompt_pairs), len(prompt_pairs[0])
    context, added = pipe.encode_prompts(flat)  # (2·G·pp, 77, D)

    def fold(x):  # [uncond..., cond...] -> (G, 2pp, ...)
        u = x[: g * pp].reshape((g, pp) + tuple(x.shape[1:]))
        c = x[g * pp :].reshape((g, pp) + tuple(x.shape[1:]))
        return torch.cat([u, c], dim=1)

    added_cond = None
    if pipe.model_type == "xl":
        h, w = latents.shape[-3] * 8, latents.shape[-2] * 8
        tids = pipe.add_time_ids(h, w, 2 * pp)  # (2pp, n_ids)
        added_cond = {"text_embeds": fold(added["text_embeds"]),  # (G, 2pp, P)
                      "time_ids": tids[None].expand((g,) + tuple(tids.shape))}
    return fold(context), added_cond


def _decode_pairs(pipe, final: torch.Tensor) -> np.ndarray:
    """(G, 2, h, w, 4) latents -> (G, 2, H, W, 3) uint8 in one decode."""
    with phase("decode"):
        g = final.shape[0]
        imgs = pipe.latent2image(final.reshape((g * 2,) + tuple(final.shape[2:])))
        return imgs.reshape((g, 2) + imgs.shape[1:])


def _edit(pipe, prompt_pairs, latents, ctrl, guidance_scale, uncond_seqs, source_replays) -> np.ndarray:
    """The group's denoising loop from each image's one start latent, both
    branches, and its decode."""
    g = len(prompt_pairs)
    contexts, added = _encode_pairs(pipe, prompt_pairs, latents)
    lat0 = latents.expand((g, 2) + tuple(latents.shape[2:]))
    final, _, _ = _denoise_scan(pipe.unet, pipe.scheduler, lat0, contexts, ctrl, guidance_scale, None, None,
                                uncond_seqs, source_replays, added)
    return _decode_pairs(pipe, final)


def p2p_edit_batch(
    pipe,
    prompt_pairs: Sequence[Sequence[str]],  # G pairs [source, target]
    latents: torch.Tensor,  # (G, 1, h, w, 4)
    cfgs: Optional[Sequence[P2PConfig]] = None,
    guidance_scale: float = 7.5,
    uncond_seqs: Optional[torch.Tensor] = None,  # (G, S, 77, D) NTI embeddings
    source_replays: Optional[torch.Tensor] = None,  # (G, S+1, 1, h, w, 4)
) -> np.ndarray:
    """P2P-edit G images in one batch, each with its own config (replace and
    refine mix); returns (G, 2, H, W, 3) uint8."""
    g = len(prompt_pairs)
    s = pipe.scheduler.num_steps
    if cfgs is None:
        cfgs = [P2PConfig()] * g
    with phase("control"):
        ctrl = stack_controls([ctl.build_p2p_control(list(pair), pipe.tokenizer, s, cfg, device=pipe.device)
                               for pair, cfg in zip(prompt_pairs, cfgs)])
    return _edit(pipe, prompt_pairs, latents, ctrl, guidance_scale, uncond_seqs, source_replays)


def masactrl_edit_batch(
    pipe,
    prompt_pairs: Sequence[Sequence[str]],
    latents: torch.Tensor,  # (G, 1, h, w, 4)
    cfg: Optional[MasaCtrlConfig] = None,
    guidance_scale: float = 7.5,
    uncond_seqs: Optional[torch.Tensor] = None,
    source_replays: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """MasaCtrl-edit G images in one batch: the gate is a (steps, layers)
    table of the config alone, so one control (mutual, or union with
    ``cfg.mode == "union"``) serves the group. Returns (G, 2, H, W, 3)
    uint8 [reconstruction, edit]."""
    cfg = cfg or default_masactrl_config(pipe)
    with phase("control"):
        ctrl = ctl.build_masactrl_control(pipe.scheduler.num_steps, pipe.unet.config.num_transformer_blocks, cfg,
                                          device=pipe.device)
    return _edit(pipe, prompt_pairs, latents, ctrl, guidance_scale, uncond_seqs, source_replays)


def pnp_edit_batch(
    pipe,
    prompt_pairs: Sequence[Sequence[str]],
    latents: torch.Tensor,  # (G, 1, h, w, 4)
    cfg: Optional[PnPConfig] = None,
    guidance_scale: float = 7.5,
    uncond_seqs: Optional[torch.Tensor] = None,
    source_replays: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """Plug-and-Play-edit G images in one batch (the injection gates are
    step tables: one control serves the group, each image's targets taking
    its own source's features)."""
    cfg = cfg or PnPConfig()
    sites = model_configs.pnp_sites_xl if pipe.model_type == "xl" else model_configs.pnp_sites_sd
    attn_layers, conv_keys = sites(pipe.unet.config)
    with phase("control"):
        ctrl = ctl.build_pnp_control(pipe.scheduler.num_steps, cfg, attn_layers, conv_keys, device=pipe.device)
    return _edit(pipe, prompt_pairs, latents, ctrl, guidance_scale, uncond_seqs, source_replays)


def p2z_edit_batch(
    pipe,
    prompt_pairs: Sequence[Sequence[str]],
    latents: torch.Tensor,  # (G, 1, h, w, 4)
    cfg: Optional[P2ZConfig] = None,
    guidance_scale: float = 7.5,
    uncond_seqs: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """pix2pix-zero for G images in one batch: pass 1 records each image's
    references (or, with ``recompute_refs``, the XL default, only its UNet
    input latents), pass 2 guides each image by its own loss and gradient.
    Returns (G, 2, H, W, 3) uint8 [reconstruction, edit]."""
    cfg = cfg or P2ZConfig(recompute_refs=pipe.model_type == "xl")
    ctx_srcs, added_s = _encode_pairs(pipe, [[pair[0]] for pair in prompt_pairs], latents)
    ctx_tgts, added_t = _encode_pairs(pipe, [[pair[1]] for pair in prompt_pairs], latents)
    recompute = cfg.recompute_refs
    final_src, refs, traj = _denoise_scan(
        pipe.unet, pipe.scheduler, latents, ctx_srcs, ctl.NoneControl() if recompute else ctl.P2ZControl(),
        guidance_scale, None, None, uncond_seqs, None, added_s, collect_records=not recompute,
        collect_trajectory=recompute)
    final_tgt, _ = _guided_scan_group(
        common.grad_unet(pipe, latents.shape[-3], cfg.remat_grad), pipe.scheduler, latents, ctx_tgts, refs,
        guidance_scale, cfg.guidance_amount, added_t, uncond_seqs, traj, ctx_srcs if recompute else None,
        added_s if recompute else None)
    del refs  # the recorded maps go before the decode
    return _decode_pairs(pipe, torch.cat([final_src, final_tgt], dim=1))


def edit_batch(
    method: str,
    pipe,
    prompt_pairs,
    latents: torch.Tensor,
    cfg=None,
    guidance_scale: float = 7.5,
    uncond_seqs: Optional[torch.Tensor] = None,
    source_replays: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """A batched edit by any of the four methods: the one method -> editor
    map of the sweep and the service. ``cfg`` is the method's config; for
    p2p it may be a list, one per image. ``source_replays`` (direct
    inversion) applies to every method but p2z, which ignores it as the
    serial dispatcher does (``cli.run_method``)."""
    with phase("edit", sync=True, allocs=True):
        if method == "p2p":
            cfgs = list(cfg) if isinstance(cfg, (list, tuple)) else None if cfg is None else [cfg] * len(prompt_pairs)
            return p2p_edit_batch(pipe, prompt_pairs, latents, cfgs, guidance_scale, uncond_seqs, source_replays)
        if method == "p2z":
            return p2z_edit_batch(pipe, prompt_pairs, latents, cfg, guidance_scale, uncond_seqs)
        fn = {"masactrl": masactrl_edit_batch, "pnp": pnp_edit_batch}.get(method)
        if fn is None:
            raise ValueError(f"unknown method {method}")
        return fn(pipe, prompt_pairs, latents, cfg, guidance_scale, uncond_seqs, source_replays)


def _xl_added(pipe, added, g: int, h: int, w: int, uncond: bool = False):
    """Per-image batch-1 XL added conditions (G, 1, ...) of a G-prompt
    encode, with the negative pooled embeds as ``uncond_text_embeds`` if
    asked (NTI's unconditional branch, masactrl/inversion/nti.py:59,75)."""
    tids = pipe.add_time_ids(h, w, 1)  # (1, n_ids)
    out = {"text_embeds": added["text_embeds"][g:, None], "time_ids": tids[None].expand((g,) + tuple(tids.shape))}
    if uncond:
        out["uncond_text_embeds"] = added["text_embeds"][:g, None]
    return out


def ddim_invert_batch(pipe, latents: torch.Tensor, prompts: Sequence[str], return_trajectory: bool = False):
    """Invert G images (G, 1, h, w, 4) under their source prompts in one
    batch: the last latents (G, 1, h, w, 4) and, if asked, the trajectories
    (G, S+1, 1, h, w, 4)."""
    with phase("invert", sync=True, allocs=True):
        g = len(prompts)
        context, added = pipe.encode_prompts(list(prompts))
        added_cond = None
        if pipe.model_type == "xl":
            added_cond = {k: v[:, 0] for k, v in
                          _xl_added(pipe, added, g, latents.shape[-3] * 8, latents.shape[-2] * 8).items()}
        last, traj = _invert_scan(pipe.unet, pipe.scheduler, latents[:, 0], context[g:], added_cond)
        last = last[:, None]
        if return_trajectory:
            return last, traj.transpose(0, 1)[:, :, None]
        return last


def nti_batch(pipe, trajectories: torch.Tensor, prompts: Sequence[str], cfg: Optional[NTIConfig] = None,
              guidance_scale: float = 7.5, return_stops: bool = False):
    """Null-text inversion of a group in one batch
    (``null_text_inversion_batch``); returns (G, S, 77, D) f32, and with
    ``return_stops`` each image's inner iterations at each step (S, G)."""
    g = len(prompts)
    emb, added = pipe.encode_prompts(list(prompts))  # (2G, 77, D): [uncond, cond]
    contexts = torch.stack([emb[:g], emb[g:]], dim=1)  # (G, 2, 77, D)
    added_conds = None
    if pipe.model_type == "xl":
        added_conds = _xl_added(pipe, added, g, trajectories.shape[-3] * 8, trajectories.shape[-2] * 8,
                                uncond=True)
    return null_text_inversion_batch(pipe, trajectories, contexts, cfg or NTIConfig(),
                                     guidance_scale=guidance_scale, added_conds=added_conds,
                                     return_stops=return_stops)


def nti_group_serial(pipe, trajectories: torch.Tensor, prompts: Sequence[str], cfg: Optional[NTIConfig] = None,
                     guidance_scale: float = 7.5) -> torch.Tensor:
    """Null-text inversion of a group image by image over a batched
    inversion's trajectories: each image stops at its own inner iteration,
    where the batch iterates to its slowest image's (the JAX sweep's and
    service's choice, batched.py:393-405). Returns (G, S, 77, D) f32."""
    g = len(prompts)
    emb, added = pipe.encode_prompts(list(prompts))  # (2G, 77, D)
    xl = None
    if pipe.model_type == "xl":
        xl = _xl_added(pipe, added, g, trajectories.shape[-3] * 8, trajectories.shape[-2] * 8, uncond=True)
    out = []
    for i in range(g):
        added_cond = None if xl is None else {k: v[i] for k, v in xl.items()}
        out.append(null_text_inversion(pipe, trajectories[i], torch.stack([emb[i], emb[g + i]]), cfg or NTIConfig(),
                                       guidance_scale=guidance_scale, added_cond=added_cond))
    return torch.stack(out)

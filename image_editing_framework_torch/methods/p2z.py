"""pix2pix-zero editor (cross-attention-map guidance).

Counterpart of ``image_editing_framework_tpu/methods/p2z.py`` (reference:
pix2pix-zero/model/sd_utils.py, P2P_Zero.__call__). Two passes:

1. Denoise with the *source* prompt, recording every cross-attention
   probability map per step in bf16 (``P2ZControl``), or, with
   ``recompute_refs``, only the UNet input latent of each step.
2. Denoise again from the same latent with the *target* prompt. Each step
   takes one SGD step on the CFG-doubled latent input ``x_in``, minimising
   the L2 distance of the current cross-attention maps to the recorded
   ones (sd_utils.py:157-174), then computes the noise on the updated
   input, whose two halves now differ, and continues from its first half.

The gradient is ``torch.autograd.grad`` of the loss with respect to
``x_in``, a leaf that asks for a gradient while the modules stay frozen.
It reaches ``x_in`` through every cross-attention site (plain torch on f32
probabilities) and through every self-attention site upstream of one, the
first included, where the flash kernel's autograd Function runs the
backward kernels. At XL 1024² the UNet is taken with its transformer
blocks checkpointed (``methods/common.py grad_unet``).

A group of images runs both passes in one batch (``_guided_scan_group``,
``eval/batched.py p2z_edit_batch``): each image gets its own loss, its own
gradient and its own SGD step, because the images' losses are summed. The
serial functions are the group functions on a group of 1.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from image_editing_framework_torch.core.config import P2ZConfig, SamplerConfig
from image_editing_framework_torch.core.scheduler import DDIMSchedule, ddim_step
from image_editing_framework_torch.methods import common
from image_editing_framework_torch.methods.base import _group_context, _group_of_one, denoise, flat, flat_added
from image_editing_framework_torch.ops.controls import P2ZControl, P2ZStep
from image_editing_framework_torch.utils.profiling import phase

Records = Dict[str, torch.Tensor]


def attention_losses(rec: Records, ref: Records, group: int = 1) -> torch.Tensor:
    """(G,) f32 loss of each image of a group: the sum over sites of the
    squared distance of its maps to its references, summed over (N, 77) and
    averaged over its batch rows and heads (pix2pix-zero/model/sd_utils.py:
    166-172; JAX ``attn_loss``). Maps are (G·2, H, N, 77), image-major."""
    loss = 0.0
    for k, cur in rec.items():
        d = cur.float() - ref[k].float()
        loss = loss + d.square().sum(dim=(2, 3)).reshape(group, -1).mean(dim=1)
    return loss


def guidance_gradient_group(
    unet, x_in: torch.Tensor, t: int, context: torch.Tensor, ref: Records,
    added_cond: Optional[Dict[str, torch.Tensor]] = None, group: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each image's loss (G,), d loss / d x_in) of one guided step of a
    group at timestep ``t``: ``x_in`` (G·2, h, w, 4), the references ``ref``
    per cross site (G·2, H, N, 77). The images' losses are summed, never
    averaged, so that each image's rows get its own loss's gradient."""
    x_in = x_in.detach().requires_grad_(True)
    with torch.enable_grad():
        _, rec = unet(x_in, t, context, P2ZStep(), added_cond)
        losses = attention_losses(rec, ref, group)
        with phase("backward"):
            (g,) = torch.autograd.grad(losses.sum(), x_in)
    return losses.detach(), g


def guidance_gradient(
    unet, x_in: torch.Tensor, t: int, context: torch.Tensor, ref: Records,
    added_cond: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, d loss / d x_in) of one guided step at timestep ``t``:
    ``x_in`` (2, h, w, 4), the references ``ref`` per cross site (2, H, N,
    77)."""
    losses, g = guidance_gradient_group(unet, x_in, t, context, ref, added_cond)
    return losses[0], g


@torch.no_grad()
def source_records_group(
    unet, sched: DDIMSchedule, i: int, src_trajs: torch.Tensor, ctx_srcs: torch.Tensor,
    uncond_seqs: Optional[torch.Tensor] = None, added_srcs: Optional[Dict[str, torch.Tensor]] = None,
) -> Records:
    """Pass 1's records of step i made again for a group (``recompute_refs``):
    its forward on the stored UNet input latents ``src_trajs[i]`` (G, 1, h,
    w, 4) under the source contexts (G, 2, 77, D), the NTI swap included, so
    the same inputs give the same maps."""
    lat = src_trajs[i]
    _, ref = unet(flat(torch.cat([lat, lat], dim=1)), int(sched.timesteps[i]),
                  flat(_group_context(ctx_srcs, uncond_seqs, i)), P2ZStep(), flat_added(added_srcs))
    return ref


def source_records(
    unet, sched: DDIMSchedule, i: int, src_traj: torch.Tensor, ctx_src: torch.Tensor,
    uncond_seq: Optional[torch.Tensor] = None, added_src: Optional[Dict[str, torch.Tensor]] = None,
) -> Records:
    """``source_records_group`` of one image: ``src_traj`` (S, 1, h, w, 4),
    ``ctx_src`` (2, 77, D)."""
    return source_records_group(unet, sched, i, src_traj[:, None], ctx_src[None],
                                None if uncond_seq is None else uncond_seq[None], _group_of_one(added_src))


@torch.no_grad()
def guided_step_group(
    unet, sched: DDIMSchedule, i: int, lat: torch.Tensor, contexts: torch.Tensor, ref: Records,
    guidance_scale: float, guidance_amount: float, added_conds: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of pass 2 at step index i for a group, from the (G, 1, h, w,
    4) latents ``lat``: per image an SGD step of size ``guidance_amount`` on
    ``x_in = [lat, lat]`` against its references ``ref``, the noise on the
    updated pair, whose halves now differ, and the guided DDIM step from its
    first half; one UNet call for the gradient and one for the noise at
    batch G·2. Returns (the next latents, each image's loss (G,))."""
    # the step size in the latent's dtype, as the JAX package casts it
    # (p2z.py:179): bf16 0.1 is 0.10009765625
    lr = float(torch.tensor(guidance_amount, dtype=lat.dtype))
    t = int(sched.timesteps[i])
    g = lat.shape[0]
    x_in = flat(torch.cat([lat, lat], dim=1))
    ctx, added = flat(contexts), flat_added(added_conds)
    losses, grad = guidance_gradient_group(unet, x_in, t, ctx, ref, added, g)
    x_in = (x_in - lr * grad).reshape((g, 2) + tuple(x_in.shape[1:]))
    eps, _ = unet(flat(x_in), t, ctx, None, added)
    eps_u, eps_c = eps.reshape(x_in.shape).chunk(2, dim=1)
    # reference: latents = x_in.chunk(2)[0] (sd_utils.py:180)
    return ddim_step(sched, eps_u + guidance_scale * (eps_c - eps_u), i, x_in[:, :1]), losses


def guided_step(
    unet, sched: DDIMSchedule, i: int, lat: torch.Tensor, context: torch.Tensor, ref: Records,
    guidance_scale: float, guidance_amount: float, added_cond: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``guided_step_group`` of one image, from the (1, h, w, 4) latent
    ``lat`` with the (2, 77, D) ``context``. Returns (the next latent, the
    loss)."""
    nxt, losses = guided_step_group(unet, sched, i, lat[None], context[None], ref, guidance_scale, guidance_amount,
                                    _group_of_one(added_cond))
    return nxt[0], losses[0]


@torch.no_grad()
def _guided_scan_group(
    unet,
    sched: DDIMSchedule,
    latents0: torch.Tensor,  # (G, 1, h, w, 4)
    contexts: torch.Tensor,  # (G, 2, 77, D) [uncond, cond(target)] per image
    refs: Optional[Records],  # per site (S, G·2, H, N, 77) maps, or None with src_trajs
    guidance_scale: float,
    guidance_amount: float,
    added_conds: Optional[Dict[str, torch.Tensor]] = None,  # dict of (G, 2, ...)
    uncond_seqs: Optional[torch.Tensor] = None,  # (G, S, 77, D) NTI embeddings
    src_trajs: Optional[torch.Tensor] = None,  # (S, G, 1, h, w, 4) pass-1 UNet input latents
    ctx_srcs: Optional[torch.Tensor] = None,  # (G, 2, 77, D) source-prompt contexts
    added_srcs: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 for a group. Returns the final (G, 1, h, w, 4) latents and the
    (S, G) f32 loss of each step and image, on the latents' device. Without
    ``refs`` each step makes its references again from ``src_trajs``
    (``source_records_group``)."""
    lat, losses = latents0, []
    with phase("pass2"):
        for i in range(sched.num_steps):
            with phase("step"):
                if refs is not None:
                    ref = {k: v[i] for k, v in refs.items()}
                else:
                    ref = source_records_group(unet, sched, i, src_trajs, ctx_srcs, uncond_seqs, added_srcs)
                lat, loss = guided_step_group(unet, sched, i, lat, _group_context(contexts, uncond_seqs, i), ref,
                                              guidance_scale, guidance_amount, added_conds)
                losses.append(loss)
    return lat, torch.stack(losses)


def _guided_scan(
    unet,
    sched: DDIMSchedule,
    latents0: torch.Tensor,  # (1, h, w, 4)
    context: torch.Tensor,  # (2, 77, D) [uncond, cond(target)]
    refs: Optional[Records],  # per site (S, 2, H, N, 77) maps, or None with src_traj
    guidance_scale: float,
    guidance_amount: float,
    added_cond: Optional[Dict[str, torch.Tensor]] = None,
    uncond_seq: Optional[torch.Tensor] = None,  # (S, 77, D) NTI embeddings
    src_traj: Optional[torch.Tensor] = None,  # (S, 1, h, w, 4) pass-1 UNet input latents
    ctx_src: Optional[torch.Tensor] = None,  # (2, 77, D) source-prompt context
    added_src: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 of one image (``_guided_scan_group`` of a group of 1). Returns
    the final (1, h, w, 4) latent and the (S,) f32 loss of each step."""
    lat, losses = _guided_scan_group(
        unet, sched, latents0[None], context[None], refs, guidance_scale, guidance_amount, _group_of_one(added_cond),
        None if uncond_seq is None else uncond_seq[None], None if src_traj is None else src_traj[:, None],
        None if ctx_src is None else ctx_src[None], _group_of_one(added_src))
    return lat[0], losses[:, 0]


def p2z_edit(
    pipe,
    prompts: Sequence[str],  # [source_prompt, target_prompt]
    latent: torch.Tensor,  # (1, h, w, 4) initial latent
    cfg: P2ZConfig = P2ZConfig(),
    sampler: SamplerConfig = SamplerConfig(),
    edit_dir: Optional[torch.Tensor] = None,  # (77, D) added to the target context
    uncond_seq: Optional[torch.Tensor] = None,  # (S, 77, D) NTI embeddings
    only_sample: bool = False,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (reconstruction image, edited image), uint8 (1, H, W, 3)
    each; the edited image is None with ``only_sample`` (pass 1 alone)."""
    if len(prompts) != 2:
        raise ValueError(f"pix2pix-zero edits one (source, target) prompt pair, got {len(prompts)} prompts")
    ctx_src, added_src = common.prepare_conditioning(pipe, [prompts[0]], sampler.height, sampler.width)
    refs = src_traj = None
    if cfg.recompute_refs:
        final_src, _, src_traj = denoise(pipe, latent, ctx_src, None, guidance_scale=sampler.guidance_scale,
                                         uncond_seq=uncond_seq, added_cond=added_src, collect_trajectory=True)
    else:
        final_src, refs, _ = denoise(pipe, latent, ctx_src, P2ZControl(), guidance_scale=sampler.guidance_scale,
                                     uncond_seq=uncond_seq, added_cond=added_src, collect_records=True)
    if only_sample:
        return pipe.latent2image(final_src), None

    ctx_tgt, added_tgt = common.prepare_conditioning(pipe, [prompts[1]], sampler.height, sampler.width)
    if edit_dir is not None:
        ctx_tgt = ctx_tgt + edit_dir
    final, _ = _guided_scan(
        common.grad_unet(pipe, latent.shape[1], cfg.remat_grad), pipe.scheduler, latent, ctx_tgt, refs,
        sampler.guidance_scale, cfg.guidance_amount, added_tgt, uncond_seq, src_traj,
        ctx_src if cfg.recompute_refs else None, added_src if cfg.recompute_refs else None,
    )
    del refs  # the recorded maps (3.3 GB at SD1.5 512²) go before the decodes
    return pipe.latent2image(final_src), pipe.latent2image(final)

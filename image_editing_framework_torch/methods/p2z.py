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
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from image_editing_framework_torch.core.config import P2ZConfig, SamplerConfig
from image_editing_framework_torch.core.scheduler import DDIMSchedule, ddim_step
from image_editing_framework_torch.methods import common
from image_editing_framework_torch.methods.base import _step_context, denoise
from image_editing_framework_torch.ops.controls import P2ZControl, P2ZStep

Records = Dict[str, torch.Tensor]


def attention_loss(rec: Records, ref: Records) -> torch.Tensor:
    """Sum over sites of the squared distance of the maps to the references,
    summed over (N, 77) and averaged over batch and heads, in f32
    (pix2pix-zero/model/sd_utils.py:166-172; JAX ``attn_loss``)."""
    loss = 0.0
    for k, cur in rec.items():
        d = cur.float() - ref[k].float()
        loss = loss + d.square().sum(dim=(2, 3)).mean()
    return loss


def guidance_gradient(
    unet, x_in: torch.Tensor, t: int, context: torch.Tensor, ref: Records,
    added_cond: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, d loss / d x_in) of one guided step at timestep ``t``:
    ``x_in`` (2, h, w, 4), the references ``ref`` per cross site (2, H, N,
    77)."""
    x_in = x_in.detach().requires_grad_(True)
    with torch.enable_grad():
        _, rec = unet(x_in, t, context, P2ZStep(), added_cond)
        loss = attention_loss(rec, ref)
        (g,) = torch.autograd.grad(loss, x_in)
    return loss.detach(), g


@torch.no_grad()
def source_records(
    unet, sched: DDIMSchedule, i: int, src_traj: torch.Tensor, ctx_src: torch.Tensor,
    uncond_seq: Optional[torch.Tensor] = None, added_src: Optional[Dict[str, torch.Tensor]] = None,
) -> Records:
    """Pass 1's records of step i made again (``recompute_refs``): its
    forward on its stored UNet input latent ``src_traj[i]`` under the source
    context, the NTI swap included, so the same inputs give the same maps."""
    _, ref = unet(torch.cat([src_traj[i], src_traj[i]]), int(sched.timesteps[i]),
                  _step_context(ctx_src, uncond_seq, i), P2ZStep(), added_src)
    return ref


@torch.no_grad()
def guided_step(
    unet, sched: DDIMSchedule, i: int, lat: torch.Tensor, context: torch.Tensor, ref: Records,
    guidance_scale: float, guidance_amount: float, added_cond: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of pass 2 at step index i from the (1, h, w, 4) latent
    ``lat``: an SGD step of size ``guidance_amount`` on ``x_in = [lat,
    lat]`` against the references ``ref``, the noise on the updated pair,
    whose halves now differ, and the guided DDIM step from its first half.
    Returns (the next latent, the loss)."""
    # the step size in the latent's dtype, as the JAX package casts it
    # (p2z.py:179): bf16 0.1 is 0.10009765625
    lr = float(torch.tensor(guidance_amount, dtype=lat.dtype))
    t = int(sched.timesteps[i])
    x_in = torch.cat([lat, lat])
    loss, g = guidance_gradient(unet, x_in, t, context, ref, added_cond)
    x_in = x_in - lr * g
    eps, _ = unet(x_in, t, context, None, added_cond)
    eps_u, eps_c = eps.chunk(2)
    # reference: latents = x_in.chunk(2)[0] (sd_utils.py:180)
    return ddim_step(sched, eps_u + guidance_scale * (eps_c - eps_u), i, x_in[:1]), loss


@torch.no_grad()
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
    """Pass 2. Returns the final (1, h, w, 4) latent and the (S,) f32 loss of
    each step, on the latent's device. Without ``refs`` each step makes its
    references again from ``src_traj`` (``source_records``)."""
    lat, losses = latents0, []
    for i in range(sched.num_steps):
        if refs is not None:
            ref = {k: v[i] for k, v in refs.items()}
        else:
            ref = source_records(unet, sched, i, src_traj, ctx_src, uncond_seq, added_src)
        lat, loss = guided_step(unet, sched, i, lat, _step_context(context, uncond_seq, i), ref, guidance_scale,
                                guidance_amount, added_cond)
        losses.append(loss)
    return lat, torch.stack(losses)


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

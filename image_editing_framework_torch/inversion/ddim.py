"""DDIM inversion as a loop over steps.

Counterpart of ``image_editing_framework_tpu/inversion/ddim.py``. Matches the
reference loop (p2p/inversion/ddim.py:21-32): S conditional-only UNet
evaluations walking timesteps in ascending order, collecting the full latent
trajectory (S+1 latents including the input). On the card the UNet's
forward is replayed as CUDA graphs where its inputs allow them
(``inversion/graphs.py``); the DDIM update stays an eager call through this
module's ``ddim_reverse_step`` every step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from image_editing_framework_torch.core.scheduler import DDIMSchedule, ddim_reverse_step, inversion_timestep
from image_editing_framework_torch.inversion import graphs
from image_editing_framework_torch.utils.profiling import phase


@torch.no_grad()
def _invert_scan(unet, sched: DDIMSchedule, latent: torch.Tensor, cond_context: torch.Tensor, added_cond=None):
    """latent (B, h, w, 4), cond_context (B, 77, D) -> (last, trajectory (S+1, B, h, w, 4))."""
    forward = graphs.forward_for(unet, latent, cond_context, added_cond)
    lat = latent
    traj = [latent]
    for i in range(sched.num_steps):
        with phase("step"):
            eps = forward(lat, inversion_timestep(sched, i))
            lat = ddim_reverse_step(sched, eps, i, lat)
            traj.append(lat)
    return lat, torch.stack(traj)


def ddim_invert(
    pipe, latent: torch.Tensor, prompt: str
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[dict]]:
    """Invert a latent under a source prompt.

    Returns (final_noised_latent, trajectory (S+1,B,...), context (2,77,D),
    added_cond) — the context includes the uncond half for downstream NTI,
    mirroring the reference's get_context (p2p/inversion/ddim.py:43-57).
    ``added_cond`` is the batch-1 conditioning the inversion itself used
    (text_embeds + time_ids for XL, None for SD), which callers hand straight
    to null_text_inversion. For XL it also carries ``uncond_text_embeds``
    (the negative pooled embeds): NTI evaluates its unconditional branch
    with those (masactrl/inversion/nti.py:59,75); the inversion is
    conditional-only and does not see the extra key.
    """
    context, added = pipe.encode_prompts([prompt])
    added_cond = None
    if pipe.model_type == "xl":
        h, w = latent.shape[1] * 8, latent.shape[2] * 8
        added_cond = {"text_embeds": added["text_embeds"][1:], "time_ids": pipe.add_time_ids(h, w, 1)}
    last, traj = _invert_scan(pipe.unet, pipe.scheduler, latent, context[1:], added_cond)
    if added_cond is not None:
        added_cond = dict(added_cond, uncond_text_embeds=added["text_embeds"][:1])
    return last, traj, context, added_cond

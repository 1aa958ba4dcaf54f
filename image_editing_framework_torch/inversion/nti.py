"""Null-text inversion.

Counterpart of ``image_editing_framework_tpu/inversion/nti.py``
(``null_text_inversion:196``, ``_nti_scan:44``). Reference:
p2p/inversion/nti.py:9-45. Per denoising step, Adam-optimise the
unconditional embedding so that the guided DDIM step from the current latent
lands on the recorded inversion-trajectory latent; stop early once the loss
is below ``epsilon + i * 2e-5``; then advance the latent with the optimised
embedding. The data-dependent inner loop is a Python loop with one
``loss.item()`` per iteration, the early-stop test.

Adam is written out (bias-corrected, beta = (0.9, 0.999), eps = 1e-8, state
fresh each step) because the learning rate is a function of the step index
(``base_lr * (1 - i / span)``, p2p/inversion/nti.py:17). Scalars are formed
in f32, as JAX forms them.

The SD variant carries the optimised embedding into the next step
(nti.py:15 reuses the loop variable); ``reset_each_step`` restarts every step
from the original embedding, as SDXL's variant does (nti.py:61). The batched
variant (``null_text_inversion_batch``) arrives with the batched-evaluation
slice.

XL added conditions (masactrl/inversion/nti.py:58-66): the conditional UNet
evaluation takes the prompt's pooled embeds, every unconditional evaluation
the negative pooled embeds; the time ids are shared. ``ddim_invert`` returns
one dict with the extra key ``uncond_text_embeds``; ``_split_added`` makes
the pair from it.

Gradients reach the embedding through the UNet's cross-attention (plain
torch) and through every self-attention site downstream of the first
cross-attention, where the flash kernel's autograd Function runs the
backward kernels. The modules stay frozen, so the embedding is the only
leaf that asks for a gradient. At XL 1024² the UNet is taken with its
transformer blocks checkpointed (``methods/common.py grad_unet``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from image_editing_framework_torch.core.config import NTIConfig
from image_editing_framework_torch.core.scheduler import DDIMSchedule, ddim_step
from image_editing_framework_torch.methods.common import grad_unet

Added = Optional[Dict[str, torch.Tensor]]

_F32 = np.float32


def _cfg_mix(eps_u: torch.Tensor, eps_c: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    """``eps_u + gs * (eps_c - eps_u)`` with JAX's type promotion: the
    difference in the UNet's dtype, the guided sum in f32 (``guidance_scale``
    is a strongly typed f32 array there). A Python float times a bf16 tensor
    would keep the whole mix in bf16."""
    return eps_u.float() + guidance_scale * (eps_c - eps_u).float()


def nti_loss(
    unet,
    sched: DDIMSchedule,
    i: int,
    latent: torch.Tensor,
    target: torch.Tensor,
    eps_c: torch.Tensor,
    uncond: torch.Tensor,
    guidance_scale: float,
    added_uncond: Added = None,
) -> torch.Tensor:
    """Step i's loss (JAX ``loss_fn``, nti.py:86-90): the mean squared
    distance of the guided DDIM step from ``latent`` to ``target``, with
    ``uncond`` as the unconditional embedding (and ``added_uncond`` its XL
    added conditions) and ``eps_c`` the conditional noise prediction."""
    eps_u = unet(latent, int(sched.timesteps[i]), uncond, None, added_uncond)[0]
    prev = ddim_step(sched, _cfg_mix(eps_u, eps_c, guidance_scale), i, latent)
    return torch.mean((prev - target) ** 2)


def _nti_loop(
    unet,
    sched: DDIMSchedule,
    trajectory: torch.Tensor,  # (S+1, 1, h, w, 4)
    cond_emb: torch.Tensor,  # (1, 77, D)
    uncond0: torch.Tensor,  # (1, 77, D)
    guidance_scale: float,
    cfg: NTIConfig,
    reset_each_step: bool,
    added_cond: Added = None,
    added_uncond: Added = None,
) -> torch.Tensor:
    """The per-step optimisation (JAX ``_nti_scan``); returns (S, 77, D) f32."""
    s = sched.num_steps
    if added_uncond is None:
        added_uncond = added_cond
    # NTI optimises in f32 whatever the pipeline's dtype (the reference
    # optimises an f32 embedding against f32 latents); the UNet casts its
    # inputs to its own dtype.
    uncond0 = uncond0.float()
    cond_emb = cond_emb.float()
    trajectory = trajectory.float()
    gs = float(_F32(guidance_scale))
    latent_cur, u_carry = trajectory[-1], uncond0
    seq = []
    for i in range(s):
        target = trajectory[s - 1 - i]
        t = int(sched.timesteps[i])
        lr = float(_F32(cfg.base_lr) * (_F32(1.0) - _F32(i) / _F32(cfg.lr_decay_span)))
        thresh = float(_F32(cfg.epsilon) + _F32(i) * _F32(2e-5))
        with torch.no_grad():
            eps_c = unet(latent_cur, t, cond_emb, None, added_cond)[0]

        def loss_and_grad(u):
            u = u.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = nti_loss(unet, sched, i, latent_cur, target, eps_c, u, gs, added_uncond)
                (g,) = torch.autograd.grad(loss, u)
            return loss.detach(), g

        u = uncond0 if reset_each_step else u_carry
        m, v = torch.zeros_like(u), torch.zeros_like(u)
        j, loss = 0, float("inf")
        # The reference's order: take the step, then stop if the loss taken
        # before it was small enough (JAX while_loop cond/body, nti.py:95-107).
        while j < cfg.num_inner_steps and loss >= thresh:
            loss_t, g = loss_and_grad(u)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * torch.square(g)
            mh = m / float(_F32(1.0) - _F32(0.9) ** _F32(j + 1))
            vh = v / float(_F32(1.0) - _F32(0.999) ** _F32(j + 1))
            u = u - lr * mh / (torch.sqrt(vh) + 1e-8)
            j += 1
            loss = loss_t.item()
        null_text_inversion.inner_iterations += j

        # Advance the latent with the optimised embedding (nti.py:37-43).
        with torch.no_grad():
            eps_u = unet(latent_cur, t, u, None, added_uncond)[0]
            latent_cur = ddim_step(sched, _cfg_mix(eps_u, eps_c, gs), i, latent_cur)
        u_carry = u
        seq.append(u[0])
    return torch.stack(seq)


def _split_added(added_cond: Added) -> Tuple[Added, Added]:
    """Split an added-cond dict carrying ``uncond_text_embeds`` into the
    (cond, uncond) pair the XL NTI evaluates its two branches with
    (masactrl/inversion/nti.py:58-59; the time ids are shared, :57)."""
    if added_cond is None or "uncond_text_embeds" not in added_cond:
        return added_cond, None
    cond = {"text_embeds": added_cond["text_embeds"], "time_ids": added_cond["time_ids"]}
    uncond = {"text_embeds": added_cond["uncond_text_embeds"], "time_ids": added_cond["time_ids"]}
    return cond, uncond


def null_text_inversion(
    pipe,
    trajectory: torch.Tensor,  # (S+1, 1, h, w, 4) from ddim_invert
    context: torch.Tensor,  # (2, 77, D) [uncond, cond]
    cfg: NTIConfig = NTIConfig(),
    guidance_scale: float = 7.5,
    added_cond: Added = None,
) -> torch.Tensor:
    """Returns the per-step optimised unconditional embeddings (S, 77, D) f32.
    ``added_cond``: XL's batch-1 added conditions, as ``ddim_invert`` returns
    them."""
    added_cond, added_uncond = _split_added(added_cond)
    unet = grad_unet(pipe, trajectory.shape[-3], cfg.remat)
    return _nti_loop(unet, pipe.scheduler, trajectory, context[1:], context[:1], guidance_scale, cfg,
                     reset_each_step=pipe.model_type == "xl", added_cond=added_cond, added_uncond=added_uncond)


# Inner Adam iterations run since the count was last set to 0.
null_text_inversion.inner_iterations = 0

"""Null-text inversion.

Counterpart of ``image_editing_framework_tpu/inversion/nti.py``
(``null_text_inversion:196``, ``_nti_scan:44``). Reference:
p2p/inversion/nti.py:9-45. Per denoising step, Adam-optimise the
unconditional embedding so that the guided DDIM step from the current latent
lands on the recorded inversion-trajectory latent; stop early once the loss
is below ``epsilon + i * 2e-5``; then advance the latent with the optimised
embedding. The data-dependent inner loop is a Python loop that reads the
loss once per iteration, the early-stop test.

Adam is written out (bias-corrected, beta = (0.9, 0.999), eps = 1e-8, state
fresh each step) because the learning rate is a function of the step index
(``base_lr * (1 - i / span)``, p2p/inversion/nti.py:17). Scalars are formed
in f32, as JAX forms them.

The SD variant carries the optimised embedding into the next step
(nti.py:15 reuses the loop variable); ``reset_each_step`` restarts every step
from the original embedding, as SDXL's variant does (nti.py:61).

``null_text_inversion_batch`` optimises a group of images in one batch: one
UNet forward and backward per inner iteration for the whole group, one host
read of the (G,) loss vector per iteration. Images that have stopped stay in
the batch, frozen, rather than leave it: the batch keeps one shape, so each
iteration is the same kernels at the same batch, and the masked update is
what JAX's batched ``while_loop`` does. The cost is the group's slowest
image's iterations at every step. ``null_text_inversion`` is a group of 1.

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
from image_editing_framework_torch.methods.base import _group_of_one, flat, flat_added
from image_editing_framework_torch.methods.common import grad_unet
from image_editing_framework_torch.parallel.ring_attention import lockstep

Added = Optional[Dict[str, torch.Tensor]]

_F32 = np.float32


def _cfg_mix(eps_u: torch.Tensor, eps_c: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    """``eps_u + gs * (eps_c - eps_u)`` with JAX's type promotion: the
    difference in the UNet's dtype, the guided sum in f32 (``guidance_scale``
    is a strongly typed f32 array there). A Python float times a bf16 tensor
    would keep the whole mix in bf16."""
    return eps_u.float() + guidance_scale * (eps_c - eps_u).float()


def nti_losses(
    unet,
    sched: DDIMSchedule,
    i: int,
    latents: torch.Tensor,
    targets: torch.Tensor,
    eps_c: torch.Tensor,
    unconds: torch.Tensor,
    guidance_scale: float,
    added_uncond: Added = None,
) -> torch.Tensor:
    """Step i's loss of each image of a group (JAX ``loss_fn``, nti.py:86-90),
    (G,): the mean squared distance of the guided DDIM step from ``latents``
    (G, h, w, 4) to ``targets``, with ``unconds`` (G, 77, D) as the
    unconditional embeddings (and ``added_uncond`` their XL added
    conditions) and ``eps_c`` the conditional noise predictions."""
    eps_u = unet(latents, int(sched.timesteps[i]), unconds, None, added_uncond)[0]
    prev = ddim_step(sched, _cfg_mix(eps_u, eps_c, guidance_scale), i, latents)
    return ((prev - targets) ** 2).mean(dim=(1, 2, 3))


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
    """``nti_losses`` of one image (batch 1), a 0-d tensor."""
    return nti_losses(unet, sched, i, latent, target, eps_c, uncond, guidance_scale, added_uncond)[0]


def _nti_loop_group(
    unet,
    sched: DDIMSchedule,
    trajectories: torch.Tensor,  # (G, S+1, 1, h, w, 4)
    cond_embs: torch.Tensor,  # (G, 1, 77, D)
    uncond0s: torch.Tensor,  # (G, 1, 77, D)
    guidance_scale: float,
    cfg: NTIConfig,
    reset_each_step: bool,
    added_conds: Added = None,  # dict of (G, 1, ...)
    added_unconds: Added = None,
    cp_mesh=None,
) -> Tuple[torch.Tensor, list]:
    """The per-step optimisation of a group of G images in one batch (JAX
    ``_nti_scan`` under ``vmap``); returns the (G, S, 77, D) f32 embeddings
    and each image's inner iterations at each step, an (S, G) list.

    Each inner iteration is one UNet forward and backward at batch G. The
    images' losses are summed, so each embedding gets its own gradient. An
    image that has stopped stays in the batch with its embedding and Adam
    state frozen, as JAX's batched ``while_loop`` freezes a finished lane; the
    loop ends when every image has stopped. The host reads the (G,) loss
    vector once per iteration. Under context or tensor parallelism
    (``cp_mesh``, the UNet's ``lockstep_mesh``) every rank takes the mesh's
    first rank's loss vector (``lockstep``), so all ranks stop at the same
    iteration."""
    s = sched.num_steps
    g = trajectories.shape[0]
    if added_unconds is None:
        added_unconds = added_conds
    added_cond, added_uncond = flat_added(added_conds), flat_added(added_unconds)
    # NTI optimises in f32 whatever the pipeline's dtype (the reference
    # optimises an f32 embedding against f32 latents); the UNet casts its
    # inputs to its own dtype.
    uncond0 = flat(uncond0s.float())
    cond_emb = flat(cond_embs.float())
    trajectories = trajectories.float()
    gs = float(_F32(guidance_scale))
    latent_cur, u_carry = flat(trajectories[:, -1]), uncond0
    seq, stops = [], []
    for i in range(s):
        target = flat(trajectories[:, s - 1 - i])
        t = int(sched.timesteps[i])
        lr = float(_F32(cfg.base_lr) * (_F32(1.0) - _F32(i) / _F32(cfg.lr_decay_span)))
        thresh = float(_F32(cfg.epsilon) + _F32(i) * _F32(2e-5))
        with torch.no_grad():
            eps_c = unet(latent_cur, t, cond_emb, None, added_cond)[0]

        def loss_and_grad(u):
            u = u.detach().requires_grad_(True)
            with torch.enable_grad():
                losses = nti_losses(unet, sched, i, latent_cur, target, eps_c, u, gs, added_uncond)
                (grad,) = torch.autograd.grad(losses.sum(), u)
            return losses.detach(), grad

        u = uncond0 if reset_each_step else u_carry
        m, v = torch.zeros_like(u), torch.zeros_like(u)
        # which images still iterate: on the device for the masked update, on
        # the host (the same decisions, from the loss vector read each
        # iteration) for the loop's end
        active = torch.ones((g, 1, 1), dtype=torch.bool, device=u.device)
        host_active, iters, j = [True] * g, [0] * g, 0
        # The reference's order: take the step, then stop if the loss taken
        # before it was small enough (JAX while_loop cond/body, nti.py:95-107).
        while j < cfg.num_inner_steps and any(host_active):
            loss_t, grad = loss_and_grad(u)
            loss_t = lockstep(loss_t, cp_mesh)
            m_next = 0.9 * m + 0.1 * grad
            v_next = 0.999 * v + 0.001 * torch.square(grad)
            mh = m_next / float(_F32(1.0) - _F32(0.9) ** _F32(j + 1))
            vh = v_next / float(_F32(1.0) - _F32(0.999) ** _F32(j + 1))
            u = torch.where(active, u - lr * mh / (torch.sqrt(vh) + 1e-8), u)
            m, v = torch.where(active, m_next, m), torch.where(active, v_next, v)
            j += 1
            active = active & (loss_t >= thresh)[:, None, None]
            losses = loss_t.tolist()
            for k in range(g):
                if host_active[k]:
                    iters[k] = j
                    host_active[k] = losses[k] >= thresh
        null_text_inversion.inner_iterations += j
        stops.append(iters)

        # Advance the latents with the optimised embeddings (nti.py:37-43).
        with torch.no_grad():
            eps_u = unet(latent_cur, t, u, None, added_uncond)[0]
            latent_cur = ddim_step(sched, _cfg_mix(eps_u, eps_c, gs), i, latent_cur)
        u_carry = u
        seq.append(u)
    return torch.stack(seq, dim=1), stops


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
    cp_mesh=None,
) -> torch.Tensor:
    """The per-step optimisation of one image (JAX ``_nti_scan``; a group of
    1); returns (S, 77, D) f32."""
    return _nti_loop_group(unet, sched, trajectory[None], cond_emb[None], uncond0[None], guidance_scale, cfg,
                           reset_each_step, _group_of_one(added_cond), _group_of_one(added_uncond),
                           cp_mesh)[0][0]


def _split_added(added_cond: Added) -> Tuple[Added, Added]:
    """Split an added-cond dict carrying ``uncond_text_embeds`` into the
    (cond, uncond) pair the XL NTI evaluates its two branches with
    (masactrl/inversion/nti.py:58-59; the time ids are shared, :57)."""
    if added_cond is None or "uncond_text_embeds" not in added_cond:
        return added_cond, None
    cond = {"text_embeds": added_cond["text_embeds"], "time_ids": added_cond["time_ids"]}
    uncond = {"text_embeds": added_cond["uncond_text_embeds"], "time_ids": added_cond["time_ids"]}
    return cond, uncond


def null_text_inversion_batch(
    pipe,
    trajectories: torch.Tensor,  # (G, S+1, 1, h, w, 4)
    contexts: torch.Tensor,  # (G, 2, 77, D) [uncond, cond] per image
    cfg: NTIConfig = NTIConfig(),
    guidance_scale: float = 7.5,
    added_conds: Added = None,  # (G, 1, ...) leaves
    return_stops: bool = False,
):
    """Optimise G images' null-text embeddings in one batch (JAX
    ``null_text_inversion_batch``, nti.py:143-197); returns (G, S, 77, D)
    f32, each image's as ``null_text_inversion`` gives it alone. Each step
    iterates until the group's slowest image has stopped; a stopped image's
    embedding is frozen. ``added_conds``: XL's per-image added conditions,
    with ``uncond_text_embeds`` (``eval/batched.py nti_batch``).
    ``return_stops``: also return each image's inner iterations at each
    step, an (S, G) list."""
    added_conds, added_unconds = _split_added(added_conds)
    unet = grad_unet(pipe, trajectories.shape[-3], cfg.remat)
    seqs, stops = _nti_loop_group(unet, pipe.scheduler, trajectories, contexts[:, 1:], contexts[:, :1],
                                  guidance_scale, cfg, reset_each_step=pipe.model_type == "xl",
                                  added_conds=added_conds, added_unconds=added_unconds,
                                  cp_mesh=pipe.unet.lockstep_mesh)
    return (seqs, stops) if return_stops else seqs


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
                     reset_each_step=pipe.model_type == "xl", added_cond=added_cond, added_uncond=added_uncond,
                     cp_mesh=pipe.unet.lockstep_mesh)


# Inner Adam iterations run since the count was last set to 0 (of a group,
# the iterations of its batch, each one UNet forward and backward).
null_text_inversion.inner_iterations = 0

"""The shared denoising loop over DDIM steps.

Counterpart of ``image_editing_framework_tpu/methods/base.py``: latents for
all P prompt branches advance together; classifier-free guidance doubles the
batch inside the step ([uncond x P, cond x P]); the editing control is sliced
per step with ``ctrl.at_step(i)``; LocalBlend sums the recorded 16x16
cross-attention maps across steps and blends after every scheduler step
(p2p/model/sd_utils.py:78 ``controller.step_callback``); on request the loop
also returns every step's records and UNet input latents (pix2pix-zero's
pass 1). The loop runs a group of images in one batch (``_denoise_scan``,
the batched editors of ``eval/batched.py``, each image with its own NTI
embeddings, direct-inversion trajectory and SDXL added conditions); the
serial editors' ``denoise`` is a group of 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from image_editing_framework_torch.core.scheduler import DDIMSchedule, ddim_step
from image_editing_framework_torch.ops.controls import NoneControl
from image_editing_framework_torch.utils.profiling import phase


@dataclasses.dataclass
class LocalBlend:
    """Word-mask latent blending (reference: p2p/model/ptp_utils.py:6-32).

    Takes the summed recorded 16x16 cross-attention maps; each step derives
    a spatial mask from the word-selected maps and blends every branch's
    latent toward the source's outside the mask.
    """

    alpha_layers: torch.Tensor  # (P, 77)
    threshold: float = 0.3

    def mask(self, x_t: torch.Tensor, store: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(P, h, w) f32 normalised word mask, before the threshold."""
        maps = torch.stack([store[k] for k in sorted(store)], dim=1)  # (P, M, 256, 77)
        p, m, n, _ = maps.shape
        side = int(n**0.5)
        masked = (maps.float() * self.alpha_layers[:, None, None, :]).sum(-1)
        masked = masked.mean(1).reshape(p, 1, side, side)
        # 3x3 max-pool, stride 1, SAME (reference: nnf.max_pool2d(k=3, pad=1)).
        pooled = F.max_pool2d(masked, 3, stride=1, padding=1)
        mask = F.interpolate(pooled, size=tuple(x_t.shape[1:3]), mode="nearest")[:, 0]
        return mask / mask.amax(dim=(1, 2), keepdim=True)

    def __call__(self, x_t: torch.Tensor, store: Dict[str, torch.Tensor]) -> torch.Tensor:
        if not store:
            return x_t
        mask = self.mask(x_t, store) > self.threshold
        union = mask.any(dim=0).to(x_t.dtype)[None, :, :, None]
        return x_t[:1] + union * (x_t - x_t[:1])


def _step_context(context: torch.Tensor, uncond_seq: Optional[torch.Tensor], i: int) -> torch.Tensor:
    """Step i's (2P, 77, D) context: the unconditional half replaced by the
    NTI embedding ``uncond_seq[i]``, broadcast to P and cast to the
    context's dtype (JAX ``methods/base.py:95-99``)."""
    if uncond_seq is None:
        return context
    return _group_context(context[None], uncond_seq[None], i)[0]


def _group_context(contexts: torch.Tensor, uncond_seqs: Optional[torch.Tensor], i: int) -> torch.Tensor:
    """``_step_context`` for each image of a group: contexts (G, 2P, 77, D),
    uncond_seqs (G, S, 77, D) or None."""
    if uncond_seqs is None:
        return contexts
    g, p2 = contexts.shape[:2]
    u = uncond_seqs[:, i, None].expand((g, p2 // 2) + tuple(contexts.shape[2:])).to(contexts.dtype)
    return torch.cat([u, contexts[:, p2 // 2:]], dim=1)


def flat(x: torch.Tensor) -> torch.Tensor:
    """(G, R, ...) -> (G·R, ...): a group's rows in the UNet's batch."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def flat_added(added: Optional[Dict[str, torch.Tensor]]) -> Optional[Dict[str, torch.Tensor]]:
    return None if added is None else {k: flat(v) for k, v in added.items()}


@torch.no_grad()
def _denoise_scan(
    unet,
    sched: DDIMSchedule,
    latents: torch.Tensor,  # (G, P, h, w, 4)
    contexts: torch.Tensor,  # (G, 2P, 77, D)
    ctrl,
    guidance_scale: float,
    blend: Optional[LocalBlend],
    store_mode: Optional[str],  # None | 'sum' (LocalBlend cross-step sum)
    uncond_seqs: Optional[torch.Tensor] = None,  # (G, S, 77, D) NTI embeddings
    source_replays: Optional[torch.Tensor] = None,  # (G, S+1, 1, h, w, 4) inversion trajectories
    added_conds: Optional[Dict[str, torch.Tensor]] = None,  # dict of (G, 2P, ...), SDXL
    collect_records: bool = False,
    collect_trajectory: bool = False,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]], Optional[torch.Tensor]]:
    """The loop over a group of G images in one batch (the batch layout of
    ``ops/controls.py``): each step makes one UNet call at batch G·2P.
    Returns (latents (G, P, h, w, 4), per site the records of every step
    (S, G·2P, ...), the UNet input latents (S, G, P, h, w, 4)). LocalBlend
    edits one image (G = 1)."""
    g, p = latents.shape[:2]
    if blend is not None and g != 1:
        raise ValueError(f"LocalBlend edits one image, got a group of {g}")
    lat = latents
    steps = sched.num_steps
    added = flat_added(added_conds)
    store: Dict[str, torch.Tensor] = {}
    # per-step outputs, written into buffers made at step 0 (no stacking copy)
    rec_ys: Optional[Dict[str, torch.Tensor]] = None
    traj_ys: Optional[torch.Tensor] = None
    with phase("pass1" if collect_records or collect_trajectory else "denoise"):
        for i in range(steps):
            with phase("step"):
                step_ctrl = ctrl.at_step(i)
                if store_mode is not None:
                    step_ctrl = step_ctrl.bind_store(store, i)
                if source_replays is not None:
                    # direct inversion: each image's source branch replays its
                    # inversion trajectory (masactrl/model/sd_utils.py:95-99)
                    lat = torch.cat([source_replays[:, steps - i].to(lat.dtype), lat[:, 1:]], dim=1)
                if collect_trajectory:
                    # the UNet input latent of step i, after any replay (JAX
                    # ``lat_entry``): a later pass rematerialises this step's records
                    # from it (pix2pix-zero's recompute_refs)
                    if traj_ys is None:
                        traj_ys = lat.new_empty((steps,) + tuple(lat.shape))
                    traj_ys[i] = lat
                ctx = flat(_group_context(contexts, uncond_seqs, i))
                eps, rec = unet(flat(torch.cat([lat, lat], dim=1)), int(sched.timesteps[i]), ctx, step_ctrl, added)
                if collect_records:
                    if rec_ys is None:
                        rec_ys = {k: v.new_empty((steps,) + tuple(v.shape)) for k, v in rec.items()}
                    for k, v in rec.items():
                        rec_ys[k][i] = v
                eps_u, eps_c = eps.reshape((g, 2 * p) + tuple(eps.shape[1:])).chunk(2, dim=1)
                lat = ddim_step(sched, eps_u + guidance_scale * (eps_c - eps_u), i, lat)
                if store_mode == "sum":
                    store = {k: store[k] + rec[k].float() if k in store else rec[k].float() for k in rec}
                if blend is not None:
                    lat = blend(lat[0], store)[None]
    return lat, rec_ys, traj_ys


def _group_of_one(added_cond: Optional[Dict[str, torch.Tensor]]) -> Optional[Dict[str, torch.Tensor]]:
    return None if added_cond is None else {k: v[None] for k, v in added_cond.items()}


def denoise(
    pipe,
    latents: torch.Tensor,
    context: torch.Tensor,
    ctrl=None,
    guidance_scale: float = 7.5,
    blend: Optional[LocalBlend] = None,
    uncond_seq: Optional[torch.Tensor] = None,
    source_replay: Optional[torch.Tensor] = None,
    added_cond: Optional[Dict[str, torch.Tensor]] = None,
    collect_records: bool = False,
    collect_trajectory: bool = False,
):
    """Run the full DDIM denoising loop for one image (a group of 1);
    returns the final (P, h, w, 4) latents.

    ``uncond_seq`` (S, 77, D): per-step unconditional embeddings from
    null-text inversion. ``source_replay`` (S+1, 1, h, w, 4): the inversion
    trajectory, which the source branch replays at every step (direct
    inversion). ``added_cond``: SDXL's (2P, ...) added conditions.

    With either flag it returns (latents, records, trajectory), each None
    unless its flag asks for it: ``collect_records``, per site the control's
    records of every step stacked, e.g. (S, 2P, H, N, 77) for
    pix2pix-zero's pass 1; ``collect_trajectory``, the (S, P, h, w, 4) UNet
    input latents of each step, taken after any replay (the JAX
    ``denoise``'s ``traj``)."""
    if ctrl is None:
        ctrl = NoneControl()
    store_mode = "sum" if blend is not None else None
    lat, rec_ys, traj_ys = _denoise_scan(
        pipe.unet, pipe.scheduler, latents[None], context[None], ctrl, guidance_scale, blend, store_mode,
        None if uncond_seq is None else uncond_seq[None], None if source_replay is None else source_replay[None],
        _group_of_one(added_cond), collect_records, collect_trajectory)
    traj_ys = None if traj_ys is None else traj_ys[:, 0]
    return (lat[0], rec_ys, traj_ys) if collect_records or collect_trajectory else lat[0]

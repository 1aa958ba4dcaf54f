"""MasaCtrl editor (mutual self-attention K/V sharing).

Counterpart of ``image_editing_framework_tpu/methods/masactrl.py``
(reference: masactrl/model/sd_utils.py, MasaCtrl.__call__ and its NTI/XL
variants; controllers from masactrl/model/attention_control.py). The
step/layer gate is a precomputed table; the K/V swap is a gather feeding the
flash kernel, and the union segments and fg/bg masks are its per-key bias.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from image_editing_framework_torch.core.config import MasaCtrlConfig, SamplerConfig
from image_editing_framework_torch.methods import common
from image_editing_framework_torch.methods.base import denoise
from image_editing_framework_torch.ops.controls import build_masactrl_control


def default_masactrl_config(pipe) -> MasaCtrlConfig:
    """STEP=4, LAYPER=10 for SD / 54 for SDXL (masactrl/edit_real.py:48-49,
    :118), clamped to the model's transformer-block count so tiny test
    architectures still gate some layers."""
    nblocks = pipe.unet.config.num_transformer_blocks
    start_layer = 54 if pipe.model_type == "xl" else 10
    if start_layer >= nblocks:
        start_layer = max(0, nblocks - 2)
    return MasaCtrlConfig(start_step=4, start_layer=start_layer)


def pca_direction(cond_embeddings: torch.Tensor) -> torch.Tensor:
    """Top principal direction of (emb[-2] - emb[-1]) over the token axis —
    the reference's ``kwds["dir"]`` feature (masactrl/model/sd_utils.py:56-59,
    torch.pca_lowrank(dir.T, q=1, center=True)). Returns (77,) f32 on the
    embeddings' device.

    A singular vector's sign is the solver's choice, and the edit moves
    along it: cuSOLVER, torch's CPU LAPACK and the JAX package's may each
    pick another. So the SVD of the (D, 77) matrix runs on the host in f32
    through SciPy's ``gesdd``, the LAPACK routine the JAX package calls on
    the CPU, wherever the embeddings lie: the card and the CPU give the
    same vector, with the JAX package's sign."""
    import scipy.linalg

    d = cond_embeddings[-2] - cond_embeddings[-1]  # (77, D)
    a = d.T.float().cpu().numpy()  # (D, 77)
    a = a - a.mean(axis=0, keepdims=True)  # center columns
    vt = scipy.linalg.svd(a, full_matrices=False, lapack_driver="gesdd")[2]
    return torch.from_numpy(np.ascontiguousarray(vt[0])).to(cond_embeddings.device)


def masactrl_edit(
    pipe,
    prompts: Sequence[str],
    latent: torch.Tensor,  # (1, h, w, 4) — inverted or sampled start latent
    cfg: MasaCtrlConfig = MasaCtrlConfig(),
    sampler: SamplerConfig = SamplerConfig(),
    uncond_seq: Optional[torch.Tensor] = None,  # (S, 77, D) NTI embeddings
    source_replay: Optional[torch.Tensor] = None,  # inversion trajectory
    direction_scale: Optional[float] = None,  # the reference's kwds["dir"]
    mask_s=None,  # (h, w) source object mask
    mask_t=None,  # (h, w) target object mask
    auto_mask: bool = False,
    thres: float = 0.1,
    ref_token_idx: Sequence[int] = (1,),
    cur_token_idx: Sequence[int] = (1,),
    neg_prompt: str = "",
) -> np.ndarray:
    """Run a MasaCtrl edit; returns uint8 images (P, H, W, 3), row 0 the
    source branch's reconstruction. ``cfg.mode`` picks mutual or union
    K/V; ``mask_s``/``mask_t`` the mask-guided variant; ``auto_mask`` the
    variant whose masks come from the cross-attention maps of the tokens
    ``ref_token_idx`` (source) and ``cur_token_idx`` (target), thresholded at
    ``thres``."""
    p = len(prompts)
    ctrl = build_masactrl_control(
        pipe.scheduler.num_steps, pipe.unet.config.num_transformer_blocks, cfg, num_prompts=p,
        mask_s=mask_s, mask_t=mask_t, auto_mask=auto_mask, thres=thres,
        ref_token_idx=tuple(ref_token_idx), cur_token_idx=tuple(cur_token_idx), device=pipe.device,
    )
    context, added_cond = common.prepare_conditioning(pipe, prompts, sampler.height, sampler.width,
                                                      negative_prompt=neg_prompt)
    if direction_scale is not None:
        v = pca_direction(context[p:]).to(context.dtype)
        context = context.clone()
        context[-1] += direction_scale * v[:, None]
    final = denoise(pipe, common.expand_latent(latent, p), context, ctrl, guidance_scale=sampler.guidance_scale,
                    uncond_seq=uncond_seq, source_replay=source_replay, added_cond=added_cond)
    return pipe.latent2image(final)

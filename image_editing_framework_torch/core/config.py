"""Method configuration dataclasses.

Counterpart of ``image_editing_framework_tpu/core/config.py``: the sampler,
Prompt-to-Prompt, MasaCtrl, Plug-and-Play and null-text inversion
configurations, with the reference's defaults (p2p/edit_real.py:42-55,
masactrl/edit_real.py:48-49, pnp/edit_real.py:45-46), and pix2pix-zero's
(pix2pix-zero/model/sd_utils.py:28).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Shared denoising-loop configuration (reference defaults:
    50 steps / CFG 7.5, p2p/edit_real.py:42-45)."""

    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    height: int = 512
    width: int = 512
    seed: int = 8888

    @property
    def latent_height(self) -> int:
        return self.height // 8

    @property
    def latent_width(self) -> int:
        return self.width // 8


@dataclasses.dataclass(frozen=True)
class P2PConfig:
    """Prompt-to-Prompt (reference: p2p/edit_real.py:49-51; edit_syn uses
    self_replace_steps=0.4, p2p/edit_syn.py:41-42)."""

    edit_type: str = "replace"  # "replace" | "refine"
    cross_replace_steps: Union[float, Dict[str, Tuple[float, float]]] = 0.8
    self_replace_steps: Union[float, Tuple[float, float]] = 0.6
    # Optional reweighting on top of replace/refine (AttentionReweight).
    eq_words: Tuple[str, ...] = ()
    eq_values: Tuple[float, ...] = ()
    # Optional local blend words (LocalBlend mask).
    blend_words: Optional[Tuple[Tuple[str, ...], Tuple[str, ...]]] = None
    blend_threshold: float = 0.3


@dataclasses.dataclass(frozen=True)
class MasaCtrlConfig:
    """MasaCtrl (reference: masactrl/edit_real.py:48-49; STEP=4, LAYPER=10 for
    SD, 54 for SDXL per masactrl/edit_real.py:118).

    ``step_idx``/``layer_idx`` are explicit gating lists (the reference's
    MutualSelfAttentionControl(step_idx=..., layer_idx=...) option,
    masactrl/model/attention_control.py:16-29); when set they override the
    start_step/start_layer ranges."""

    start_step: int = 4
    start_layer: int = 10  # 54 for SDXL
    mode: str = "mutual"  # "mutual" | "union"
    step_idx: Optional[Tuple[int, ...]] = None
    layer_idx: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class PnPConfig:
    """Plug-and-Play (reference: pnp/edit_real.py:45-46; edit_syn uses
    1.0/1.0, pnp/edit_syn.py:39-40)."""

    pnp_attn_t: float = 0.5
    pnp_f_t: float = 0.8


@dataclasses.dataclass(frozen=True)
class P2ZConfig:
    """pix2pix-zero (reference: pix2pix-zero/model/sd_utils.py:28).

    ``recompute_refs``: rematerialise pass 1's reference cross-attention
    maps inside pass 2 from the stored latent trajectory (one extra source
    forward per step) instead of keeping all steps x sites maps resident
    (~25 GB in bf16 at SDXL 1024²). On by default for XL pipelines in
    ``cli.run_method``.
    """

    guidance_amount: float = 0.1
    recompute_refs: bool = False
    # Differentiate through the checkpointed UNet (identical gradients,
    # the blocks' activations recomputed). None = auto (methods/common.py
    # grad_unet: on for XL at latent side >= 128).
    remat_grad: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class NTIConfig:
    """Null-text inversion (reference: p2p/edit_real.py:54-55 and
    p2p/inversion/nti.py:17; the XL variant in p2p uses lr=0.5*(1-i/500)
    (p2p/inversion/nti.py:50,69) while the other methods use
    5e-2*(1-i/100) (masactrl/inversion/nti.py:69))."""

    num_inner_steps: int = 10
    epsilon: float = 1e-5
    base_lr: float = 1e-2
    lr_decay_span: float = 100.0
    # Checkpointed UNet for the inner Adam gradients. None = auto
    # (methods/common.py grad_unet: on for XL at latent side >= 128).
    remat: Optional[bool] = None

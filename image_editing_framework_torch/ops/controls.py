"""Editing controllers as precomputed schedules (the P2P slice).

Counterpart of ``image_editing_framework_tpu/ops/controls.py:48-222``. Every
controller decision — a function of (step, layer, is_cross, resolution) plus
small precomputed tensors — is data:

* a ``*Control`` holds full-run tables (per-step alphas, gates),
* ``at_step(i)`` slices out a ``*Step`` for one denoising step,
* the UNet's attention sites ask the step for
  - a ``SelfAttnPlan`` (batch-index Q/K/V remap fed to the flash kernel),
  - a cross-attention probability edit,
  - whether/what to record (LocalBlend maps),
  and ResNet blocks ask ``resnet_hook`` (PnP feature injection, later).

Batch layout everywhere: B = 2P, ``[u_0..u_{P-1}, c_0..c_{P-1}]`` with the
source prompt at index 0 of each CFG half, so "edit only the conditional
half" means batch indices > P.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from image_editing_framework_torch.core.config import P2PConfig
from image_editing_framework_torch.ops import schedules, seq_aligner
from image_editing_framework_torch.ops.attention import AttnSite, SelfAttnPlan


# ---------------------------------------------------------------------------
# No-op control


class NoneStep:
    def self_plan(self, site: AttnSite, batch: int, device=None) -> Optional[SelfAttnPlan]:
        return None

    def self_override(self, site: AttnSite, q, k, v, running=None):
        """Full custom self-attention output (masked MasaCtrl variants, a
        later slice); None means use the plan/flash path. ``running`` is the
        dict of records from earlier sites of the same UNet forward."""
        return None

    def bind_store(self, store, step_index):
        """Receive the denoise loop's carried record store (LocalBlend's
        cross-step sum)."""
        del store, step_index
        return self

    def edit_cross(self, site: AttnSite, probs: torch.Tensor) -> torch.Tensor:
        return probs

    def record_key(self, site: AttnSite) -> Optional[str]:
        return None

    def record(self, site: AttnSite, probs: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def resnet_hook(self, key: str, h: torch.Tensor) -> torch.Tensor:
        return h


class NoneControl(NoneStep):
    def at_step(self, i: int) -> NoneStep:
        del i
        return NoneStep()


# ---------------------------------------------------------------------------
# Prompt-to-Prompt

_RES16_SEQ = 256  # 16x16 latent tokens: the resolution P2P self-replace and
# LocalBlend maps operate at (p2p/model/attention_base.py:132, ptp_utils.py:22).


@dataclasses.dataclass
class P2PStep(NoneStep):
    """One denoising step of P2P editing (replace / refine / reweight unified).

    Cross-attention (p2p/model/attention_base.py:113-125 + attention_control.py):
      inner = (base @ mapper) * tok_alpha + target * (1 - tok_alpha)   # refine
      inner = inner * equalizer                                         # reweight
      new   = inner * alpha_words + target * (1 - alpha_words)          # window
    Self-attention at <=16^2 tokens inside the self-replace window: target
    probabilities are the source's (Q,K from source; own V).
    """

    mapper: torch.Tensor  # (P-1, 77, 77)
    tok_alpha: torch.Tensor  # (P-1, 77)
    equalizer: torch.Tensor  # (P-1, 77)
    alpha_words: torch.Tensor  # (P-1, 77) — this step
    self_gate: bool  # this step
    num_prompts: int = 2
    record_blend: bool = False

    def self_plan(self, site: AttnSite, batch: int, device=None) -> Optional[SelfAttnPlan]:
        if site.seq_len > _RES16_SEQ:
            return None
        p = self.num_prompts
        iota = torch.arange(batch, dtype=torch.int64, device=device)
        idx = torch.where(iota > p, p, iota) if self.self_gate else iota
        return SelfAttnPlan(
            q_idx=idx,
            k_idx=idx[:, None],
            v_idx=iota[:, None],
            valid=torch.ones((batch, 1), dtype=torch.bool, device=device),
        )

    def edit_cross(self, site: AttnSite, probs: torch.Tensor) -> torch.Tensor:
        p = self.num_prompts
        base = probs[p]  # conditional source (H, N, 77)
        mapped = torch.einsum("hnw,pwv->phnv", base, self.mapper)
        tgt = probs[p + 1 :]
        ta = self.tok_alpha[:, None, None, :]
        inner = (mapped * ta + tgt * (1.0 - ta)) * self.equalizer[:, None, None, :]
        aw = self.alpha_words[:, None, None, :]
        return torch.cat([probs[: p + 1], inner * aw + tgt * (1.0 - aw)], dim=0)

    def record_key(self, site: AttnSite) -> Optional[str]:
        if self.record_blend and site.is_cross and site.seq_len == _RES16_SEQ:
            return site.key
        return None

    def record(self, site: AttnSite, probs: torch.Tensor) -> torch.Tensor:
        # (2P, H, 256, 77) -> mean over CFG halves and heads -> (P, 256, 77),
        # mirroring LocalBlend's reshape(P, -1, 1, 16, 16, 77).mean(1)
        # (p2p/model/ptp_utils.py:23-25).
        p = self.num_prompts
        h = probs.shape[1]
        return probs.reshape(2, p, h, probs.shape[2], 77).mean(dim=(0, 2))


@dataclasses.dataclass
class P2PControl:
    mapper: torch.Tensor
    tok_alpha: torch.Tensor
    equalizer: torch.Tensor
    cross_alpha: torch.Tensor  # (num_steps + 1, P-1, 77)
    self_gate: np.ndarray  # (num_steps,) bool, read on the host
    num_prompts: int = 2
    record_blend: bool = False

    def at_step(self, i: int) -> P2PStep:
        return P2PStep(
            mapper=self.mapper,
            tok_alpha=self.tok_alpha,
            equalizer=self.equalizer,
            alpha_words=self.cross_alpha[i],
            self_gate=bool(self.self_gate[i]),
            num_prompts=self.num_prompts,
            record_blend=self.record_blend,
        )


def build_p2p_control(
    prompts: Sequence[str],
    tokenizer,
    num_steps: int,
    cfg: P2PConfig,
    record_blend: bool = False,
    device=None,
) -> P2PControl:
    """Assemble the P2P control from prompts (host-side), its tensors on
    ``device`` in f32."""
    p = len(prompts)
    if cfg.edit_type == "replace":
        mapper = seq_aligner.get_replacement_mapper(prompts, tokenizer)
        tok_alpha = np.ones((p - 1, seq_aligner.MAX_LEN), np.float32)
    elif cfg.edit_type == "refine":
        gather, tok_alpha = seq_aligner.get_refinement_mapper(prompts, tokenizer)
        mapper = np.stack([seq_aligner.refinement_matrix(g) for g in gather])
    else:
        raise ValueError(f"unknown edit_type: {cfg.edit_type}")
    if cfg.eq_words:
        eq = seq_aligner.get_equalizer(prompts[-1], cfg.eq_words, cfg.eq_values, tokenizer)
        # reference applies one equalizer row per target prompt; broadcast.
        equalizer = np.broadcast_to(eq[:1], (p - 1, seq_aligner.MAX_LEN)).copy()
    else:
        equalizer = np.ones((p - 1, seq_aligner.MAX_LEN), np.float32)
    alpha = schedules.cross_replace_alpha(prompts, num_steps, cfg.cross_replace_steps, tokenizer)
    gate = schedules.self_replace_gate(cfg.self_replace_steps, num_steps)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return P2PControl(
        mapper=dev(mapper),
        tok_alpha=dev(tok_alpha),
        equalizer=dev(equalizer),
        cross_alpha=dev(alpha),
        self_gate=gate,
        num_prompts=p,
        record_blend=record_blend,
    )

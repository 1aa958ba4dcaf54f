"""Editing controllers as precomputed schedules (P2P, MasaCtrl, PnP), and
the recording controls (the attention store, pix2pix-zero's maps).

Counterpart of ``image_editing_framework_tpu/ops/controls.py``. Every
controller decision — a function of (step, layer, is_cross, resolution) plus
small precomputed tensors — is data:

* a ``*Control`` holds full-run tables (per-step alphas, gates),
* ``at_step(i)`` slices out a ``*Step`` for one denoising step,
* the UNet's attention sites ask the step for
  - a ``SelfAttnPlan`` (batch-index Q/K/V remap fed to the flash kernel),
  - a cross-attention probability edit,
  - whether/what to record (LocalBlend maps),
  - or a whole custom self-attention output (``self_override``: the
    masked MasaCtrl variants),
  and ResNet blocks ask ``resnet_hook`` (PnP feature injection).

Per-step gates are 0-d bool tensors on the pipeline's device, applied with
``torch.where``, and index tensors are made on the device (``arange``) or
once per control, so that no step makes the host wait for the card.

Batch layout everywhere: B = G·2P, group-major. A group of G images (the
batched editors of ``eval/batched.py``; the serial editors are a group of
1) is folded into the batch axis, and each image's block of 2P rows keeps
the order ``[u_0..u_{P-1}, c_0..c_{P-1}]``, the source prompt at index 0 of
each CFG half. So "edit only the conditional half" means the rows of each
block past its index P, and every step acts on a ``(G, 2P, ...)`` view of
its operands: a P2P source is its own image's, a MasaCtrl target attends to
its own image's source, a PnP target takes its own image's source
features. A control built for one image broadcasts to the group;
``stack_controls`` stacks one P2P control per image (a leading G axis on its
tensors, the step axis first on the per-step table).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from image_editing_framework_torch.core.config import MasaCtrlConfig, P2PConfig, PnPConfig
from image_editing_framework_torch.ops import schedules, seq_aligner
from image_editing_framework_torch.ops.attention import AttnSite, SelfAttnPlan, masked_attention, self_attention
from image_editing_framework_torch.ops.flash_attention import NEG_INF


# ---------------------------------------------------------------------------
# No-op control


class NoneStep:
    def self_plan(self, site: AttnSite, batch: int, device=None) -> Optional[SelfAttnPlan]:
        return None

    def self_override(self, site: AttnSite, q, k, v, running=None, cp_mesh=None, cp_mode="ring"):
        """Full custom self-attention output (the masked MasaCtrl variants);
        None means use the plan/flash path. ``running`` is the dict of
        records from earlier sites of the same UNet forward.
        ``cp_mesh`` / ``cp_mode`` thread the UNet's context parallelism into
        the override's attention calls (the per-key fg/bg bias is split with
        K), so masked variants at long-sequence sites run context-parallel
        like every plan-path site."""
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
        if self.self_gate:
            # each image's targets take its own conditional source's Q and K
            row = iota % (2 * p)
            idx = iota - row + torch.where(row > p, p, row)
        else:
            idx = iota
        return SelfAttnPlan(
            q_idx=idx,
            k_idx=idx[:, None],
            v_idx=iota[:, None],
            valid=torch.ones((batch, 1), dtype=torch.bool, device=device),
        )

    def edit_cross(self, site: AttnSite, probs: torch.Tensor) -> torch.Tensor:
        p = self.num_prompts
        blocks = probs.view((-1, 2 * p) + tuple(probs.shape[1:]))  # (G, 2P, H, N, 77)
        mapper = _per_image(self.mapper, 3)
        tok_alpha, equalizer, alpha_words = (_per_image(x, 2) for x in (self.tok_alpha, self.equalizer,
                                                                        self.alpha_words))
        base = blocks[:, p]  # each image's conditional source (G, H, N, 77)
        mapped = torch.einsum("ghnw,gpwv->gphnv", base, mapper)
        tgt = blocks[:, p + 1 :]
        ta = tok_alpha[:, :, None, None, :]
        inner = (mapped * ta + tgt * (1.0 - ta)) * equalizer[:, :, None, None, :]
        aw = alpha_words[:, :, None, None, :]
        return torch.cat([blocks[:, : p + 1], inner * aw + tgt * (1.0 - aw)], dim=1).view(probs.shape)

    def record_key(self, site: AttnSite) -> Optional[str]:
        if self.record_blend and site.is_cross and site.seq_len == _RES16_SEQ:
            return site.key
        return None

    def record(self, site: AttnSite, probs: torch.Tensor) -> torch.Tensor:
        # (G·2P, H, 256, 77) -> mean over each image's CFG halves and the
        # heads -> (G·P, 256, 77), mirroring LocalBlend's
        # reshape(P, -1, 1, 16, 16, 77).mean(1) (p2p/model/ptp_utils.py:23-25).
        p = self.num_prompts
        h = probs.shape[1]
        return probs.reshape(-1, 2, p, h, probs.shape[2], 77).mean(dim=(1, 3)).reshape(-1, probs.shape[2], 77)


def _per_image(x: torch.Tensor, rank: int) -> torch.Tensor:
    """A P2P tensor of one image's ``rank`` dims with a leading group axis:
    a stacked control's as it is, one image's as a group of 1."""
    return x if x.dim() > rank else x[None]


@dataclasses.dataclass
class P2PControl:
    """One image's P2P tables, or G images' from ``stack_controls``: mapper
    (P-1, 77, 77) or (G, P-1, 77, 77), tok_alpha and equalizer (P-1, 77) or
    (G, P-1, 77), cross_alpha (S+1, P-1, 77) or (S+1, G, P-1, 77). The
    self-replace gate is shared by the group."""

    mapper: torch.Tensor
    tok_alpha: torch.Tensor
    equalizer: torch.Tensor
    cross_alpha: torch.Tensor  # (num_steps + 1, P-1, 77), or (num_steps + 1, G, P-1, 77)
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


def stack_controls(items: Sequence[P2PControl]) -> P2PControl:
    """One control for a group from each image's (JAX ``eval/batched.py
    stack_controls``): the tensors stacked on a new group axis, after the
    step axis of ``cross_alpha``; the static fields (the self-replace gate,
    the prompt count, LocalBlend recording) must agree."""
    first = items[0]
    for c in items[1:]:
        if (c.num_prompts, c.record_blend) != (first.num_prompts, first.record_blend) or not np.array_equal(
                c.self_gate, first.self_gate):
            raise ValueError("controls of one group must share their prompt count, LocalBlend recording and "
                             "self-replace gate")
    return dataclasses.replace(
        first, mapper=torch.stack([c.mapper for c in items]), tok_alpha=torch.stack([c.tok_alpha for c in items]),
        equalizer=torch.stack([c.equalizer for c in items]),
        cross_alpha=torch.stack([c.cross_alpha for c in items], dim=1))


# ---------------------------------------------------------------------------
# MasaCtrl


def key_bias(keep: torch.Tensor, batch: int) -> torch.Tensor:
    """(batch, N) f32 per-key bias, 0 where ``keep`` and NEG_INF elsewhere,
    materialised: the CUDA kernel takes a contiguous bias only."""
    return torch.where(keep, 0.0, NEG_INF).to(torch.float32).repeat(batch, 1)


def _resize_nearest(mask: torch.Tensor, side: int) -> torch.Tensor:
    """(h, w) -> (side * side,) nearest resize with half-pixel centres, as
    ``jax.image.resize(..., "nearest")`` (torch's ``"nearest"`` picks other
    pixels when it shrinks)."""
    return F.interpolate(mask[None, None], size=(side, side), mode="nearest-exact").reshape(-1)


@dataclasses.dataclass
class MasaCtrlStep(NoneStep):
    """Mutual self-attention: at gated (step, layer), every element of each
    CFG half of each image attends to the half's *source* K/V
    (masactrl/model/attention_control.py:59-66); "union" mode instead gives
    target elements concat([source, self]) K/V (:102-103), the first
    (source) segment masked by a per-key bias where it does not apply: for
    the sources always (it repeats their own keys), for the targets at
    ungated steps.

    The layer set is static (ungated layers get no plan at all); only the
    step gate is a tensor. The CFG halves are blocks of P rows in the group
    layout, so ``(iota // P) * P`` is each row's own image's source. The
    masked variants below act on one image (the batched editors build none).
    """

    step_gate: torch.Tensor  # () bool — this step
    layers: Tuple[int, ...] = ()
    num_prompts: int = 2
    union: bool = False

    def self_plan(self, site: AttnSite, batch: int, device=None) -> Optional[SelfAttnPlan]:
        if site.layer not in self.layers:
            return None
        p = self.num_prompts
        gate = self.step_gate
        iota = torch.arange(batch, dtype=torch.int64, device=gate.device)
        half_src = (iota // p) * p
        if not self.union:
            kv = torch.where(gate, half_src, iota)
            return SelfAttnPlan(q_idx=iota, k_idx=kv[:, None], v_idx=kv[:, None],
                                valid=torch.ones((batch, 1), dtype=torch.bool, device=gate.device))
        k_idx = torch.stack([half_src, iota], dim=1)  # (B, 2)
        is_target = (iota % p) != 0
        valid = torch.stack([gate & is_target, torch.ones_like(is_target)], dim=1)
        return SelfAttnPlan(q_idx=iota, k_idx=k_idx, v_idx=k_idx, valid=valid)

    def _source_kv(self, k, v):
        """(each element's CFG-half source K, its V, a (B, 1, 1, 1) mask of
        the target elements)."""
        iota = torch.arange(k.shape[0], dtype=torch.int64, device=k.device)
        half_src = (iota // self.num_prompts) * self.num_prompts
        return k[half_src], v[half_src], ((iota % self.num_prompts) != 0)[:, None, None, None]


def _fg_bg_blend(q, k_src, v_src, fg_s: torch.Tensor, mt: torch.Tensor, cp: dict) -> torch.Tensor:
    """All queries against the source's fg keys (``fg_s``, (N,) bool) and
    against its bg keys, blended by the target mask ``mt`` (N,):
    ``out_fg * mt + out_bg * (1 - mt)``. ``cp``: the UNet's context
    parallelism (``cp_mesh``, ``cp_mode``)."""
    b = q.shape[0]
    out_fg = masked_attention(q, k_src, v_src, key_bias(fg_s, b), **cp)
    out_bg = masked_attention(q, k_src, v_src, key_bias(~fg_s, b), **cp)
    mt = mt[None, None, :, None]
    return out_fg * mt + out_bg * (1.0 - mt)


@dataclasses.dataclass
class MasaCtrlMaskStep(MasaCtrlStep):
    """Mask-guided MasaCtrl (masactrl/model/attention_control.py:110-190):
    at gated layers, target queries attend the source K/V twice — restricted
    to source-foreground keys and source-background keys — and the two
    outputs blend by the target mask:

        out_t = out_fg * mask_t + out_bg * (1 - mask_t)

    Source branches run normal self-attention. ``mask_s`` / ``mask_t`` are
    full-resolution (h, w) float masks, resized to each site's token grid.
    """

    mask_s: Optional[torch.Tensor] = None  # (h, w) source object mask
    mask_t: Optional[torch.Tensor] = None  # (h, w) target object mask

    def self_override(self, site: AttnSite, q, k, v, running=None, cp_mesh=None, cp_mode="ring"):
        if site.layer not in self.layers:
            return None
        cp = dict(cp_mesh=cp_mesh, cp_mode=cp_mode)
        side = int(q.shape[2] ** 0.5)
        k_src, v_src, is_target = self._source_kv(k, v)
        normal = self_attention(q, k, v, None, **cp)
        blended = _fg_bg_blend(q, k_src, v_src, _resize_nearest(self.mask_s, side) > 0.5,
                               _resize_nearest(self.mask_t, side), cp)
        return torch.where(is_target & self.step_gate, blended, normal)


@dataclasses.dataclass
class MasaCtrlAutoStep(MasaCtrlStep):
    """Auto-masked MasaCtrl (masactrl/model/attention_control.py:192-330):
    fg/bg masks are derived from 16x16 cross-attention maps of selected
    tokens rather than supplied.

    The masks at a gated self-attention site come from the mean of the 16x16
    cross-attention maps recorded by earlier sites of the SAME forward (the
    UNet threads its records down in execution order — ``running``), like the
    reference's ``self.cross_attns`` list that ``after_step`` clears
    (attention_control.py:224-226, 273-296). With no maps recorded yet the
    target falls back to plain mutual attention (:293-296).
    """

    thres: float = 0.1
    ref_idx: Tuple[int, ...] = (1,)
    cur_idx: Tuple[int, ...] = (1,)

    def record_key(self, site: AttnSite) -> Optional[str]:
        if site.is_cross and site.seq_len == _RES16_SEQ:
            return site.key
        return None

    def record(self, site: AttnSite, probs: torch.Tensor) -> torch.Tensor:
        return probs.mean(dim=1)  # (2P, 256, 77), mean over heads

    def masks_from(self, running) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mask_s16, mask_t16), each (256,), from the maps recorded so far
        this forward (reference aggregate_cross_attn_map,
        attention_control.py:257-269)."""
        avg = torch.stack([running[key] for key in sorted(running)]).mean(dim=0)  # (2P, 256, 77)

        def token_map(idx):
            img = sum(avg[..., i] for i in idx)  # (2P, 256); integer indexing copies no index to the card
            lo = img.amin(dim=1, keepdim=True)
            hi = img.amax(dim=1, keepdim=True)
            return (img - lo) / torch.clamp(hi - lo, min=1e-8)

        p = self.num_prompts
        return token_map(self.ref_idx)[p], token_map(self.cur_idx)[2 * p - 1]  # conditional source, target

    def self_plan(self, site: AttnSite, batch: int, device=None) -> Optional[SelfAttnPlan]:
        return None  # all logic lives in self_override

    def self_override(self, site: AttnSite, q, k, v, running=None, cp_mesh=None, cp_mode="ring"):
        if site.layer not in self.layers:
            return None
        cp = dict(cp_mesh=cp_mesh, cp_mode=cp_mode)
        k_src, v_src, is_target = self._source_kv(k, v)
        normal = self_attention(q, k, v, None, **cp)
        mutual = self_attention(q, k_src, v_src, None, **cp)
        if not running:
            # no cross maps recorded yet this forward: plain mutual attention
            # for targets (attention_control.py:293-296)
            return torch.where(is_target & self.step_gate, mutual, normal)

        side = int(q.shape[2] ** 0.5)
        ms, mt = (_resize_nearest(m.reshape(16, 16), side) >= self.thres for m in self.masks_from(running))
        masked = _fg_bg_blend(q, k_src, v_src, ms, mt.to(torch.float32), cp)
        return torch.where(is_target & self.step_gate, masked, normal)


@dataclasses.dataclass
class MasaCtrlControl:
    step_gate: torch.Tensor  # (num_steps,) bool
    layers: Tuple[int, ...] = ()
    num_prompts: int = 2
    union: bool = False
    mask_s: Optional[torch.Tensor] = None
    mask_t: Optional[torch.Tensor] = None
    auto_mask: bool = False
    thres: float = 0.1
    ref_idx: Tuple[int, ...] = (1,)
    cur_idx: Tuple[int, ...] = (1,)

    def at_step(self, i: int) -> MasaCtrlStep:
        common = dict(step_gate=self.step_gate[i], layers=self.layers, num_prompts=self.num_prompts,
                      union=self.union)
        if self.auto_mask:
            return MasaCtrlAutoStep(**common, thres=self.thres, ref_idx=self.ref_idx, cur_idx=self.cur_idx)
        if self.mask_s is not None:
            return MasaCtrlMaskStep(**common, mask_s=self.mask_s, mask_t=self.mask_t)
        return MasaCtrlStep(**common)


def build_masactrl_control(
    num_steps: int,
    num_layers: int,
    cfg: MasaCtrlConfig,
    num_prompts: int = 2,
    mask_s=None,
    mask_t=None,
    auto_mask: bool = False,
    thres: float = 0.1,
    ref_token_idx: Tuple[int, ...] = (1,),
    cur_token_idx: Tuple[int, ...] = (1,),
    device=None,
) -> MasaCtrlControl:
    """The MasaCtrl control, its gate and masks on ``device``."""
    gate = schedules.masactrl_gate(num_steps, num_layers, cfg.start_step, cfg.start_layer, cfg.step_idx,
                                   cfg.layer_idx)

    def mask(m):
        return None if m is None else torch.as_tensor(m, dtype=torch.float32, device=device)

    return MasaCtrlControl(
        step_gate=torch.as_tensor(gate.any(axis=1), device=device),
        layers=tuple(int(i) for i in np.nonzero(gate.any(axis=0))[0]),
        num_prompts=num_prompts,
        union=cfg.mode == "union",
        mask_s=mask(mask_s),
        mask_t=mask(mask_t),
        auto_mask=auto_mask,
        thres=thres,
        ref_idx=tuple(ref_token_idx),
        cur_idx=tuple(cur_token_idx),
    )


# ---------------------------------------------------------------------------
# Plug-and-Play

# Injection gathers the *conditional source* (index 2 of [u_s, u_t, c_s, c_t])
# into both target branches (pnp/model/register.py:46-52, :163-168), within
# each image's block of 4 rows.
_PNP_INJECT_IDX = (0, 2, 2, 2)


def _pnp_rows(inject: torch.Tensor, batch: int) -> torch.Tensor:
    """(batch,) source row of each row of a group of ``batch // 4`` images."""
    if batch % 4:
        raise ValueError(f"PnP operates on blocks of [u_src, u_tgt, c_src, c_tgt], got a batch of {batch}")
    iota = torch.arange(batch, dtype=torch.int64, device=inject.device)
    return iota - iota % 4 + inject[iota % 4]


@dataclasses.dataclass
class PnPStep(NoneStep):
    """One denoising step of Plug-and-Play: at the attention sites, Q and K
    of every branch come from the conditional source while ``qk_gate`` is
    on (V stays each branch's own); at the ResNet sites, the conditional
    source's features replace the targets' while ``conv_gate`` is on."""

    qk_gate: torch.Tensor  # () bool
    conv_gate: torch.Tensor  # () bool
    inject: torch.Tensor  # (4,) _PNP_INJECT_IDX, on the gates' device
    attn_layers: Tuple[int, ...] = ()
    conv_keys: Tuple[str, ...] = ()

    def self_plan(self, site: AttnSite, batch: int, device=None) -> Optional[SelfAttnPlan]:
        if site.layer not in self.attn_layers:
            return None
        dev = self.qk_gate.device
        rows = _pnp_rows(self.inject, batch)
        iota = torch.arange(batch, dtype=torch.int64, device=dev)
        idx = torch.where(self.qk_gate, rows, iota)
        return SelfAttnPlan(q_idx=idx, k_idx=idx[:, None], v_idx=iota[:, None],
                            valid=torch.ones((batch, 1), dtype=torch.bool, device=dev))

    def resnet_hook(self, key: str, h: torch.Tensor) -> torch.Tensor:
        if key not in self.conv_keys:
            return h
        return torch.where(self.conv_gate, h[_pnp_rows(self.inject, h.shape[0])], h)


@dataclasses.dataclass
class PnPControl:
    qk_gate: torch.Tensor  # (num_steps,) bool
    conv_gate: torch.Tensor  # (num_steps,) bool
    inject: torch.Tensor  # (4,) _PNP_INJECT_IDX, made once on the gates' device
    attn_layers: Tuple[int, ...] = ()
    conv_keys: Tuple[str, ...] = ()

    def at_step(self, i: int) -> PnPStep:
        return PnPStep(qk_gate=self.qk_gate[i], conv_gate=self.conv_gate[i], inject=self.inject,
                       attn_layers=self.attn_layers, conv_keys=self.conv_keys)


def build_pnp_control(
    num_steps: int,
    cfg: PnPConfig,
    attn_layers: Tuple[int, ...],
    conv_keys: Tuple[str, ...],
    device=None,
) -> PnPControl:
    """The PnP control, its gates on ``device``."""
    qk, conv = schedules.pnp_gates(num_steps, cfg.pnp_attn_t, cfg.pnp_f_t)
    return PnPControl(qk_gate=torch.as_tensor(qk, device=device), conv_gate=torch.as_tensor(conv, device=device),
                      inject=torch.tensor(_PNP_INJECT_IDX, device=device), attn_layers=tuple(attn_layers),
                      conv_keys=tuple(conv_keys))


# ---------------------------------------------------------------------------
# Attention store (visualization / analysis)


@dataclasses.dataclass
class AttentionStoreStep(NoneStep):
    """Records attention maps for visualization: the reference's
    AttentionStore (p2p/model/attention_base.py:57-92 stores maps of at
    most 32² tokens per step, then averages across steps). Use with
    ``denoise(..., collect_records=True)`` and average the stacked records
    with ``average_attention``. Maps are averaged over heads to bound
    memory."""

    max_seq: int = 1024
    include_self: bool = True

    def record_key(self, site: AttnSite) -> Optional[str]:
        if site.seq_len > self.max_seq:
            return None
        if not site.is_cross and not self.include_self:
            return None
        return site.key

    def record(self, site: AttnSite, probs: torch.Tensor) -> torch.Tensor:
        return probs.mean(dim=1)  # (B, N, K), mean over heads


@dataclasses.dataclass
class AttentionStoreControl(AttentionStoreStep):
    def at_step(self, i: int) -> AttentionStoreStep:
        del i
        return AttentionStoreStep(max_seq=self.max_seq, include_self=self.include_self)


def average_attention(ys: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-site step-averaged maps (reference get_average_attention,
    p2p/model/attention_base.py:84-86). ys: {site: (S, B, N, K)}."""
    return {k: v.mean(dim=0) for k, v in ys.items()}


# ---------------------------------------------------------------------------
# pix2pix-zero


@dataclasses.dataclass
class P2ZStep(NoneStep):
    """Records every cross-attention probability map, cast to
    ``store_dtype``: pass 1 of pix2pix-zero stores them as references, pass
    2 differentiates their L2 distance to them
    (pix2pix-zero/model/sd_utils.py:104-110,166-172)."""

    store_dtype: torch.dtype = torch.bfloat16

    def record_key(self, site: AttnSite) -> Optional[str]:
        return site.key if site.is_cross else None

    def record(self, site: AttnSite, probs: torch.Tensor) -> torch.Tensor:
        return probs.to(self.store_dtype)


@dataclasses.dataclass
class P2ZControl(P2ZStep):
    def at_step(self, i: int) -> P2ZStep:
        del i
        return P2ZStep(store_dtype=self.store_dtype)

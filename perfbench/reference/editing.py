"""Plain DDIM sampling, Prompt-to-Prompt and pix2pix-zero over ``nets``.

Semantics (the published methods as the framework states them):

* DDIM (eta 0) on the scaled-linear schedule (beta 0.00085 -> 0.012, 1000
  steps, "leading" spacing with offset 1, final alpha = alphas_cumprod[0]).
  Inversion walks the timesteps upwards with the conditional branch alone.
* Prompt-to-Prompt (Hertz et al. 2022, ``p2p/model/attention_control.py``):
  on the conditional half of each image's [source, target] pair, the
  target's cross-attention probabilities become the source's, mapped through
  the word-replacement matrix (equal word counts) or the refinement
  alignment (Needleman-Wunsch over token ids), for the first
  ``int(0.8 (S + 1))`` steps; for the first ``int(0.6 S)`` steps, at sites
  of at most 16 x 16 tokens, the target's self-attention probabilities
  become the source's. Classifier-free guidance 7.5.
* pix2pix-zero (Parmar et al. 2023, ``pix2pix-zero/model/sd_utils.py``):
  pass 1 denoises under the source prompt; pass 2, at each step, takes one
  gradient step of size 0.1 on the CFG-doubled latent against the squared
  distance of every cross-attention map to pass 1's at that step (summed
  over tokens and positions, averaged over rows and heads, summed over
  sites), then the guided DDIM step from the first half.

Tensors here are NCHW float32 on the caller's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference import nets
from perfbench.reference.nets import F32, AttnHooks, Precision

MAX_LEN = 77


# -------------------------------------------------------------------- DDIM


@dataclasses.dataclass(frozen=True)
class Schedule:
    alphas: np.ndarray  # (1000,) float64
    timesteps: np.ndarray  # (S,) descending
    ratio: int

    def alpha(self, t: int) -> float:
        return float(self.alphas[t]) if t >= 0 else float(self.alphas[0])


def schedule(steps: int, cfg: dict) -> Schedule:
    n = cfg["num_train_timesteps"]
    betas = np.linspace(cfg["beta_start"] ** 0.5, cfg["beta_end"] ** 0.5, n, dtype=np.float64) ** 2
    alphas = np.cumprod(1.0 - betas)
    ratio = n // steps
    return Schedule(alphas, np.arange(steps - 1, -1, -1) * ratio + cfg["steps_offset"], ratio)


def _move(x: torch.Tensor, eps: torch.Tensor, a_src: float, a_dst: float) -> torch.Tensor:
    x0 = (x - (1 - a_src) ** 0.5 * eps) / a_src ** 0.5
    return a_dst ** 0.5 * x0 + (1 - a_dst) ** 0.5 * eps


def denoise_step(sch: Schedule, eps: torch.Tensor, i: int, x: torch.Tensor) -> torch.Tensor:
    t = int(sch.timesteps[i])
    return _move(x, eps, sch.alpha(t), sch.alpha(t - sch.ratio))


def invert_timestep(sch: Schedule, i: int) -> int:
    return int(sch.timesteps[len(sch.timesteps) - 1 - i])


def invert_step(sch: Schedule, eps: torch.Tensor, i: int, x: torch.Tensor) -> torch.Tensor:
    t = invert_timestep(sch, i)
    return _move(x, eps, sch.alpha(t - sch.ratio), sch.alpha(t))


def step_alphas(sch: Schedule, i: int, invert: bool):
    """(alpha of the source timestep, alpha of the destination) of step i."""
    if invert:
        t = invert_timestep(sch, i)
        return sch.alpha(t - sch.ratio), sch.alpha(t)
    t = int(sch.timesteps[i])
    return sch.alpha(t), sch.alpha(t - sch.ratio)


def coefficients(a_src: float, a_dst: float, r) -> List[float]:
    """(sqrt(1 - a_s), sqrt(a_s), sqrt(a_d), sqrt(1 - a_d)) as the framework
    states them for a state of the dtype that ``r`` rounds a float32 number
    to: the table's float32 alphas rounded to that dtype first, then each
    difference and root rounded (near t = 0, 1 - a rounds to 0 or to the
    dtype's spacing below 1)."""
    a_s, a_d = (r(torch.tensor(np.float32(a))) for a in (a_src, a_dst))
    return [float(r(torch.sqrt(v))) for v in (r(1.0 - a_s), a_s, a_d, r(1.0 - a_d))]


def move_with(x: torch.Tensor, eps: torch.Tensor, c: Sequence[float], r=lambda t: t) -> torch.Tensor:
    """The DDIM update with the coefficients ``c``: pred_x0 = (x - c0 eps) /
    c1, then c2 pred_x0 + c3 eps, ``r`` applied after every operation."""
    x0 = r(r(x - r(c[0] * eps)) / c[1])
    return r(r(c[2] * x0) + r(c[3] * eps))


def to_dtype(dtype: torch.dtype):
    """Rounding of a float32 tensor to ``dtype``, carried back in float32."""
    return lambda t: t.to(dtype).float()


# ----------------------------------------------------------------- prompts


class Model:
    """One configuration's networks on one device: weights, configs and the
    tokenizer, with the conditioning each model family takes."""

    def __init__(self, cfg: dict, params: Dict[str, Dict[str, torch.Tensor]], tokenizer, device):
        self.cfg, self.p, self.tok, self.device = cfg, params, tokenizer, device
        self.xl = "text_encoder_2" in cfg

    def ids(self, prompts: Sequence[str]) -> torch.Tensor:
        return torch.tensor([self.tok.padded(p) for p in prompts], dtype=torch.int64, device=self.device)

    def conditioning(self, prompts: Sequence[str], q: Precision = F32):
        """(context (B, 77, D), added conditions or None) of prompts; the
        unconditional prompt is "" (SDXL: zeros, force_zeros_for_empty_prompt)."""
        ids = self.ids(prompts)
        if not self.xl:
            return nets.clip_text(self.p["text_encoder"], self.cfg["text_encoder"], ids, q)["last"], None
        a = nets.clip_text(self.p["text_encoder"], self.cfg["text_encoder"], ids, q)
        b = nets.clip_text(self.p["text_encoder_2"], self.cfg["text_encoder_2"], ids, q)
        return torch.cat([a["penultimate"], b["penultimate"]], dim=-1), b["pooled"]

    def added(self, pooled: Optional[torch.Tensor], rows: int):
        if pooled is None:
            return None
        side = self.cfg["resolution"]
        ids = torch.tensor([[side, side, 0, 0, side, side]], dtype=torch.float32, device=self.device)
        return {"text_embeds": pooled, "time_ids": ids.expand(rows, -1)}

    def uncond(self, q: Precision = F32):
        ctx, pooled = self.conditioning([""], q)
        if self.xl:
            return torch.zeros_like(ctx), torch.zeros_like(pooled)
        return ctx, None

    def eps(self, x, t, ctx, pooled=None, hooks=None, q: Precision = F32):
        return nets.unet(self.p["unet"], self.cfg["unet"], x, t, ctx, hooks, self.added(pooled, x.shape[0]), q)

    def encode(self, img: torch.Tensor, q: Precision = F32) -> torch.Tensor:
        """uint8 (B, H, W, 3) -> scaled latents (B, 4, H/8, W/8)."""
        x = img.permute(0, 3, 1, 2).float() / 127.5 - 1.0
        return nets.vae_encode(self.p["vae"], self.cfg["vae"], x, q)

    def decode(self, z: torch.Tensor, q: Precision = F32) -> torch.Tensor:
        """Scaled latents -> (B, H, W, 3) float levels in [0, 255], unrounded."""
        vcfg = self.cfg["vae"]
        tile = self.cfg.get("decode_tile_latent")

        def one(zz):
            return nets.vae_decode(self.p["vae"], vcfg, zz, q)

        img = one(z) if tile is None else nets.vae_decode_tiled(one, z, tile,
                                                                scale=2 ** (len(vcfg["block_out_channels"]) - 1))
        return (img / 2 + 0.5).clamp(0, 1).permute(0, 2, 3, 1) * 255.0


# ------------------------------------------------------ Prompt-to-Prompt


def _word_token(tok, word: str) -> int:
    ids = tok.encode(word)
    if len(ids) != 3:
        raise ValueError(f"the reference maps single-token words only; {word!r} is {len(ids) - 2} tokens")
    return ids[1]


def replacement_mapper(src: str, tgt: str, tok) -> np.ndarray:
    """77 x 77 matrix M with (source probabilities) @ M = the target's, for
    prompts of equal word counts whose words are one token each: every
    source token maps to the target token at its place."""
    ws, wt = src.split(" "), tgt.split(" ")
    if len(ws) != len(wt):
        raise ValueError("replace needs equal word counts")
    for w in ws + wt:
        _word_token(tok, w)
    return np.eye(MAX_LEN, dtype=np.float32)


def global_align(x: Sequence[int], y: Sequence[int]):
    """Needleman-Wunsch with gap 0, match 1, mismatch -1 and P2P's
    tie-break (left, then up, then diagonal); returns the target -> source
    index map (-1 where the target token has no source)."""
    nx, ny = len(x), len(y)
    score = np.zeros((nx + 1, ny + 1), dtype=np.int64)
    back = np.zeros((nx + 1, ny + 1), dtype=np.int64)
    back[0, 1:], back[1:, 0], back[0, 0] = 1, 2, 4
    for i in range(1, nx + 1):
        for j in range(1, ny + 1):
            left, up = score[i, j - 1], score[i - 1, j]
            diag = score[i - 1, j - 1] + (1 if x[i - 1] == y[j - 1] else -1)
            score[i, j] = max(left, up, diag)
            back[i, j] = 1 if score[i, j] == left else 2 if score[i, j] == up else 3
    i, j, pairs = nx, ny, []
    while i > 0 or j > 0:
        if back[i, j] == 3:
            i, j = i - 1, j - 1
            pairs.append((j, i))
        elif back[i, j] == 1:
            j -= 1
            pairs.append((j, -1))
        elif back[i, j] == 2:
            i -= 1
        else:
            break
    return [s for _, s in reversed(pairs)]


def refinement(src: str, tgt: str, tok):
    """(77 x 77 gather matrix, (77,) alphas): target token j takes source
    token map[j] where aligned (alpha 1), keeps its own where not (alpha 0);
    tokens past the target's length take their own index."""
    xs, ys = tok.encode(src), tok.encode(tgt)
    m = global_align(xs, ys)
    gather = np.concatenate([np.array(m, dtype=np.int64),
                             len(ys) + np.arange(MAX_LEN - len(ys), dtype=np.int64)])[:MAX_LEN]
    alphas = np.ones(MAX_LEN, dtype=np.float32)
    alphas[: len(m)] = (np.array(m) != -1).astype(np.float32)
    mat = np.zeros((MAX_LEN, MAX_LEN), dtype=np.float32)
    for j, s in enumerate(gather):
        if 0 <= s < MAX_LEN:
            mat[s, j] = 1.0
    return mat, alphas


class P2PHooks(AttnHooks):
    """One image's P2P edit at one step; rows [u_src, u_tgt, c_src, c_tgt]."""

    def __init__(self, mapper: torch.Tensor, tok_alpha: torch.Tensor, cross_on: bool, self_on: bool):
        self.mapper, self.tok_alpha, self.cross_on, self.self_on = mapper, tok_alpha, cross_on, self_on

    def cross(self, site, tokens, probs):
        if not self.cross_on:
            return probs
        base, tgt = probs[2], probs[3]
        mapped = torch.einsum("hnw,wv->hnv", base, self.mapper)
        new = mapped * self.tok_alpha + tgt * (1 - self.tok_alpha)
        return torch.cat([probs[:3], new[None]], dim=0)

    def self_probs(self, site, tokens, probs):
        if not (self.self_on and tokens <= 256):
            return probs
        return torch.cat([probs[:3], probs[2:3]], dim=0)


@dataclasses.dataclass
class P2PEdit:
    """The P2P tables of one (source, target) pair over S steps."""

    mapper: torch.Tensor
    tok_alpha: torch.Tensor
    cross_steps: int
    self_steps: int

    @classmethod
    def build(cls, src: str, tgt: str, tok, steps: int, device, cross: float = 0.8, self_: float = 0.6):
        if len(src.split(" ")) == len(tgt.split(" ")):
            mapper, alphas = replacement_mapper(src, tgt, tok), np.ones(MAX_LEN, np.float32)
        else:
            mapper, alphas = refinement(src, tgt, tok)
        return cls(torch.as_tensor(mapper, device=device), torch.as_tensor(alphas, device=device),
                   int(cross * (steps + 1)), int(self_ * steps))

    def hooks(self, i: int) -> P2PHooks:
        return P2PHooks(self.mapper, self.tok_alpha, i < self.cross_steps, i < self.self_steps)


# ------------------------------------------------------------ pix2pix-zero


class RecordCross(AttnHooks):
    """Keeps every cross-attention site's probabilities, in forward order,
    rounded to ``store`` as pix2pix-zero records them (bf16 in this
    framework: the references of all steps and sites are held resident); the
    gradient passes the rounding unchanged."""

    def __init__(self, store: torch.dtype = torch.float32):
        self.store = store
        self.maps: List[torch.Tensor] = []

    def cross(self, site, tokens, probs):
        self.maps.append(probs.to(self.store).to(probs.dtype))
        return probs


def attention_loss(maps: Sequence[torch.Tensor], refs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ over sites of the squared distance summed over positions and
    tokens, averaged over the rows and heads."""
    return sum((m - r).square().sum(dim=(2, 3)).mean() for m, r in zip(maps, refs))


def p2z_gradient(model: Model, x_in: torch.Tensor, t: int, ctx: torch.Tensor, pooled, refs, q: Precision = F32,
                 store: torch.dtype = torch.float32):
    """(loss, d loss / d x_in) for one image: x_in (2, 4, h, w)."""
    x = x_in.detach().requires_grad_(True)
    with torch.enable_grad():
        rec = RecordCross(store)
        model.eps(x, t, ctx, pooled, rec, q)
        loss = attention_loss(rec.maps, refs)
        (g,) = torch.autograd.grad(loss, x)
    return loss.detach(), g

"""Precomputed step schedules (host-side, NumPy).

Copy of ``image_editing_framework_tpu/ops/schedules.py`` for the functions
the P2P, MasaCtrl and PnP editors need; the port keeps its own so it imports
nothing of the JAX package. Every gate is a (steps,) or (steps + 1, ...)
table that the denoise loop indexes by step.

Sources of semantics:
  * time-words cross-replace alpha  — p2p/model/ptp_utils.py:54-83
  * self-replace step window        — p2p/model/attention_base.py:104-106,114
  * MasaCtrl step/layer gate        — masactrl/model/attention_control.py:11-29
  * PnP injection thresholds        — pnp/model/sd_utils.py:16-20
  * LocalBlend word weights         — p2p/model/ptp_utils.py:6-32
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from image_editing_framework_torch.ops import seq_aligner

MAX_LEN = seq_aligner.MAX_LEN


def _bounds(b: Union[float, Tuple[float, float]], num_steps: int) -> Tuple[int, int]:
    if isinstance(b, (int, float)):
        b = (0.0, float(b))
    return int(b[0] * num_steps), int(b[1] * num_steps)


def cross_replace_alpha(
    prompts: Sequence[str],
    num_steps: int,
    cross_replace_steps: Union[float, Dict[str, Tuple[float, float]]],
    tokenizer,
    max_len: int = MAX_LEN,
) -> np.ndarray:
    """(num_steps + 1, P-1, 77) per-step per-token blend weight.

    alpha = 1 -> use the (mapped) source attention; alpha = 0 -> keep the
    target's own attention. Word-keyed entries override the default window
    for that word's token indices (reference: ptp_utils.get_time_words_attention_alpha).
    """
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {"default_": cross_replace_steps}
    if "default_" not in cross_replace_steps:
        cross_replace_steps["default_"] = (0.0, 1.0)
    n_edit = len(prompts) - 1
    alpha = np.zeros((num_steps + 1, n_edit, max_len), dtype=np.float32)
    start, end = _bounds(cross_replace_steps["default_"], num_steps + 1)
    alpha[start:end, :, :] = 1.0
    for key, item in cross_replace_steps.items():
        if key == "default_":
            continue
        s, e = _bounds(item, num_steps + 1)
        for i in range(1, len(prompts)):
            inds = seq_aligner.get_word_inds(prompts[i], key, tokenizer)
            if len(inds):
                alpha[:, i - 1, inds] = 0.0
                alpha[s:e, i - 1, inds] = 1.0
    return alpha


def self_replace_gate(
    self_replace_steps: Union[float, Tuple[float, float]], num_steps: int
) -> np.ndarray:
    """(num_steps,) bool: steps where P2P replaces target self-attention with
    the source's (only applied at resolutions with <= 16^2 tokens)."""
    start, end = _bounds(self_replace_steps, num_steps)
    gate = np.zeros(num_steps, dtype=bool)
    gate[start:end] = True
    return gate


def masactrl_gate(
    num_steps: int,
    num_layers: int,
    start_step: int = 4,
    start_layer: int = 10,
    step_idx: Optional[Sequence[int]] = None,
    layer_idx: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """(num_steps, num_layers) bool gate for mutual self-attention.

    ``num_layers`` counts transformer blocks in forward order (16 for SD,
    70 for SDXL — masactrl/model/attention_control.py:11-14); the reference's
    ``cur_att_layer // 2`` is that same block index.
    """
    steps = np.zeros(num_steps, dtype=bool)
    steps[list(step_idx) if step_idx is not None else range(start_step, num_steps)] = True
    layers = np.zeros(num_layers, dtype=bool)
    layers[list(layer_idx) if layer_idx is not None else range(start_layer, num_layers)] = True
    return steps[:, None] & layers[None, :]


def pnp_gates(num_steps: int, pnp_attn_t: float, pnp_f_t: float) -> Tuple[np.ndarray, np.ndarray]:
    """(qk_gate, conv_gate), each (num_steps,) bool: True for the first
    ``int(num_steps * frac)`` denoising steps (pnp/model/sd_utils.py:16-20)."""
    qk = np.zeros(num_steps, dtype=bool)
    conv = np.zeros(num_steps, dtype=bool)
    qk[: int(num_steps * pnp_attn_t)] = True
    conv[: int(num_steps * pnp_f_t)] = True
    return qk, conv


def blend_alpha_layers(
    prompts: Sequence[str],
    words: Sequence[Union[str, Sequence[str]]],
    tokenizer,
    max_len: int = MAX_LEN,
) -> np.ndarray:
    """(P, 77) one-hot token weights for LocalBlend
    (reference: ptp_utils.LocalBlend.__init__)."""
    alpha = np.zeros((len(prompts), max_len), dtype=np.float32)
    for i, (prompt, ws) in enumerate(zip(prompts, words)):
        if isinstance(ws, str):
            ws = [ws]
        for w in ws:
            inds = seq_aligner.get_word_inds(prompt, w, tokenizer)
            alpha[i, inds] = 1.0
    return alpha

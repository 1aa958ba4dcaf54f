"""Token alignment between source and target prompts (host-side, NumPy).

Builds the token-index mappers / blend weights that drive the P2P
cross-attention edits. Semantics match the reference's seq_aligner
(p2p/model/seq_aligner.py): Needleman-Wunsch global alignment for "refine"
(get_refinement_mapper:121), a word-level 77x77 replacement matrix with
ratio splitting for multi-token words for "replace" (get_replacement_mapper_:152),
word->token-index lookup (get_word_inds:131), and the reweighting equalizer
(get_equalizer:197).

A copy of ``image_editing_framework_tpu/ops/seq_aligner.py``: the port keeps
its own so it imports nothing of the JAX package. Everything here runs on the
host; the outputs are small dense arrays (77-long vectors / 77x77 matrices)
that the edit loops move to the device once.

Tokenizer protocol: any object with
  encode(text) -> list[int]       (with BOS/EOS, like CLIP)
  decode_token(token_id) -> str   (single-token text, no end-of-word marker)
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

MAX_LEN = 77

# Alignment scores (reference uses gap=0, match=1, mismatch=-1,
# p2p/model/seq_aligner.py:110).
_GAP, _MATCH, _MISMATCH = 0, 1, -1


def _needleman_wunsch(xs: Sequence[int], ys: Sequence[int]) -> List[Tuple[int, int]]:
    """Global alignment; returns (y_pos, x_pos) pairs in ascending y order,
    with x_pos = -1 where y token has no aligned source token."""
    nx, ny = len(xs), len(ys)
    score = np.zeros((nx + 1, ny + 1), dtype=np.int32)
    score[1:, 0] = np.arange(1, nx + 1) * _GAP
    score[0, 1:] = np.arange(1, ny + 1) * _GAP
    # 1 = came from left (gap in x), 2 = from up (gap in y), 3 = diagonal.
    move = np.zeros((nx + 1, ny + 1), dtype=np.int8)
    move[0, 1:] = 1
    move[1:, 0] = 2
    for i in range(1, nx + 1):
        for j in range(1, ny + 1):
            diag = score[i - 1, j - 1] + (_MATCH if xs[i - 1] == ys[j - 1] else _MISMATCH)
            left = score[i, j - 1] + _GAP
            up = score[i - 1, j] + _GAP
            best = max(left, up, diag)
            score[i, j] = best
            # Tie-break order mirrors the reference (left, then up, then diag).
            if best == left:
                move[i, j] = 1
            elif best == up:
                move[i, j] = 2
            else:
                move[i, j] = 3
    pairs: List[Tuple[int, int]] = []
    i, j = nx, ny
    while i > 0 or j > 0:
        m = move[i, j]
        if m == 3:
            i -= 1
            j -= 1
            pairs.append((j, i))
        elif m == 1:
            j -= 1
            pairs.append((j, -1))
        elif m == 2:
            i -= 1
        else:  # origin
            break
    pairs.reverse()
    return pairs


def get_mapper(x: str, y: str, tokenizer, max_len: int = MAX_LEN):
    """Refinement mapper for one (source, target) prompt pair.

    Returns (mapper, alphas): mapper[n] = index into the source token axis
    providing target position n (identity continuation past the target
    length); alphas[n] = 1.0 where an aligned source token exists, else 0.
    """
    xs = tokenizer.encode(x)
    ys = tokenizer.encode(y)
    pairs = _needleman_wunsch(xs, ys)
    mapper = np.zeros(max_len, dtype=np.int64)
    alphas = np.ones(max_len, dtype=np.float32)
    n = len(pairs)
    if n:
        arr = np.asarray(pairs, dtype=np.int64)
        mapper[:n] = arr[:, 1]
        alphas[:n] = (arr[:, 1] != -1).astype(np.float32)
    mapper[n:] = len(ys) + np.arange(max_len - len(ys))
    return mapper, alphas


def get_refinement_mapper(prompts: Sequence[str], tokenizer, max_len: int = MAX_LEN):
    """(P-1, 77) mapper + (P-1, 77) alphas mapping each non-source prompt
    onto the source prompt (prompts[0])."""
    mappers, alphas = [], []
    for p in prompts[1:]:
        m, a = get_mapper(prompts[0], p, tokenizer, max_len)
        mappers.append(m)
        alphas.append(a)
    return np.stack(mappers), np.stack(alphas)


def get_word_inds(text: str, word_place: Union[int, str, Sequence[int]], tokenizer):
    """Token indices (into the encoded sequence incl. BOS) of a word.

    Matches reference get_word_inds (p2p/model/seq_aligner.py:131): walks the
    per-token decoded strings, attributing tokens to whitespace-split words by
    cumulative character length.
    """
    words = text.split(" ")
    if isinstance(word_place, str):
        places = [i for i, w in enumerate(words) if w == word_place]
    elif isinstance(word_place, int):
        places = [word_place]
    else:
        places = list(word_place)
    out: List[int] = []
    if places:
        token_ids = tokenizer.encode(text)[1:-1]  # strip BOS/EOS
        pieces = [tokenizer.decode_token(t) for t in token_ids]
        cur_len, ptr = 0, 0
        for i, piece in enumerate(pieces):
            cur_len += len(piece)
            if ptr in places:
                out.append(i + 1)  # +1 for BOS offset
            if ptr < len(words) and cur_len >= len(words[ptr]):
                ptr += 1
                cur_len = 0
    return np.array(out, dtype=np.int64)


def get_replacement_mapper_single(
    x: str, y: str, tokenizer, max_len: int = MAX_LEN
) -> np.ndarray:
    """77x77 soft permutation matrix M with base_probs @ M = replaced probs.

    Requires equal word counts (the reference raises the same error,
    p2p/model/seq_aligner.py:156-158). Multi-token replacement words spread
    mass by 1/len(target_tokens).
    """
    words_x = x.split(" ")
    words_y = y.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError(
            "attention replacement edit can only be applied on prompts with "
            f"the same length but prompt A has {len(words_x)} words and "
            f"prompt B has {len(words_y)} words."
        )
    diff = [i for i in range(len(words_y)) if words_x[i] != words_y[i]]
    src_inds = [get_word_inds(x, i, tokenizer) for i in diff]
    tgt_inds = [get_word_inds(y, i, tokenizer) for i in diff]
    mapper = np.zeros((max_len, max_len), dtype=np.float32)
    i = j = cur = 0
    while i < max_len and j < max_len:
        if cur < len(src_inds) and len(src_inds[cur]) and src_inds[cur][0] == i:
            s, t = src_inds[cur], tgt_inds[cur]
            if len(s) == len(t):
                mapper[s, t] = 1.0
            else:
                for tt in t:
                    mapper[s, tt] = 1.0 / len(t)
            cur += 1
            i += len(s)
            j += len(t)
        elif cur < len(src_inds):
            mapper[i, j] = 1.0
            i += 1
            j += 1
        else:
            mapper[j, j] = 1.0
            i += 1
            j += 1
    return mapper


def get_replacement_mapper(prompts: Sequence[str], tokenizer, max_len: int = MAX_LEN):
    """(P-1, 77, 77) stacked replacement matrices vs the source prompt."""
    return np.stack(
        [
            get_replacement_mapper_single(prompts[0], p, tokenizer, max_len)
            for p in prompts[1:]
        ]
    )


def refinement_matrix(mapper: np.ndarray, max_len: int = MAX_LEN) -> np.ndarray:
    """Convert a (77,) gather mapper into a (77, 77) matrix so that
    ``base_probs @ M`` equals ``base_probs[..., mapper]`` (entries with
    mapper == -1 contribute zero; they are masked by alphas anyway)."""
    m = np.zeros((max_len, max_len), dtype=np.float32)
    valid = mapper >= 0
    m[mapper[valid], np.nonzero(valid)[0]] = 1.0
    return m


def get_equalizer(
    text: str,
    word_select: Union[str, int, Sequence[Union[str, int]]],
    values: Sequence[float],
    tokenizer,
    max_len: int = MAX_LEN,
):
    """(len(values), 77) per-token scale factors for AttentionReweight
    (reference: p2p/model/seq_aligner.py:197)."""
    if isinstance(word_select, (int, str)):
        word_select = (word_select,)
    eq = np.ones((len(values), max_len), dtype=np.float32)
    vals = np.asarray(values, dtype=np.float32)
    for word in word_select:
        for ind in get_word_inds(text, word, tokenizer):
            eq[:, ind] = vals
    return eq

"""Word-level tokenizer for tests and random-weight runs.

Counterpart of ``WordTokenizer`` and ``pad_token_ids`` in
``image_editing_framework_tpu/models/tokenizer.py:128-176``. It needs no
vocab files and no ``regex`` module. The BPE ``CLIPTokenizer`` needs a
checkpoint's ``vocab.json``/``merges.txt`` and arrives with checkpoint
loading.

Protocol consumed by ops/seq_aligner.py:
  encode(text)            -> [BOS, ..., EOS] token ids (no padding)
  decode_token(token_id)  -> single-token text
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class WordTokenizer:
    """Whitespace word-level tokenizer with CLIP-like BOS/EOS framing.

    Ids are handed out in the order words are first seen, as the JAX
    package's tokenizer does, so the two agree on every prompt sequence.
    """

    def __init__(self, max_length: int = 77, vocab_size: int = 49408):
        self.max_length = max_length
        self.vocab_size = vocab_size
        self.bos_id = 0
        self.eos_id = vocab_size - 1
        self.vocab: Dict[str, int] = {}
        self.inv: Dict[int, str] = {}

    def _id(self, word: str) -> int:
        if word not in self.vocab:
            idx = len(self.vocab) + 1
            self.vocab[word] = idx
            self.inv[idx] = word
        return self.vocab[word]

    def encode(self, text: str) -> List[int]:
        ids = [self.bos_id] + [self._id(w) for w in text.lower().split()]
        ids = ids[: self.max_length - 1]
        ids.append(self.eos_id)
        return ids

    def decode_token(self, token_id: int) -> str:
        return self.inv.get(int(token_id), "")

    def encode_padded(self, texts: Sequence[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_length), self.eos_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            out[i, : len(ids)] = ids
        return out


def pad_token_ids(tokenizer, texts: Sequence[str], max_length: int = 77) -> np.ndarray:
    """encode_padded for any tokenizer exposing encode() (tests use fakes)."""
    if hasattr(tokenizer, "encode_padded"):
        return tokenizer.encode_padded(texts)
    eos = getattr(tokenizer, "eos_id", 0)
    out = np.full((len(texts), max_length), eos, np.int32)
    for i, t in enumerate(texts):
        ids = tokenizer.encode(t)[:max_length]
        out[i, : len(ids)] = ids
    return out

"""Tokenizers: the CLIP BPE tokenizer of real checkpoints, and a word-level
tokenizer for tests and random-weight runs.

Counterpart of ``image_editing_framework_tpu/models/tokenizer.py``:
``CLIPTokenizer`` reads a checkpoint's ``tokenizer/vocab.json`` and
``merges.txt`` (the reference loads transformers' CLIPTokenizer from the
same files, p2p/model/sd_utils.py:42-48); ``WordTokenizer`` needs no vocab
files. Neither needs the ``regex`` module: the JAX package splits text with
``regex`` and its ``\\p{L}`` / ``\\p{N}`` classes, which stdlib ``re`` lacks, so
the port splits it with ``_pretokenize``, a scanner over
``unicodedata.category`` that gives the same pieces.

Protocol consumed by ops/seq_aligner.py:
  encode(text)            -> [BOS, ..., EOS] token ids (no padding)
  decode_token(token_id)  -> single-token text
"""

from __future__ import annotations

import functools
import html
import json
import os
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

_SPECIAL = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# Under the JAX pattern's IGNORECASE a literal letter also matches its case
# variants; after ``_clean`` lowercases the text, the one variant left among
# the letters of the special tokens and the contractions is U+017F (long s).
_FOLD = {"s": "s\u017f"}
# U+0345 (combining ypogegrammeni, category Mn) matches neither ``[\p{L}]``
# nor ``[^\s\p{L}\p{N}]`` under IGNORECASE (its uppercase is a letter): the
# JAX pattern drops it as it drops a space.
_DROPPED = "\u0345"


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "L"


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == "N"


def _is_other(ch: str) -> bool:
    return not (ch.isspace() or ch in _DROPPED or _is_letter(ch) or _is_number(ch))


def _literal_at(text: str, i: int, literal: str) -> bool:
    """``literal`` matches ``text`` at ``i``, letters case-insensitively as
    the JAX pattern matches them."""
    if i + len(literal) > len(text):
        return False
    return all(c == l or c in _FOLD.get(l, "") for c, l in zip(text[i:i + len(literal)], literal))


def _pretokenize(text: str) -> List[str]:
    """The pieces that the JAX package's ``_PAT.findall`` gives for ``text``
    (``tokenizer.py:28-31``: the two special tokens, the contractions under
    IGNORECASE, runs of letters, single numerals, runs of anything else but
    whitespace), by a scan over Unicode categories. Categories are Python's
    ``unicodedata`` ones; a code point that a later Unicode version assigned
    is unassigned here and goes into a run of "anything else"."""
    out, i, n = [], 0, len(text)
    while i < n:
        literal = next((lit for lit in _SPECIAL + _CONTRACTIONS if _literal_at(text, i, lit)), None)
        if literal is not None:
            out.append(text[i:i + len(literal)])
            i += len(literal)
            continue
        ch = text[i]
        if _is_number(ch):
            out.append(ch)
            i += 1
            continue
        run = _is_letter if _is_letter(ch) else _is_other if _is_other(ch) else None
        if run is None:  # whitespace, or the dropped mark
            i += 1
            continue
        j = i + 1
        while j < n and run(text[j]):
            j += 1
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 style reversible byte->unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\u00a1"), ord("\u00ac") + 1))
        + list(range(ord("\u00ae"), ord("\u00ff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip().lower()


class CLIPTokenizer:
    """Byte-level BPE with end-of-word markers (the CLIP variant)."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]], max_length: int = 77):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.bos_id = vocab["<|startoftext|>"]
        self.eos_id = vocab["<|endoftext|>"]
        self.max_length = max_length
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_dir(cls, path: str, max_length: int = 77) -> "CLIPTokenizer":
        """Load from a directory holding vocab.json + merges.txt (the layout
        of HF checkpoints' tokenizer/ subfolder)."""
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f.read().split("\n"):
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                merges.append((a, b))
        return cls(vocab, merges, max_length)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        """Text -> [BOS, tokens..., EOS], truncated to max_length."""
        ids = [self.bos_id]
        for tok in _pretokenize(_clean(text)):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.vocab[p] for p in self._bpe(tok))
        ids = ids[: self.max_length - 1]
        ids.append(self.eos_id)
        return ids

    def decode_token(self, token_id: int) -> str:
        return self.inv_vocab.get(int(token_id), "").replace("</w>", "")

    def encode_padded(self, texts: Sequence[str]) -> np.ndarray:
        """(B, max_length) int32, padded with EOS (CLIP's pad token)."""
        out = np.full((len(texts), self.max_length), self.eos_id, np.int32)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            out[i, : len(ids)] = ids
        return out


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

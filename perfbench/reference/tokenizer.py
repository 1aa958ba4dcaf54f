"""CLIP's byte-level BPE tokenizer (OpenAI ``simple_tokenizer``), plain.

Reads ``vocab.json`` and ``merges.txt`` as a checkpoint's ``tokenizer/``
holds them. Text is cleaned (whitespace collapsed, lower-cased) and split
into runs of letters, single digits and runs of other non-space symbols,
the pieces CLIP's pattern gives for the ASCII prompts of the benchmark's
traffic; each piece is byte-encoded, marked ``</w>`` at its end, merged by
rank, and the ids are framed by BOS and EOS and padded with EOS to 77.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Tuple

_PIECES = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+")


def byte_symbols() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = list(bs)
    extra = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + extra)
            extra += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


class BPETokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]], max_length: int = 77):
        self.vocab = vocab
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.bos, self.eos = vocab["<|startoftext|>"], vocab["<|endoftext|>"]
        self.max_length = max_length
        self.symbols = byte_symbols()

    @classmethod
    def from_dir(cls, path: str) -> "BPETokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f.read().splitlines():
                if line and not line.startswith("#version"):
                    a, b = line.split()
                    merges.append((a, b))
        return cls(vocab, merges)

    def bpe(self, piece: str) -> List[str]:
        word = list(piece[:-1]) + [piece[-1] + "</w>"]
        while len(word) > 1:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(pairs, key=lambda pr: self.ranks.get(pr, float("inf")))
            if best not in self.ranks:
                break
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        return word

    def encode(self, text: str) -> List[int]:
        """[BOS, tokens..., EOS], truncated to 77."""
        text = " ".join(text.split()).strip().lower()
        ids = [self.bos]
        for piece in _PIECES.findall(text):
            piece = "".join(self.symbols[b] for b in piece.encode("utf-8"))
            ids.extend(self.vocab[t] for t in self.bpe(piece))
        return ids[: self.max_length - 1] + [self.eos]

    def padded(self, text: str) -> List[int]:
        ids = self.encode(text)
        return ids + [self.eos] * (self.max_length - len(ids))

"""The benchmark's own inputs, made from the seed: weights, items, prompts.

* Weights: every tensor of a diffusers-keyed layout drawn N(0, 0.02²) from
  one ``torch.Generator`` per module, in one call per module, on the device
  and in the dtype they are served in; norm scales centred at 1 so the
  network stays live (the convention of the framework's random weights).
* Items: a PIE-Bench directory (``mapping_file.json`` and JPEGs under
  ``annotation_images/``): each image smooth noise, a seeded 8 x 8 grid
  resized bicubically and saved at quality 90, spread over the traffic's
  categories; each prompt pair drawn from the traffic's word lists.
* A CLIP-layout BPE vocabulary in which every word of the traffic is one
  token (one merge chain per word).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference.tokenizer import byte_symbols

CLIP_VOCAB_SIZE = 49408
WEIGHT_STD = 0.02


def is_norm_scale(key: str) -> bool:
    return key.endswith(".weight") and "norm" in key.rsplit(".", 2)[-2]


def weights(shapes: Dict[str, tuple], seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """{key: tensor} for ``shapes`` from ``seed``: one draw for the module,
    then views of it."""
    keys = sorted(shapes)
    sizes = [int(np.prod(shapes[k])) for k in keys]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype).mul_(WEIGHT_STD)
    out, off = {}, 0
    for k, n in zip(keys, sizes):
        t = flat[off:off + n].view(shapes[k])
        if is_norm_scale(k):
            t.add_(1.0)
        out[k] = t
        off += n
    return out


def module_seeds(seed: int) -> Dict[str, int]:
    """One generator seed per module, from the run's seed."""
    ss = np.random.SeedSequence(seed % 2**63)
    draws = ss.generate_state(4, dtype=np.uint64)
    return {name: int(d % 2**62) for name, d in zip(("unet", "vae", "text_encoder", "text_encoder_2"), draws)}


# ------------------------------------------------------------------ traffic


def prompt_pair(rng: np.random.Generator, traffic: dict, equal: bool) -> Tuple[str, str]:
    """A source prompt of ``prompt_words`` words and its edit: equal word
    counts with one to two words replaced (P2P's replace), or one to three
    words inserted (refine)."""
    lo, hi = traffic["prompt_words"]
    words = traffic["words"]
    n_insert = 0 if equal else int(rng.integers(1, 4))
    n = int(rng.integers(lo, hi + 1 - n_insert))
    src = [words[int(i)] for i in rng.integers(0, len(words), n)]
    tgt = list(src)
    if equal:
        for pos in rng.choice(n, size=int(rng.integers(1, 3)), replace=False):
            choices = [w for w in words if w != src[pos]]
            tgt[pos] = choices[int(rng.integers(0, len(choices)))]
    else:
        for _ in range(n_insert):
            tgt.insert(int(rng.integers(0, len(tgt) + 1)), words[int(rng.integers(0, len(words)))])
    return " ".join(src), " ".join(tgt)


def items(traffic: dict, seed: int) -> List[dict]:
    """The run's item list: each item's category, prompt pair and image
    seed. Every seed gives the same mix: item k is a replace pair when k is
    even, a refine pair when it is odd, and its category cycles."""
    rng = np.random.default_rng(seed % 2**63)
    cats = traffic["categories"]
    out = []
    for k in range(traffic["items"]):
        src, tgt = prompt_pair(rng, traffic, equal=k % 2 == 0)
        out.append({"category": cats[k % len(cats)], "source": src, "target": tgt,
                    "image_seed": int(rng.integers(0, 2**31))})
    return out


def write_pie(root: str, item_list: List[dict], side: int) -> str:
    """A PIE-Bench directory of ``item_list``; returns ``root``."""
    from PIL import Image

    mapping = {}
    for k, it in enumerate(item_list):
        rel = f"{it['category']}_synthetic/{k:06d}.jpg"
        path = os.path.join(root, "annotation_images", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        grid = np.random.default_rng(it["image_seed"]).integers(0, 256, (8, 8, 3)).astype(np.uint8)
        Image.fromarray(grid).resize((side, side), Image.BICUBIC).save(path, quality=90)
        mapping[f"{k:06d}"] = {"image_path": rel, "original_prompt": it["source"], "editing_prompt": it["target"],
                               "blended_words": "", "mask": ""}
    with open(os.path.join(root, "mapping_file.json"), "w") as f:
        json.dump(mapping, f)
    return root


def sweep_order(root: str, categories) -> List[str]:
    """Item keys in the order the sweep visits them: category by category,
    each in mapping order."""
    with open(os.path.join(root, "mapping_file.json")) as f:
        mapping = json.load(f)
    order = []
    for c in categories:
        order += [os.path.splitext(r["image_path"])[0] for r in mapping.values() if r["image_path"].startswith(str(c))]
    return order


def write_vocab(directory: str, words) -> str:
    """vocab.json and merges.txt laid out as CLIP's: the 256 byte symbols,
    the same with ``</w>``, one merge chain per word (left to right, ending
    in ``word</w>``), filler ids up to the vocabulary size, then BOS and EOS."""
    symbols = list(byte_symbols().values())
    vocab = {s: i for i, s in enumerate(symbols + [s + "</w>" for s in symbols])}
    merges = {}
    for word in dict.fromkeys(w for w in words if len(w) > 1):
        piece = word[0]
        for i, ch in enumerate(word[1:], 1):
            ch = ch + "</w>" if i == len(word) - 1 else ch
            merges.setdefault((piece, ch), None)
            piece += ch
            vocab.setdefault(piece, len(vocab))
    for i in range(len(vocab), CLIP_VOCAB_SIZE - 2):
        vocab[f"<|filler{i}|>"] = i
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = CLIP_VOCAB_SIZE - 2, CLIP_VOCAB_SIZE - 1
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return directory

"""PIE-Bench dataset plumbing.

Counterpart of ``image_editing_framework_tpu/data/pie.py``. Reference:
*/dataset/pie.py — reads ``mapping_file.json`` (dict of records keyed by
image id), filters categories by image_path prefix, strips the ``[`` / ``]``
edit markers from prompts. The items are a plain list with a strided
``shard``, as in the JAX package.

The precomputed-inversion cache is the JAX package's layout, so a cache one
package writes is read by the other: ``<inversion_path>/<key>/inversion.npz``
with float32 arrays ``latent`` (1, h, w, 4), NHWC, and ``uncond_seq``
(S, 77, D). The reference's own ``.pt`` layout (an NCHW latent and a list of
(1, 77, D) embeddings) is read too.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np
import torch

# The reference sweep skips category 5 (p2p/test.py:114).
DEFAULT_CATEGORIES = (0, 1, 2, 3, 4, 6, 7, 8, 9)


@dataclasses.dataclass(frozen=True)
class PIEItem:
    key: str  # image id / relative path without extension
    image_path: str
    source_prompt: str
    target_prompt: str
    blended_words: str = ""
    mask: Optional[np.ndarray] = None


class PIE:
    """PIE-Bench items, optionally filtered to one category."""

    def __init__(self, dataset_path: str, category: Optional[int] = None):
        self.data_path = os.path.join(dataset_path, "annotation_images")
        with open(os.path.join(dataset_path, "mapping_file.json")) as f:
            mapping = json.load(f)
        self.items: List[PIEItem] = []
        for rec in mapping.values():
            rel = rec["image_path"]
            if category is not None and not rel.startswith(str(category)):
                continue
            self.items.append(PIEItem(
                key=os.path.splitext(rel)[0],
                image_path=os.path.join(self.data_path, rel),
                source_prompt=rec["original_prompt"].replace("[", "").replace("]", ""),
                target_prompt=rec["editing_prompt"].replace("[", "").replace("]", ""),
                blended_words=rec.get("blended_words", ""),
            ))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int) -> PIEItem:
        return self.items[i]

    def shard(self, index: int, count: int) -> List[PIEItem]:
        """Strided shard (every count-th item) for multi-host sweeps:
        striding balances per-category cost across shards."""
        return self.items[index::count]


class PIEPrecomputedInversion(PIE):
    """PIE items with precomputed inversion artifacts (reference
    PIE_NTI_Inversion, p2p/dataset/pie.py:25-51): ``inversion.npz`` (the
    layout above) or the reference's ``inversion_latent.pt`` /
    ``uncond_embeddings_list.pt``, converted to NHWC / stacked (S, 77, D)
    numpy on read."""

    def __init__(self, dataset_path: str, inversion_path: str, category: Optional[int] = None,
                 required_items: Optional[List[PIEItem]] = None):
        """``required_items`` narrows the completeness check to the work list
        the caller will consume (a sweep's pending items): a cache written by
        ``save_inversions`` under the default categories or by one shard
        holds no artifact for the other mapping_file entries."""
        if required_items is not None:
            if category is not None:
                raise ValueError("pass either category or required_items, not both — required_items IS the "
                                 "work list (it is not re-filtered by category)")
            self.data_path = os.path.join(dataset_path, "annotation_images")
            self.items = list(required_items)
        else:
            super().__init__(dataset_path, category)
        self.inversion_path = inversion_path
        missing = [it.key for it in self.items if self._artifact(it) is None]
        if missing:
            more = "..." if len(missing) > 5 else ""
            raise ValueError(
                f"The inversion files are not complete (missing {missing[:5]}{more}; looked for "
                f"<inversion_path>/<key>/inversion.npz or inversion_latent.pt under {self.inversion_path})")

    def _artifact(self, item: PIEItem) -> Optional[str]:
        """Path of the artifact that exists for this item (``.npz``
        preferred, the reference's ``.pt`` else), or None."""
        d = os.path.join(self.inversion_path, item.key)
        npz = os.path.join(d, "inversion.npz")
        if os.path.exists(npz):
            return npz
        pt = os.path.join(d, "inversion_latent.pt")
        return pt if os.path.exists(pt) else None

    def load_inversion(self, item: PIEItem):
        """(latent (1, h, w, 4), uncond_seq (S, 77, D) or None), float32
        numpy."""
        path = self._artifact(item)
        if path is None:
            d = os.path.join(self.inversion_path, item.key)
            raise FileNotFoundError(
                f"no inversion artifact for item {item.key!r}: expected {os.path.join(d, 'inversion.npz')} or "
                f"{os.path.join(d, 'inversion_latent.pt')}")
        if path.endswith(".npz"):
            with np.load(path) as data:
                uncond = _denpz(data["uncond_seq"]) if "uncond_seq" in data.files else None
                return _denpz(data["latent"]), uncond
        return _load_reference_inversion(os.path.dirname(path))


def _load_reference_inversion(d: str):
    """Read a reference-produced inversion cache directory
    (p2p/dataset/pie.py:47-48): ``inversion_latent.pt`` is an NCHW latent,
    ``uncond_embeddings_list.pt`` a per-step list of (1, 77, D) embeddings.
    Returns (latent NHWC (1, h, w, 4), uncond_seq (S, 77, D) or None)."""
    lat = torch.load(os.path.join(d, "inversion_latent.pt"), map_location="cpu", weights_only=True)
    latent = np.transpose(lat.float().numpy(), (0, 2, 3, 1))  # NCHW -> NHWC
    uncond = None
    upath = os.path.join(d, "uncond_embeddings_list.pt")
    if os.path.exists(upath):
        ulist = torch.load(upath, map_location="cpu", weights_only=True)
        uncond = np.stack([u.float().numpy()[0] for u in ulist])  # (S, 77, D)
    return latent, uncond


def _denpz(arr: np.ndarray) -> np.ndarray:
    """A cache array as float32. Caches written by bf16 pipelines before the
    producer stored float32 hold bfloat16, which ``np.load`` hands back as
    raw 2-byte void (``V2``): the bits are the top half of a float32's, so
    they are widened by a shift (no ``ml_dtypes`` needed)."""
    if arr.dtype == np.dtype("V2"):
        return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return arr


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def save_inversion(inversion_path: str, key: str, latent, uncond_seq=None) -> None:
    """Producer side of the precomputed-inversion cache (the reference ships
    only the consumer; p2p/test.py sets inversion_path=None): ``latent``
    (1, h, w, 4) NHWC and ``uncond_seq`` (S, 77, D), torch tensors on any
    device or arrays, stored float32, as the JAX package stores them."""
    d = os.path.join(inversion_path, key)
    os.makedirs(d, exist_ok=True)
    arrays = {"latent": _f32(latent)}
    if uncond_seq is not None:
        arrays["uncond_seq"] = _f32(uncond_seq)
    np.savez(os.path.join(d, "inversion.npz"), **arrays)

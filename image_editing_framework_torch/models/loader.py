"""Checkpoint loading: safetensors files into the port's modules.

Counterpart of ``image_editing_framework_tpu/models/loader.py`` and of the
zero-copy reader in ``image_editing_framework_tpu/native/__init__.py``. The
reference loads the same files through diffusers ``from_pretrained``
(p2p/edit_real.py:71-98).

The port's modules are named so that their ``state_dict()`` keys are the
diffusers / transformers keys a checkpoint holds, and their tensors are in
PyTorch's layout: loading copies each tensor as it is, with no key function
and no transpose (the JAX package's ``unet_key`` / ``vae_key`` /
``clip_key`` / ``to_flax_tensor`` have no counterpart here).

``MmapSafetensors`` reads a file in plain Python: the 8-byte header length,
the JSON header, then every tensor as a ``torch.frombuffer`` view over a
private (copy-on-write) memory map, so nothing is read before a tensor is
copied to its module, and BF16 comes back as ``torch.bfloat16``.
``save_safetensors`` writes the same format. No ``safetensors`` package is
needed.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}


class MmapSafetensors:
    """A ``.safetensors`` file as a read-only mapping of key -> tensor.

    Each tensor is a view of the mapped file and keeps the map alive for its
    own lifetime. A tensor whose offset in the file is not a multiple of its
    element size is copied instead (a view would be misaligned). The map is
    ``ACCESS_COPY``: writable, so ``torch.frombuffer`` takes it without a
    warning, and private, so a write to a view never reaches the file.
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n).decode("utf-8"))
            size = os.fstat(f.fileno()).st_size
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else None
        self.metadata = header.pop("__metadata__", None)
        self.meta: Dict[str, dict] = header
        self._base = 8 + n
        for key, info in header.items():
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {key} has dtype {info['dtype']}, which the reader does not know")
            start, end = info["data_offsets"]
            numel = int(np.prod(info["shape"], dtype=np.int64))
            if end - start != numel * DTYPES[info["dtype"]].itemsize or self._base + end > size:
                raise ValueError(f"{path}: tensor {key} has offsets {start}..{end} for shape {info['shape']}")

    def keys(self):
        return self.meta.keys()

    def __contains__(self, key: object) -> bool:
        return key in self.meta

    def __len__(self) -> int:
        return len(self.meta)

    def __iter__(self) -> Iterator[str]:
        return iter(self.meta)

    def __getitem__(self, key: str) -> torch.Tensor:
        info = self.meta[key]
        dtype, shape = DTYPES[info["dtype"]], tuple(info["shape"])
        start, end = (self._base + o for o in info["data_offsets"])
        if end == start:
            return torch.empty(shape, dtype=dtype)
        if start % dtype.itemsize:
            return torch.frombuffer(bytearray(self._map[start:end]), dtype=dtype).reshape(shape)
        return torch.frombuffer(self._map, dtype=dtype, count=(end - start) // dtype.itemsize,
                                offset=start).reshape(shape)

    def items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        for key in self.meta:
            yield key, self[key]


NAMES = {dtype: name for name, dtype in DTYPES.items()}


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str, dtype: Optional[torch.dtype] = None) -> int:
    """Write {key: tensor} as a ``.safetensors`` file (the format's 8-byte
    header length, JSON header padded to 8 bytes, raw little-endian data in
    key order), each floating tensor cast to ``dtype`` when given, one
    tensor at a time through host memory. Returns the bytes of tensor data."""
    def out_dtype(t):
        return dtype if dtype is not None and t.is_floating_point() else t.dtype

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for key, t in tensors.items():
        nbytes = t.numel() * out_dtype(t).itemsize
        header[key] = {"dtype": NAMES[out_dtype(t)], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob)
        for t in tensors.values():
            data = t.detach().to(out_dtype(t)).cpu().contiguous().reshape(-1)
            f.write(memoryview(data.view(torch.uint8).numpy()))
    return offset


def load_safetensors(path: str) -> MmapSafetensors:
    """The tensors of one ``.safetensors`` file, as views of its map."""
    return MmapSafetensors(path)


def load_sharded_safetensors(directory: str, base: str) -> Dict[str, torch.Tensor]:
    """Load ``base.safetensors`` or the shards its ``.index.json`` names from
    ``directory``."""
    single = os.path.join(directory, base + ".safetensors")
    if os.path.exists(single):
        return load_safetensors(single)
    with open(os.path.join(directory, base + ".safetensors.index.json")) as f:
        shards = set(json.load(f)["weight_map"].values())
    out: Dict[str, torch.Tensor] = {}
    for shard in sorted(shards):
        out.update(load_safetensors(os.path.join(directory, shard)).items())
    return out


Checkpoint = Mapping[str, Union[torch.Tensor, np.ndarray]]


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _check_keys(module: nn.Module, ckpt: Checkpoint, strict: bool) -> None:
    """Raise KeyError on a key of ``module`` that ``ckpt`` lacks (and, when
    ``strict``, on a key of ``ckpt`` that ``module`` lacks) and ValueError on
    a shape mismatch, naming the key. Reads no tensor data."""
    own = module.state_dict()
    missing = sorted(set(own) - set(ckpt.keys()))
    if missing:
        raise KeyError(f"checkpoint missing {missing[0]} ({len(missing)} keys of the module missing: {missing[:8]})")
    if strict:
        extra = sorted(set(ckpt.keys()) - set(own))
        if extra:
            raise KeyError(f"checkpoint has extra keys the module lacks: {extra[:8]}")
    for key, target in own.items():
        if tuple(ckpt[key].shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint {tuple(ckpt[key].shape)} vs module "
                             f"{tuple(target.shape)}")


def load_params(
    module: nn.Module,
    ckpt: Checkpoint,
    dtype: Optional[torch.dtype] = None,
    device: Union[str, torch.device, None] = None,
    strict: bool = False,
) -> nn.Module:
    """Fill ``module`` from ``ckpt`` ({diffusers key: tensor or array}) and
    return it.

    The JAX ``load_params`` contract: a key of the module missing from the
    checkpoint raises KeyError, a wrong shape ValueError, both naming the
    key, before anything is copied; a key the module lacks is ignored (real
    CLIP checkpoints carry ``text_model.embeddings.position_ids``) unless
    ``strict``. A module built on the ``meta`` device is cast to ``dtype``
    and materialised on ``device`` (default: the CPU) without any
    initialisation of its own (the port's modules hold parameters only, so
    the checkpoint fills every tensor ``to_empty`` made); a materialised
    module keeps its device, and its dtype unless ``dtype`` is given. Each
    tensor goes from the map to the module's device as it is stored and is
    cast there.
    """
    _check_keys(module, ckpt, strict)
    if dtype is not None:
        module = module.to(dtype=dtype)
    if any(p.is_meta for p in module.parameters()):
        module = module.to_empty(device=torch.device("cpu") if device is None else device)
    with torch.no_grad():
        for key, target in module.state_dict().items():
            src = _tensor(ckpt[key]).to(target.device)
            target.copy_(src)
    return module


def export_params(module: nn.Module) -> Dict[str, torch.Tensor]:
    """Inverse of ``load_params``: {diffusers key: tensor on the CPU}."""
    return {key: value.detach().cpu() for key, value in module.state_dict().items()}

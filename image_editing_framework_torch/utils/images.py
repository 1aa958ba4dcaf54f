"""Image IO (reference: */utils/save_image.py).

Counterpart of ``image_editing_framework_tpu/utils/images.py``. The port
reads and writes 8-bit RGB / RGBA PNG itself (``zlib`` + ``struct``, all
five row filters), so a PNG source at the model's resolution, and every
save, needs no Pillow. A JPEG, any other PNG flavour, or a resize imports
Pillow inside the call and, where it is missing, raises ImportError naming
the file and what it needed: it never returns a different image.

``resize`` is ``jax.image.resize`` with the Keys cubic kernel (``"cubic"``,
``"bicubic"``), which the JAX package's CLIP preprocessing and synthetic
source image use: the same weight matrices as JAX's
``jax/_src/image/scale.py compute_weight_mat``, applied as two products in
float32 on the tensor's device. torch's own ``"bicubic"`` is another filter
(a = -0.75, edges clamped, another antialiasing).
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # PNG colour type -> channels: truecolour, truecolour with alpha


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3 or 4) uint8 -> PNG bytes (8 bits a sample, filter 0 on
    every row, zlib level 6)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes (H, W, 3 or 4) uint8, got {img.shape} {img.dtype}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter_row(kind: int, x: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Average (3) or Paeth (4) filter of one row: sequential along
    the row (each byte depends on the one ``bpp`` to its left), so it runs
    over Python ints."""
    row, above = x.tolist(), up.tolist()
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = above[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = above[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
        row[i] = (row[i] + pred) & 0xFF
    return np.asarray(row, np.uint8)


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> (H, W, 3 or 4) uint8, for 8-bit, non-interlaced RGB or
    RGBA; None for any other PNG (palette, grey, 16-bit, interlaced), which
    the caller hands to Pillow. Raises ValueError on a damaged file."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} is damaged")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        return None
    c = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * c
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, {h * (stride + 1)} expected")
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, x = raw[y, 0], raw[y, 1:].copy()
        if kind == 1:  # Sub: a running sum of each channel along the row
            x = (np.cumsum(x.reshape(w, c).astype(np.int64), axis=0) & 0xFF).astype(np.uint8).reshape(stride)
        elif kind == 2:  # Up
            x = x + prev
        elif kind in (3, 4):  # Average, Paeth
            x = _unfilter_row(kind, x, prev, c)
        elif kind != 0:
            raise ValueError(f"PNG row {y} has filter type {kind}")
        out[y] = prev = x
    return out.reshape(h, w, c)


_CUBIC = ("cubic", "bicubic")


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel (a = -0.5) at float32 distances
    ``x`` >= 0, JAX's polynomials op by op."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near)).astype(np.float32)


def resize_weights(in_size: int, out_size: int, antialias: bool = True) -> np.ndarray:
    """(in_size, out_size) float32 weights of one axis of a cubic resize,
    JAX's ``compute_weight_mat`` computed op by op in float32 (as JAX runs
    it eagerly, and compiled without XLA's optimisations; the optimising
    compiler fuses multiply-adds and lands up to ~3e-6 away): half-pixel
    sample positions, the kernel widened by the downscale factor when
    ``antialias`` (a low-pass filter), each output's weights divided by
    their sum over the taps inside the image, and outputs whose sample
    falls outside the image set to 0."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = np.float32(max(inv_scale, 1.0) if antialias else 1.0)
    sample = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(inv_scale) - np.float32(0.5)
    weights = _keys_cubic(np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def resize(image: torch.Tensor, shape: Sequence[int], method: str = "cubic", antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(image, shape, method, antialias)`` for the cubic
    methods: every axis whose size changes is resampled by one float32
    product with its ``resize_weights`` on ``image``'s device; the others
    are left as they are."""
    if method not in _CUBIC:
        raise ValueError(f"resize supports the cubic methods {_CUBIC}, got {method!r}")
    if len(shape) != image.dim():
        raise ValueError(f"shape {tuple(shape)} has another rank than the image {tuple(image.shape)}")
    x = image.to(torch.float32)
    for d, (m, n) in enumerate(zip(image.shape, shape)):
        if m != n:
            w = torch.from_numpy(resize_weights(m, n, antialias)).to(x.device)
            x = torch.movedim(torch.movedim(x, d, -1) @ w, -1, d)
    return x


def _pillow(path: str, need: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: {need} needs Pillow, which is not installed") from e
    return Image


def load_image(path: str, height: int, width: int) -> np.ndarray:
    """Open, convert to RGB, resize to (height, width): the reference's input
    path (p2p/edit_real.py:123), uint8 (H, W, 3). An 8-bit RGB or RGBA PNG
    already at that size is read without Pillow (the alpha dropped, as
    Pillow's ``convert("RGB")`` drops it)."""
    with open(path, "rb") as f:
        data = f.read()
    img = decode_png(data) if data.startswith(_SIGNATURE) else None
    if img is not None and img.shape[:2] == (height, width):
        return np.ascontiguousarray(img[:, :, :3])
    if img is None:
        need = "reading this image (not an 8-bit non-interlaced RGB/RGBA PNG)"
    else:
        need = f"resizing it from {img.shape[1]}x{img.shape[0]} to {width}x{height}"
    Image = _pillow(path, need)
    with Image.open(path) as im:
        return np.array(im.convert("RGB").resize((width, height)))


def save_img(img: np.ndarray, save_path: str) -> None:
    """Write-then-rename: a resume-by-output check that treats an existing
    edit.png as done must never see a truncated PNG at the final name."""
    if img.ndim == 4:
        img = img[0]
    elif img.ndim != 3:
        raise ValueError("The dim of the picture is not right")
    tmp = save_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(encode_png(np.asarray(img)))
    os.replace(tmp, save_path)


def save_images(img: np.ndarray, nrow: int = 1, ncol: Optional[int] = None,
                save_path: Optional[str] = None) -> None:
    """Save each image as ``{i}.png`` plus a grid sheet ``total.png`` (the
    reference's save_images)."""
    batch = img.shape[0]
    if ncol is None:
        ncol = math.ceil(batch / nrow)
    os.makedirs(save_path, exist_ok=True)
    for i in range(batch):
        save_img(img[i], os.path.join(save_path, f"{i + 1}.png"))
    h, w = img.shape[1:3]
    sheet = np.zeros((nrow * h, ncol * w, 3), np.uint8)
    for i in range(batch):
        r, c = divmod(i, ncol)
        if r >= nrow:
            break
        sheet[r * h:(r + 1) * h, c * w:(c + 1) * w] = np.asarray(img[i])[:, :, :3]
    save_img(sheet, os.path.join(save_path, "total.png"))

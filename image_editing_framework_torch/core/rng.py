"""Seeding: one ``torch.Generator`` per seed, one stream per image.

Counterpart of ``image_editing_framework_tpu/core/rng.py``. The reference
seeds torch generators (p2p/edit_real.py:37, p2p/model/sd_utils.py:15
randn_tensor); the JAX package derives per-image streams with
``jax.random.fold_in``, which has no torch counterpart. The port's rule: the
stream of image ``index`` under ``seed`` is a generator seeded with
``per_image_seed(seed, index)``, a fixed 64-bit integer hash of the pair
(splitmix64's finaliser applied to the seed, the index mixed in, and the
finaliser again). Neighbouring seeds and indices give unrelated seeds, so no
two images share a stream (``seed + index`` would hand image 1 of seed 0 the
stream of image 0 of seed 1). The streams are not JAX's.
"""

from __future__ import annotations

import torch

from image_editing_framework_torch.core.device import DeviceLike, resolve_device

_MASK = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64: the golden-ratio increment, then its finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def per_image_seed(seed: int, index: int) -> int:
    """The 64-bit seed of image ``index``'s stream under ``seed``."""
    return _mix64(_mix64(seed & _MASK) ^ (index & _MASK))


def generator_from_seed(seed: int, device: DeviceLike = None) -> torch.Generator:
    """A generator seeded with ``seed`` on ``device`` (the card unless the
    caller passes ``device="cpu"``)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def latents_like(gen: torch.Generator, batch: int, h: int, w: int, c: int = 4,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Initial N(0, 1) latents in NHWC, on the generator's device."""
    return torch.randn((batch, h, w, c), generator=gen, device=gen.device, dtype=dtype)


def per_image_generator(seed: int, index: int, device: DeviceLike = None) -> torch.Generator:
    """Deterministic per-image stream for the PIE-Bench sweep."""
    return generator_from_seed(per_image_seed(seed, index), device)

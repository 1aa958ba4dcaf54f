"""Weights for the port's models: strict loading of diffusers-keyed arrays
(on ``models/loader.py``'s path), and a deterministic random initialiser at
production shape.

The port's UNet, VAE and CLIP modules are named so that ``state_dict()``
keys are the diffusers / transformers keys. The JAX package's
``models/loader.py:276 export_params`` produces exactly such a dict from its
Flax params (with ``unet_key`` / ``vae_key`` / ``clip_key``), which is how
the tests carry one set of weights across both frameworks.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def load_weights(module: nn.Module, arrays: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy ``{diffusers key: array or tensor}`` into ``module`` in place,
    strictly: ``models/loader.py load_params`` with ``strict=True``.

    Raises KeyError on a missing or an extra key and ValueError on a shape
    mismatch, naming the key, before anything is copied. Each tensor is
    copied to the parameter's device and cast there to its dtype (numpy
    arrays are taken without a copy where they are writable). Checkpoint
    loading (``models/registry.py``) goes through ``load_params`` without
    ``strict``, which ignores extra keys as the JAX loader does.
    """
    from image_editing_framework_torch.models.loader import load_params

    return load_params(module, arrays, strict=True)


def random_init_(module: nn.Module, seed: int, scale: float = 0.02) -> nn.Module:
    """Fill every parameter with N(0, scale²) from one seeded generator on
    the module's device, in a fixed order (the counterpart of JAX's
    ``init_utils.fast_random_params(realistic=True)``).

    Norm scales (LayerNorm / GroupNorm weights) are centred at 1 instead of
    0, so the network stays live: N(0, 0.02) scales would shrink activations
    towards 0 after a few blocks. A module on the ``meta`` device holds no
    values and is returned as it is (a full-width pipeline's shapes, built
    without memory).
    """
    device = next(module.parameters()).device
    if device.type == "meta":
        return module
    gen = torch.Generator(device=device).manual_seed(seed)
    norm_scales = {
        id(m.weight) for m in module.modules() if isinstance(m, (nn.LayerNorm, nn.GroupNorm))
    }
    with torch.no_grad():
        for _, p in sorted(module.named_parameters()):
            x = torch.randn(p.shape, generator=gen, device=device, dtype=torch.float32) * scale
            if id(p) in norm_scales:
                x += 1.0
            p.copy_(x.to(p.dtype))
    return module

"""Weights for the port's models: strict loading of diffusers-keyed arrays,
and a deterministic random initialiser at production shape.

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
    """Copy ``{diffusers key: array}`` into ``module`` in place, strictly.

    Raises KeyError on a missing or an extra key and ValueError on a shape
    mismatch, naming the key. Arrays are cast to each parameter's dtype and
    copied to its device.
    """
    own = module.state_dict()
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"weights do not match the module: missing {missing[:8]}, extra {extra[:8]}")
    for key, target in own.items():
        src = np.asarray(arrays[key])
        if tuple(src.shape) != tuple(target.shape):
            raise ValueError(f"shape mismatch for {key}: weights {src.shape} vs module {tuple(target.shape)}")
    with torch.no_grad():
        for key, target in own.items():
            target.copy_(torch.as_tensor(np.array(arrays[key])).to(target.dtype))
    return module


def random_init_(module: nn.Module, seed: int, scale: float = 0.02) -> nn.Module:
    """Fill every parameter with N(0, scale²) from one seeded generator on
    the module's device, in a fixed order (the counterpart of JAX's
    ``init_utils.fast_random_params(realistic=True)``).

    Norm scales (LayerNorm / GroupNorm weights) are centred at 1 instead of
    0, so the network stays live: N(0, 0.02) scales would shrink activations
    towards 0 after a few blocks.
    """
    device = next(module.parameters()).device
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

"""The memory layout of the convolutional networks' activations.

On a CUDA device the UNet and the VAE keep their activations channels-last
from input to output: the logical (B, C, H, W) shape over NHWC memory, which
cuDNN's NHWC convolutions and the GroupNorm kernel (``ops/group_norm.py``)
read as it is, and which the transformer blocks read as (B, HW, C) through a
view. Both derive from ``ChannelsLastNet``, whose conv weights are made
channels-last once, where the module is materialised on the card
(``channels_last_convs_``, called by ``models/loader.py load_params`` and
``pipelines.py``): a channels-last input meeting an NCHW weight makes
PyTorch copy the weight on every call. Other networks (the CLIP towers,
LPIPS) keep NCHW weights. On the CPU nothing changes: NCHW weights and
contiguous NCHW activations, the arithmetic the CPU tests hold against JAX.

The layout follows the tensor's device (``channels_last``), never a model.
"""

from __future__ import annotations

import torch
from torch import nn


def channels_last(t: torch.Tensor) -> bool:
    """Whether activations and conv weights on ``t``'s device are kept
    channels-last: on CUDA, not on the CPU."""
    return t.is_cuda


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W), channels-last where ``channels_last``
    (no copy of a contiguous NHWC input), else contiguous NCHW."""
    x = x.permute(0, 3, 1, 2)
    return x.contiguous(memory_format=torch.channels_last if channels_last(x) else torch.contiguous_format)


class ChannelsLastNet(nn.Module):
    """A network that keeps its activations channels-last where
    ``channels_last`` holds (the UNet, the VAE)."""


def channels_last_convs_(module: nn.Module) -> nn.Module:
    """Give every ``nn.Conv2d`` weight inside a ``ChannelsLastNet`` of
    ``module`` that ``channels_last`` holds channels-last memory, in place
    (the same values); returns the module."""
    for net in module.modules():
        if isinstance(net, ChannelsLastNet):
            for m in net.modules():
                if isinstance(m, nn.Conv2d) and channels_last(m.weight):
                    m.weight.data = m.weight.data.contiguous(memory_format=torch.channels_last)
    return module

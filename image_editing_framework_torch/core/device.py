"""Where the port's entry points run.

The port runs on the card. The CPU is used only when the caller asks for it
(the tests do); with no card present and none asked for, the entry points
raise instead of carrying on silently on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a torch.device, ``cuda`` when None; raises when a CUDA
    device is asked for and none is available."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: pass device='cpu' to run on the CPU")
    return device

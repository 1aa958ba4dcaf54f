"""Where the port's entry points run.

The port runs on the card. The CPU is used only when the caller asks for it
(the tests do); with no card present and none asked for, the entry points
raise instead of carrying on silently on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a torch.device, ``cuda`` when None; raises when a CUDA
    device is asked for and none is available."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: pass device='cpu' to run on the CPU")
    return device


@contextlib.contextmanager
def true_f32() -> Iterator[None]:
    """Float32 products and convolutions in true float32 while the block
    runs: TF32 off in cuBLAS and in cuDNN (where it is on by default), the
    caller's settings restored after. The quality metrics' towers run in
    it, as the JAX package runs them in float32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

"""Tracing and timing helpers.

Counterpart of ``image_editing_framework_tpu/utils/profiling.py``: a phase
annotation for the profiler's trace (and the CUDA timeline), a whole-trace
capture written as a Chrome trace, a wall-clock timer whose times cover the
device's work, and the NaN guard.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import numpy as np
import torch


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Annotate a phase (invert / nti / denoise / decode) in profiler traces:
    a ``record_function`` range, and an NVTX range when CUDA is there."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile CPU (and, where there is a card, CUDA) activity inside the
    block; on exit the trace is written to ``log_dir/trace.json`` (Chrome
    trace format, for Perfetto or chrome://tracing). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Wall-clock phase timer that waits for the device: each measurement
    ends in ``torch.cuda.synchronize()``, or, given ``result_fn``, in a host
    copy of its result."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def measure(self, name: str, result_fn=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if result_fn is not None:
            self.force(result_fn())
        elif torch.cuda.is_available():
            torch.cuda.synchronize()
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def force(self, x) -> np.ndarray:
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def enable_nan_debugging() -> None:
    """Debug-flag NaN guard: autograd's anomaly detection (a backward that
    makes a NaN raises, naming the forward op)."""
    torch.autograd.set_detect_anomaly(True)

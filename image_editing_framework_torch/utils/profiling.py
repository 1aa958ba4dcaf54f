"""Tracing and timing helpers.

Counterpart of ``image_editing_framework_tpu/utils/profiling.py``: the
program's spans and counters (``phase``), a whole-trace capture written as a
Chrome trace, a wall-clock timer whose times cover the device's work, and
the NaN guard.

The tracer is off by default, and ``phase`` then costs one flag test and
returns a shared no-op. ``enable()`` turns it on for the calling thread
(``trace(dir)`` does for its block, and ``follow_profiler`` while a torch
profiler runs); each ``phase`` then records a ``Span`` in memory on
``time.perf_counter_ns``'s clock, opens a ``record_function`` range for
torch's profiler and an NVTX range for nsys, and counts under the
innermost open span

* ``syncs``: calls that make the host wait for the device, as
  ``torch.cuda.set_sync_debug_mode("warn")`` reports them (the mode is set
  while the tracer is on; a ``sync=True`` span's own wait is not counted);
* ``device_allocs`` / ``device_frees``: the caching allocator's
  ``cudaMalloc`` / ``cudaFree`` calls over a span opened with
  ``allocs=True``;
* what the program hands to ``count``: ``graph_replays`` and
  ``graph_captures``, the inversion's CUDA graphs
  (``inversion/graphs.py``); ``attn_long_calls``, self-attention calls
  over more than 4096 query tokens (``ops/attention.py``).

``take()`` hands the spans out and clears them. Other threads record
nothing.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

SYNC_WARNING = "called a synchronizing CUDA operation"  # c10/cuda's text in sync debug mode "warn"
_NOOP = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns
    end_ns: int
    parent: int  # index of the enclosing span in the same list, -1 for none
    counts: Dict[str, int]  # syncs, device_allocs, device_frees, graph_replays, ... where counted


class _Tracer:
    """The recording state: the spans in the order they opened (None while
    open), the owner thread's stack of open spans and their counters."""

    def __init__(self):
        self.spans: List[Optional[Span]] = []
        self.stack: List[int] = []
        self.counts: List[Dict[str, int]] = []
        self.owner = 0
        self.cuda = False
        self.own_wait = False
        self._restore: Optional[Tuple] = None

    def start(self) -> None:
        self.owner = threading.get_ident()
        self.cuda = torch.cuda.is_available()
        if self.cuda:
            caught = warnings.catch_warnings()
            caught.__enter__()
            self._restore = (caught, warnings.showwarning, torch.cuda.get_sync_debug_mode())
            warnings.filterwarnings("always", message=SYNC_WARNING)
            warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
            warnings.showwarning = self._on_warning
            torch.cuda.set_sync_debug_mode("warn")

    def stop(self) -> None:
        if self._restore is not None:
            caught, _, mode = self._restore
            torch.cuda.set_sync_debug_mode(mode)
            caught.__exit__(None, None, None)
            self._restore = None

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            self._restore[1](message, category, filename, lineno, file, line)
        elif threading.get_ident() == self.owner and self.counts and not self.own_wait:
            counts = self.counts[-1]
            counts["syncs"] = counts.get("syncs", 0) + 1


def _alloc_stats() -> Tuple[int, int]:
    stats = torch.cuda.memory_stats()
    return stats.get("num_device_alloc", 0), stats.get("num_device_free", 0)


class _Phase:
    """One recorded span (the tracer is on)."""

    __slots__ = ("tracer", "name", "sync", "allocs", "index", "start", "mem", "rf")

    def __init__(self, tracer: _Tracer, name: str, sync: bool, allocs: bool):
        self.tracer, self.name, self.sync, self.allocs = tracer, name, sync, allocs

    def __enter__(self):
        t = self.tracer
        self.index = len(t.spans)
        t.spans.append(None)
        t.stack.append(self.index)
        t.counts.append({})
        self.mem = _alloc_stats() if self.allocs and t.cuda else None
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if t.cuda:
            torch.cuda.nvtx.range_push(self.name)
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc):
        t = self.tracer
        if self.sync and t.cuda:
            t.own_wait = True
            try:
                torch.cuda.synchronize()
            finally:
                t.own_wait = False
        end = time.perf_counter_ns()
        if t.cuda:
            torch.cuda.nvtx.range_pop()
        self.rf.__exit__(None, None, None)
        counts = t.counts.pop()
        if self.mem is not None:
            allocs, frees = _alloc_stats()
            counts.update(device_allocs=allocs - self.mem[0], device_frees=frees - self.mem[1])
        t.stack.pop()
        t.spans[self.index] = Span(self.name, self.start, end, t.stack[-1] if t.stack else -1, counts)


_ON = False  # the one flag the off path tests
_TRACER = _Tracer()
_FOLLOWING = False


def enable() -> None:
    """Turn the tracer on for the calling thread (nothing if it is on)."""
    global _ON
    if not _ON:
        _TRACER.start()
        _ON = True


def disable() -> None:
    """Turn the tracer off; what it recorded stays until ``take``."""
    global _ON, _FOLLOWING
    if _ON:
        _ON = _FOLLOWING = False
        _TRACER.stop()


def spans() -> List[Span]:
    """A copy of the recorded spans in the order they opened (a span still
    open reads None)."""
    return list(_TRACER.spans)


def take() -> List[Span]:
    """The recorded spans, cleared from the tracer; call it outside every
    phase."""
    if _TRACER.stack:
        raise RuntimeError(f"take() inside {len(_TRACER.stack)} open phase(s)")
    out, _TRACER.spans = _TRACER.spans, []
    return out


def follow_profiler() -> None:
    """Turn the tracer on while a torch profiler runs, and off once it has
    stopped, where ``enable`` did not turn it on. The sweep calls this at
    each group's start, so that a profile of the sweep holds its phases."""
    global _FOLLOWING
    # the profiler's own flag, set by its start and cleared by its stop
    running = getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
    if running and not _ON:
        enable()
        _FOLLOWING = True
    elif _FOLLOWING and not running:
        disable()


def stop_following() -> None:
    """Turn off a tracer that ``follow_profiler`` turned on."""
    if _FOLLOWING:
        disable()


def phase(name: str, sync: bool = False, allocs: bool = False):
    """The program's span ``name`` (group / invert / edit / step / unet /
    ...). Off, the shared no-op; on, a recorded span with a profiler range
    and an NVTX range. ``sync`` waits for the device at the span's end, only
    while the tracer is on; ``allocs`` counts the allocator's device
    allocations and frees over the span."""
    if not _ON:
        return _NOOP
    if threading.get_ident() != _TRACER.owner:
        return _NOOP
    return _Phase(_TRACER, name, sync, allocs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span (the
    tracer on, the enabling thread); off, one flag test."""
    if not _ON:
        return
    t = _TRACER
    if t.counts and threading.get_ident() == t.owner:
        counts = t.counts[-1]
        counts[name] = counts.get(name, 0) + n


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile CPU (and, where there is a card, CUDA) activity inside the
    block, with the tracer on; on exit the trace is written to
    ``log_dir/trace.json`` (Chrome trace format, for Perfetto or
    chrome://tracing). Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _ON
    enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        if not was_on:
            disable()
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

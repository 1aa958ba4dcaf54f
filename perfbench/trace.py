"""One profiled group: the device's kernels from ``torch.profiler`` (device
activity alone, so reading the trace stays quick), placed on the host's
clock by a marker kernel launched on an idle device at the capture's start.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep


class Capture:
    def __init__(self):
        self.kernels: List[Tuple[str, float, float]] = []  # name, start ns, end ns on the host clock
        self.t0_ns = self.t1_ns = 0
        self.prof = None

    @property
    def wall_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device's operation intervals (ns)."""
        out: List[List[float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def device_time(self, *tags: str) -> float:
        """Seconds of the kernels whose name holds one of ``tags``."""
        return sum(e - s for n, s, e in self.kernels if any(t in n for t in tags)) / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by[name[:120]] = by.get(name[:120], 0.0) + (e - s) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self, spans, n: int = 10) -> List[list]:
        """Idle time of the device inside the capture, summed by the
        innermost host span open when each gap began ("sweep" when none)."""
        busy = self.busy()
        edges = [self.t0_ns] + [x for iv in busy for x in iv] + [self.t1_ns]
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges) - 1, 2) if edges[k + 1] > edges[k]]
        inside = [s for s in spans if s[2] > self.t0_ns and s[1] < self.t1_ns]
        by: Dict[str, float] = {}
        for g0, g1 in gaps:
            open_ = [s for s in inside if s[1] <= g0 < s[2]]
            name = min(open_, key=lambda s: s[2] - s[1])[0] if open_ else "sweep"
            by[name] = by.get(name, 0.0) + (g1 - g0) / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def start() -> Capture:
    """Start profiling the device; ``stop`` ends the capture, and ``read``
    takes its kernels once the measured window has closed."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    cap = Capture()
    torch.cuda.synchronize()
    cap.prof = torch_profile(activities=[ProfilerActivity.CUDA])
    cap.prof.start()
    torch.cuda.synchronize()
    cap.t0_ns = time.perf_counter_ns()
    torch.cuda._sleep(1000)
    return cap


def stop(cap: Capture) -> Capture:
    torch.cuda.synchronize()
    cap.t1_ns = time.perf_counter_ns()
    cap.prof.stop()
    return cap


def read(cap: Capture) -> Capture:
    """The capture's kernels on the host clock, from its profiler's events."""
    cuda = torch.autograd.DeviceType.CUDA
    # the raw Kineto events: building the profiler's FunctionEvents for a
    # group's ~10^5 kernels takes most of a minute
    raw = [(e.name(), float(e.start_ns()), float(e.end_ns())) for e in cap.prof.profiler.kineto_results.events()
           if e.device_type() == cuda]
    markers = [r for r in raw if MARKER in r[0]]
    origin = markers[0][1] if markers else min((r[1] for r in raw), default=0.0)
    shift = cap.t0_ns - origin
    cap.kernels = [(n, s + shift, e + shift) for n, s, e in raw if MARKER not in n]
    cap.prof = None
    return cap

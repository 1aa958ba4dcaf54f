"""The program's own spans and counters on the capture's clock.

``image_editing_framework_torch/utils/profiling.py`` records spans (name,
start ns, end ns, parent index, counts) on ``time.perf_counter_ns``, the
clock ``perfbench/trace.py`` puts the device's kernels on through its marker
kernel. The port turns its tracer on while a torch profiler runs at a sweep
group's start (``follow_profiler``), so a ``--trace 1`` run holds the spans
of its profiled group. The per-layer readers take them from
``run.program_spans`` where the harness hands them over, else from the
port's tracer; a program without the tracer gives none, and its readers
return None.

    python3 perfbench/program_spans.py --workload <cell> --seed <n> --seconds <s>

runs one ``--trace 1`` run of the cell and prints, beside its result line,
what the result line has no key for: the profiled group's idle gaps named by
the program's innermost span (``idle_gaps_program``) next to the harness's
(``idle_gaps``), the syncs and allocations per span name, the spans per
group, and the clock's checks (the first kernel after each inversion UNet
span that opens on an idle device; the program's inversion seconds against
the harness's).
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Sequence


def of(run) -> list:
    """The program's spans of the run (closed ones; None where open)."""
    spans = getattr(run, "program_spans", None)
    if spans is None:
        try:
            from image_editing_framework_torch.utils import profiling
        except ImportError:
            return []
        read = getattr(profiling, "spans", None)
        spans = read() if read is not None else []
    return list(spans)


def in_capture(capture, spans) -> List[int]:
    """Indices of the spans that lie inside the capture."""
    return [i for i, s in enumerate(spans)
            if s is not None and s[1] >= capture.t0_ns and s[2] <= capture.t1_ns]


class Busy:
    """The device's busy intervals of a capture, for overlaps with spans."""

    def __init__(self, capture):
        self.iv = capture.busy()
        self.starts = [s for s, _ in self.iv]

    def within(self, a: float, b: float) -> float:
        """Busy ns inside [a, b]."""
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        total = 0.0
        while i < len(self.iv) and self.iv[i][0] < b:
            s, e = self.iv[i]
            total += max(0.0, min(e, b) - max(s, a))
            i += 1
        return total

    def first_start_after(self, t: float) -> Optional[float]:
        i = bisect.bisect_left(self.starts, t)
        return self.starts[i] if i < len(self.starts) else None

    def idle_at(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i < 0 or self.iv[i][1] <= t


def named(run, name: str):
    """(spans, indices inside the capture named ``name``), or None where
    there is no capture or no such span."""
    if run.capture is None:
        return None
    spans = of(run)
    idx = [i for i in in_capture(run.capture, spans) if spans[i][0] == name]
    return (spans, idx) if idx else None


def idle_share(run, name: str) -> Optional[float]:
    """Device idle inside the spans ``name`` over their summed length, %."""
    found = named(run, name)
    if found is None:
        return None
    spans, idx = found
    busy = Busy(run.capture)
    total = sum(spans[i][2] - spans[i][1] for i in idx)
    if total <= 0:
        return None
    return 100.0 * (total - sum(busy.within(spans[i][1], spans[i][2]) for i in idx)) / total


def steps_under(spans, parents: Sequence[int]) -> List[int]:
    """Indices of the ``step`` spans whose parent is one of ``parents``."""
    ps = set(parents)
    return [i for i, s in enumerate(spans) if s is not None and s[0] == "step" and s[3] in ps]


def inversion_steps(run):
    """(spans, the ``invert`` spans, their ``step`` spans) of the profiled
    group, or None where it has none."""
    found = named(run, "invert")
    if found is None:
        return None
    spans, invert = found
    steps = steps_under(spans, invert)
    return (spans, invert, steps) if steps else None


def below(spans, name: str, among: Sequence[int]) -> List[int]:
    """Indices in ``among`` that have an ancestor span named ``name``."""
    out = []
    for i in among:
        p = spans[i][3]
        while p >= 0 and spans[p][0] != name:
            p = spans[p][3]
        if p >= 0:
            out.append(i)
    return out


def counts_by_name(spans, among: Sequence[int], counter: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for i in among:
        n = spans[i][4].get(counter, 0)
        if n:
            out[spans[i][0]] = out.get(spans[i][0], 0) + n
    return out


# ------------------------------------------------------------ the report


def report(ctx) -> dict:
    """What a traced run's result line has no key for (module doc)."""
    cap, spans = ctx.capture, of(ctx)
    idx = in_capture(cap, spans)
    inside = [spans[i] for i in idx]
    busy = Busy(cap)
    groups = [i for i in idx if spans[i][0] == "group"]
    invert = [i for i in idx if spans[i][0] == "invert"]
    unet_under_invert = [i for i in below(spans, "invert", idx) if spans[i][0] == "unet"]
    delays = []
    for i in unet_under_invert:
        t = spans[i][1]
        k = busy.first_start_after(t)
        if busy.idle_at(t) and k is not None:
            delays.append((k - t) / 1e6)
    harness_invert = sum(e - s for n, s, e in ctx.spans if n == "invert" and s >= cap.t0_ns and e <= cap.t1_ns)
    program_invert = sum(spans[i][2] - spans[i][1] for i in invert)
    gaps_h = cap.idle_by_span(ctx.spans, n=1000)
    gaps_p = cap.idle_by_span(inside, n=1000)
    return {
        "idle_gaps": gaps_h,
        "idle_gaps_program": gaps_p,
        "idle_total_s": [sum(v for _, v in gaps_h), sum(v for _, v in gaps_p)],
        "program_syncs": counts_by_name(spans, idx, "syncs"),
        "program_device_allocs": counts_by_name(spans, idx, "device_allocs"),
        "program_device_frees": counts_by_name(spans, idx, "device_frees"),
        "groups": len(groups),
        "spans_per_group": len(below(spans, "group", idx)) / max(len(groups), 1),
        "syncs_per_group": sum(counts_by_name(spans, below(spans, "group", idx), "syncs").values())
        / max(len(groups), 1),
        "spans_by_name": {n: sum(1 for s in inside if s[0] == n) for n in sorted({s[0] for s in inside})},
        "seconds_by_name": {n: sum(s[2] - s[1] for s in inside if s[0] == n) / 1e9
                            for n in sorted({s[0] for s in inside})},
        "invert_unet_first_kernel_ms": {"n": len(delays), "median": statistics.median(delays) if delays else None,
                                        "min": min(delays, default=None), "max": max(delays, default=None)},
        "invert_s": {"program": program_invert / 1e9, "harness": harness_invert / 1e9},
    }


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from perfbench import harness
    from perfbench.run import configure

    configure()
    ap = argparse.ArgumentParser(description="one traced run of a cell with the program's span report")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    seen = {}
    read_metric = harness.read_metric

    def keep(root_, name, ctx):
        seen.setdefault("ctx", ctx)
        return read_metric(root_, name, ctx)

    harness.read_metric = keep
    result = harness.run(root, args.workload, args.seed, args.seconds, True)
    extra = report(seen["ctx"]) if seen.get("ctx") is not None and seen["ctx"].capture is not None else {}
    print(json.dumps({"workload": args.workload, "seed": args.seed, "correct": result["correct"],
                      "metrics": result["metrics"], "program": extra}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

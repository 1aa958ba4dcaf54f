"""The readers of the program's spans on a synthetic capture: hand-placed
kernels and program spans with known idle and busy nanoseconds, each new
metric against its hand count, the gaps named by the program's spans
summing to the harness-named gaps, and a program without the tracer
giving no value."""

from types import SimpleNamespace

import pytest
from conftest import REPO

from perfbench import program_spans
from perfbench.harness import read_metric
from perfbench.trace import Capture

MS = 1_000_000


def span(name, a, b, parent, **counts):
    return (name, int(a * MS), int(b * MS), parent, counts)


# a group of 2 images: the inversion's two steps, then pass 2's two steps;
# one span before the capture, one after the group, one in a later capture
SPANS = [
    span("group", 0.5, 9.5, -1),                # 0
    span("invert", 0.5, 4.0, 0, device_allocs=0),  # 1
    span("step", 0.5, 2.0, 1, syncs=1),         # 2
    span("step", 2.0, 4.0, 1),                  # 3
    span("edit", 4.0, 9.5, 0),                  # 4
    span("pass2", 5.0, 9.0, 4, syncs=2),        # 5
    span("step", 5.0, 7.0, 5),                  # 6
    span("step", 7.0, 9.0, 5),                  # 7
    span("drain", 9.6, 9.9, -1, syncs=5),       # 8: outside the group
    span("group", 20.0, 30.0, -1),              # 9: outside the capture
    span("step", 21.0, 22.0, 9, syncs=7),       # 10
]
KERNELS = [("k", 1.0, 2.0), ("k", 2.5, 3.0), ("k", 6.0, 7.0), ("k", 8.0, 9.0)]
HARNESS = [("invert", 0.4 * MS, 4.1 * MS), ("edit", 3.9 * MS, 9.55 * MS), ("denoise", 5.0 * MS, 9.0 * MS)]


def capture():
    cap = Capture()
    cap.t0_ns, cap.t1_ns = 0, 10 * MS
    cap.kernels = [(n, a * MS, b * MS) for n, a, b in KERNELS]
    return cap


def run(**kw):
    return SimpleNamespace(capture=capture(), program_spans=SPANS, spans=HARNESS, group=2, **kw)


@pytest.mark.parametrize("name, want", [
    ("invert_idle_share", 100 * 2.0 / 3.5),     # 3.5 ms of span, 1.5 busy
    ("invert_step_host_ms", (1.5 + 2.0) / 2),   # two steps of 1.5 and 2 ms
    ("invert_step_device_ms", 1.5 / 2),         # 1.5 busy ms over two steps
    ("pass2_idle_share", 100 * 2.0 / 4.0),      # 4 ms of span, 2 busy
    ("syncs_per_image", 3 / 2),                 # 1 + 2 below the group, 2 images
])
def test_each_reader_against_the_hand_count(name, want):
    assert read_metric(REPO, name, run()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["invert_idle_share", "invert_step_host_ms", "invert_step_device_ms",
                                  "pass2_idle_share", "syncs_per_image"])
def test_without_a_capture_or_program_spans_a_reader_gives_none(name, monkeypatch):
    assert read_metric(REPO, name, SimpleNamespace(capture=None, program_spans=SPANS, spans=[], group=2)) is None
    assert read_metric(REPO, name, SimpleNamespace(capture=capture(), program_spans=[], spans=[], group=2)) is None
    # a program whose profiling module has no tracer (the parent of the tracer's change)
    from image_editing_framework_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert read_metric(REPO, name, SimpleNamespace(capture=capture(), spans=[], group=2)) is None


def test_the_program_named_gaps_sum_to_the_harness_named_gaps():
    report = program_spans.report(run())
    by = dict(report["idle_gaps_program"])
    # gaps 0-1 (no span: "sweep"), 2-2.5 and 3-6 (step 3), 7-8 (step 7), 9-10 (edit)
    assert by == pytest.approx({"sweep": 0.001, "step": 0.0045, "edit": 0.001}, rel=1e-9)
    total_h, total_p = report["idle_total_s"]
    assert total_h == pytest.approx(total_p, abs=1e-12) and total_p == pytest.approx(0.0065, rel=1e-9)
    assert report["program_syncs"] == {"step": 1, "pass2": 2, "drain": 5}
    assert report["syncs_per_group"] == 3 and report["groups"] == 1 and report["spans_per_group"] == 7
    assert report["invert_s"] == {"program": pytest.approx(0.0035), "harness": pytest.approx(0.0037)}
    # the inversion has no unet span here; the first kernel after a step's start is the clock's check
    assert report["invert_unet_first_kernel_ms"]["n"] == 0


def test_busy_overlaps_match_a_brute_force_count():
    busy = program_spans.Busy(capture())
    grid = [x * 0.25 for x in range(-2, 44)]
    for a in grid:
        for b in grid:
            if b <= a:
                continue
            want = sum(max(0.0, min(e, b) - max(s, a)) for _, s, e in KERNELS) * MS
            assert busy.within(a * MS, b * MS) == pytest.approx(want, abs=1e-6)

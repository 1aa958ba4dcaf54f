"""``invert_graph_share`` on hand-placed program spans: the replays counted
under the profiled group's inversion steps over those steps, the captures
and the steps outside the capture left out, and no value without a capture
or without an inversion."""

from types import SimpleNamespace

import pytest
from conftest import REPO

from perfbench.harness import read_metric
from perfbench.trace import Capture

MS = 1_000_000


def span(name, a, b, parent, **counts):
    return (name, int(a * MS), int(b * MS), parent, counts)


def spans(replays):
    """A group whose inversion has four steps with the given replay counts
    (None: the step captured), then a later group outside the capture."""
    out = [span("group", 0.5, 9.5, -1), span("invert", 0.5, 4.5, 0)]
    for k, n in enumerate(replays):
        counts = {"graph_captures": 1} if n is None else {"graph_replays": n} if n else {}
        out.append(span("step", 0.5 + k, 1.5 + k, 1, **counts))
    out += [span("edit", 4.5, 9.5, 0), span("step", 5.0, 6.0, len(out), graph_replays=1),
            span("group", 20.0, 30.0, -1), span("invert", 20.0, 24.0, len(out) + 2),
            span("step", 20.0, 21.0, len(out) + 3, graph_replays=1)]
    return out


def run(program_spans, capture=True):
    cap = None
    if capture:
        cap = Capture()
        cap.t0_ns, cap.t1_ns = 0, 10 * MS
        cap.kernels = [("k", 1.0 * MS, 2.0 * MS)]
    return SimpleNamespace(capture=cap, program_spans=program_spans, spans=[], group=2)


@pytest.mark.parametrize("replays, want", [
    ([1, 1, 1, 1], 100.0),     # every step replayed
    ([None, 1, 1, 1], 75.0),   # a shape's first scan captures at step 0
    ([0, 0, 0, 0], 0.0),       # the eager forward: the counters exist, no replay
])
def test_the_share_against_the_hand_count(replays, want):
    assert read_metric(REPO, "invert_graph_share", run(spans(replays))) == pytest.approx(want, rel=1e-12)


def test_no_value_without_a_capture_or_an_inversion():
    assert read_metric(REPO, "invert_graph_share", run(spans([1, 1, 1, 1]), capture=False)) is None
    assert read_metric(REPO, "invert_graph_share", run([span("group", 0.5, 9.5, -1)])) is None

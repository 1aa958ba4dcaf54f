"""``norm_nhwc_share`` on hand-placed program spans: the NHWC kernel's
launches over the GroupNorm calls counted in the profiled group's spans,
the spans outside the capture left out, and no value without a capture,
without a group or without the counters."""

from types import SimpleNamespace

import pytest
from conftest import REPO

from perfbench.harness import read_metric
from perfbench.trace import Capture

MS = 1_000_000


def span(name, a, b, parent, **counts):
    return (name, int(a * MS), int(b * MS), parent, counts)


def spans(kernel_share):
    """A group whose encode, edit UNet forwards and decode count GroupNorm
    calls, ``kernel_share`` of them launching the kernel; then a later group
    outside the capture that counts calls alone."""
    def counts(calls):
        return dict(norm_calls=calls, norm_nhwc=int(calls * kernel_share))

    return [span("group", 0.5, 9.5, -1, **counts(2)), span("encode", 0.5, 1.0, 0, **counts(10)),
            span("edit", 1.0, 8.0, 0), span("unet", 1.5, 2.0, 2, **counts(60)),
            span("unet", 2.5, 3.0, 2, **counts(60)), span("decode", 8.0, 9.0, 0, **counts(28)),
            span("group", 20.0, 30.0, -1), span("unet", 21.0, 22.0, 6, norm_calls=60)]


def run(program_spans, capture=True):
    cap = None
    if capture:
        cap = Capture()
        cap.t0_ns, cap.t1_ns = 0, 10 * MS
        cap.kernels = [("k", 1.0 * MS, 2.0 * MS)]
    return SimpleNamespace(capture=cap, program_spans=program_spans, spans=[], group=4)


@pytest.mark.parametrize("kernel_share, want", [
    (1.0, 100.0),  # every call launched the kernel
    (0.5, 50.0),   # half of them did
    (0.0, 0.0),    # the counters exist, no launch
])
def test_the_share_against_the_hand_count(kernel_share, want):
    assert read_metric(REPO, "norm_nhwc_share", run(spans(kernel_share))) == pytest.approx(want, rel=1e-12)


def test_no_value_without_a_capture_a_group_or_the_counters():
    assert read_metric(REPO, "norm_nhwc_share", run(spans(1.0), capture=False)) is None
    assert read_metric(REPO, "norm_nhwc_share", run([span("unet", 1.5, 2.0, -1, norm_calls=4, norm_nhwc=4)])) is None
    assert read_metric(REPO, "norm_nhwc_share", run([span("group", 0.5, 9.5, -1), span("unet", 1.5, 2.0, 0)])) is None

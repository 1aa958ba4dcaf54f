"""``attn_long_share`` and ``attn_long_roofline`` on a hand-made capture:
kernels matched to self-attention calls by launch order, the percentages
against the hand count, and no value where the kernels, the calls and the
program's ``attn_long_calls`` counter disagree, or where there is no
capture or no call over 4096 tokens."""

from types import SimpleNamespace

import pytest
from conftest import REPO

from perfbench.harness import read_metric
from perfbench.trace import Capture

MS = 1_000_000
LONG = (4, 5, 9216, 9216, 64, False)  # SD2.1's first level at 768², inversion batch 4
MID = (4, 10, 2304, 2304, 64, False)
FLASH = "void flash_fwd_bf16<64, false, false>(CUtensorMap, CUtensorMap, CUtensorMap, Params)"


def span(name, a, b, parent, **counts):
    return (name, int(a * MS), int(b * MS), parent, counts)


def spans(first=1, second=1):
    """The profiled group: a long call in an inversion step and one in the
    edit's UNet span; a later group, outside the capture, counts 5."""
    return [span("group", 0.5, 15.0, -1), span("invert", 0.5, 9.5, 0),
            span("step", 0.5, 9.5, 1, **({"attn_long_calls": first} if first else {})),
            span("edit", 9.5, 15.0, 0), span("unet", 9.5, 14.0, 3, **({"attn_long_calls": second} if second else {})),
            span("group", 20.0, 30.0, -1, attn_long_calls=5)]


def run(calls=(LONG, MID, LONG), extra_kernel=False, program_spans=None, capture=True):
    """Flash kernels of 2, 1 and 3 ms (in that order of launch, listed out
    of order) beside a 4 ms GEMM: 10 ms busy."""
    cap = None
    if capture:
        cap = Capture()
        cap.t0_ns, cap.t1_ns = 0, 16 * MS
        cap.kernels = [(FLASH, 6.0 * MS, 9.0 * MS), ("sm90_gemm", 10.0 * MS, 14.0 * MS),
                       (FLASH, 1.0 * MS, 3.0 * MS), (FLASH, 4.0 * MS, 5.0 * MS)]
        if extra_kernel:
            cap.kernels.append((FLASH, 15.0 * MS, 15.5 * MS))
    return SimpleNamespace(capture=cap, attn_calls=list(calls), spans=[], group=4,
                           program_spans=spans() if program_spans is None else program_spans)


def _bound_s(b, h, nq, nk, d):
    """4 b h nq nk d FLOPs at 989 TFLOP/s (compute-bound at these shapes)."""
    return 4.0 * b * h * nq * nk * d / 989e12


def test_the_share_against_the_hand_count():
    # the long calls' kernels: the first and third by launch, 2 + 3 ms of 10 ms busy
    assert read_metric(REPO, "attn_long_share", run()) == pytest.approx(50.0, rel=1e-12)


def test_the_roofline_against_the_hand_count():
    want = 100.0 * 2 * _bound_s(*LONG[:5]) / 5e-3
    assert read_metric(REPO, "attn_long_roofline", run()) == pytest.approx(want, rel=1e-12)
    assert 17.0 < want < 18.0


def test_kernels_follow_the_calls_by_launch_order():
    # the long call second: its kernel is the 1 ms one
    r = run(calls=(MID, LONG, MID), program_spans=spans(first=1, second=0))
    assert read_metric(REPO, "attn_long_share", r) == pytest.approx(10.0, rel=1e-12)
    assert read_metric(REPO, "attn_long_roofline", r) == pytest.approx(100.0 * _bound_s(*LONG[:5]) / 1e-3,
                                                                       rel=1e-12)


@pytest.mark.parametrize("case", [
    "a kernel more than the calls",
    "a call more than the kernels",
    "the counter short of the long calls",
    "the counter over the long calls",
    "a program without the counter",
    "no capture",
    "no call over 4096 tokens",
])
@pytest.mark.parametrize("metric", ["attn_long_share", "attn_long_roofline"])
def test_no_value_where_the_counts_disagree(metric, case):
    r = {
        "a kernel more than the calls": lambda: run(extra_kernel=True),
        "a call more than the kernels": lambda: run(calls=(LONG, MID, LONG, MID)),
        "the counter short of the long calls": lambda: run(program_spans=spans(first=1, second=0)),
        "the counter over the long calls": lambda: run(program_spans=spans(first=2, second=1)),
        "a program without the counter": lambda: run(program_spans=spans(first=0, second=0)),
        "no capture": lambda: run(capture=False),
        "no call over 4096 tokens": lambda: run(calls=(MID, MID, MID), program_spans=spans(first=0, second=0)),
    }[case]()
    assert read_metric(REPO, metric, r) is None

"""``utils/profiling.py`` on the CPU: ``phase`` inside ``trace`` writes a
Chrome trace that names the phase, ``Timer`` accumulates per name and
``force`` returns a host copy, ``enable_nan_debugging`` switches autograd's
anomaly detection on (the test switches it back off)."""

import json
import os

import numpy as np
import torch

from image_editing_framework_torch.utils import profiling


def test_phase_inside_trace_names_the_phase(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.phase("unet_forward"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(str(tmp_path), "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "unet_forward" for e in events)


def test_timer_accumulates_and_forces():
    timer = profiling.Timer()
    for _ in range(2):
        with timer.measure("a", result_fn=lambda: torch.ones(3)):
            pass
    with timer.measure("b"):
        pass
    assert set(timer.times) == {"a", "b"} and timer.times["a"] > 0 and timer.times["b"] >= 0
    out = timer.force(torch.arange(3.0))
    assert isinstance(out, np.ndarray) and out.tolist() == [0.0, 1.0, 2.0]
    np.testing.assert_array_equal(timer.force(np.ones(2)), np.ones(2))


def test_nan_debugging_switches_anomaly_detection_on():
    assert not torch.is_anomaly_enabled()
    try:
        profiling.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert not torch.is_anomaly_enabled()

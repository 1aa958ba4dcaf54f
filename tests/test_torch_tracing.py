"""The port's tracer (``utils/profiling.py``) inside the batched sweep, on
the tiny SD pipeline on the CPU (no JAX): off, a group records nothing and
builds no span; on, a P2P and a pix2pix-zero group record exactly the
span tree of the sweep's layers, every child inside its parent; the sweep's
own spans around a group, with the tracer on by ``enable`` or by a running
torch profiler (``follow_profiler``); ``take`` clears; the long
self-attention counter; the sync and allocation counters on a card; and
``eval/sweep.py``'s tail percentiles over groups."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from image_editing_framework_torch.core.config import SamplerConfig
from image_editing_framework_torch.eval import sweep
from image_editing_framework_torch.pipelines import tiny_pipeline
from image_editing_framework_torch.utils import profiling

torch.set_num_threads(1)

STEPS, RES = 3, 32


@pytest.fixture(scope="module")
def pipe():
    return tiny_pipeline(num_steps=STEPS, device="cpu")


@pytest.fixture
def tracer():
    """The tracer off and empty before and after the test."""
    profiling.disable()
    profiling.take()
    yield profiling
    profiling.disable()
    profiling.take()


def _group(pipe, method, n=2):
    items = [SimpleNamespace(key=f"0_x/{i}", source_prompt="a cat sat", target_prompt=t)
             for i, t in enumerate(["a dog sat", "a fluffy cat sat"][:n])]
    images = [np.random.default_rng(i).integers(0, 255, (RES, RES, 3), dtype=np.uint8) for i in range(n)]
    return sweep._edit_group(pipe, method, items, images, "ddim", None, SamplerConfig(height=RES, width=RES), None,
                             None)


def tree(spans, parent=-1):
    """The spans below ``parent`` as nested (name, [children]) in order."""
    return [(s.name, tree(spans, i)) for i, s in enumerate(spans) if s.parent == parent]


def _steps(*inner):
    return [("step", [(name, []) for name in inner])] * STEPS


INVERT = ("invert", [("text_encode", [])] + _steps("unet"))
EXPECTED = {
    "p2p": [("group", [("encode", []), INVERT, ("edit", [
        ("control", []), ("text_encode", []), ("denoise", _steps("unet")), ("decode", [])])])],
    "p2z": [("group", [("encode", []), INVERT, ("edit", [
        ("text_encode", []), ("text_encode", []), ("pass1", _steps("unet")),
        ("pass2", _steps("unet", "backward", "unet")), ("decode", [])])])],
}


def test_off_a_group_records_nothing_and_builds_no_span(pipe, tracer, monkeypatch):
    def built(*a, **kw):
        raise AssertionError("the off path built a span")

    monkeypatch.setattr(profiling, "_Phase", built)
    monkeypatch.setattr(profiling, "time", SimpleNamespace(perf_counter_ns=built))
    assert not profiling._ON
    assert profiling.phase("a") is profiling.phase("b", sync=True, allocs=True) is profiling._NOOP
    _group(pipe, "p2p")
    assert profiling.take() == []


@pytest.mark.parametrize("method", sorted(EXPECTED))
def test_on_a_group_records_the_layers_tree(pipe, tracer, method):
    profiling.enable()
    _group(pipe, method)
    profiling.disable()
    spans = profiling.take()
    assert tree(spans) == EXPECTED[method]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            up = spans[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns, (s, up)
    assert not any(s.counts.get("syncs") for s in spans)  # CPU tensors: the host never waits
    assert profiling.take() == []  # take() cleared them


def _mini_pie(root, n):
    os.makedirs(os.path.join(root, "annotation_images", "0_random"))
    mapping = {}
    for i in range(n):
        rel = f"0_random/img_{i}.jpg"
        img = np.random.default_rng(i).integers(0, 255, (64, 64, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "annotation_images", rel))
        mapping[str(i)] = {"image_path": rel, "original_prompt": "a [cat] sat",
                           "editing_prompt": "a [dog] sat"}
    with open(os.path.join(root, "mapping_file.json"), "w") as f:
        json.dump(mapping, f)
    return root


@pytest.mark.parametrize("switch", ["enable", "profiler"])
def test_the_sweep_spans_around_a_group(pipe, tracer, tmp_path, switch):
    """``enable`` records the wait for the group's decoded images, the
    group, the towers and the drain; a torch profiler running at the
    group's start turns the tracer on there and the sweep's end off."""
    data = _mini_pie(str(tmp_path / "PIE"), 2)

    def run():
        sweep.run_sweep(pipe, "p2p", data, str(tmp_path / "out"), categories=(0,), resume=False, resolution=RES,
                        batch_size=2, record_metrics=False)

    if switch == "enable":
        profiling.enable()
        run()
        assert profiling._ON
        profiling.disable()
    else:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            run()
        assert not profiling._ON
    roots = [name for name, _ in tree(profiling.take())]
    assert roots == (["load_wait"] if switch == "enable" else []) + ["group", "towers", "drain"]


def test_a_profiler_stopped_before_a_group_turns_the_tracer_off(pipe, tracer):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _group(pipe, "p2p", n=1)
        assert profiling._ON
    _group(pipe, "p2p", n=1)
    assert not profiling._ON
    assert [name for name, _ in tree(profiling.take())] == ["group"]


def test_take_inside_a_phase_raises(tracer):
    profiling.enable()
    with profiling.phase("open"):
        with pytest.raises(RuntimeError):
            profiling.take()
    assert [s.name for s in profiling.take()] == ["open"]


def test_a_self_attention_call_over_4096_tokens_counts_once(tracer):
    """``ops/attention.py self_attention`` counts ``attn_long_calls`` under
    the innermost span for a query of 4100 tokens, none for 4096 (the
    longest site of SD1.5 and SDXL); off, nothing is recorded."""
    from image_editing_framework_torch.ops.attention import self_attention

    long_q, short_q = torch.zeros(1, 1, 4100, 8), torch.zeros(1, 1, 4096, 8)
    self_attention(long_q, long_q, long_q, None)
    assert profiling.take() == []
    profiling.enable()
    with profiling.phase("long"):
        self_attention(long_q, long_q, long_q, None)
    with profiling.phase("short"):
        self_attention(short_q, short_q, short_q, None)
    profiling.disable()
    long_span, short_span = profiling.take()
    assert (long_span.name, long_span.counts) == ("long", {"attn_long_calls": 1})
    assert (short_span.name, short_span.counts) == ("short", {})


@pytest.mark.cuda
def test_the_counters_count_a_sync_and_an_allocation_under_their_span(tracer):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(1024, device="cuda")
    torch.cuda.empty_cache()  # the allocation below needs a new cudaMalloc
    mode = torch.cuda.get_sync_debug_mode()
    profiling.enable()
    assert torch.cuda.get_sync_debug_mode() == 1
    with profiling.phase("outer", sync=True, allocs=True):
        with profiling.phase("copy"):
            x.cpu()
        y = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    profiling.disable()
    assert torch.cuda.get_sync_debug_mode() == mode
    del y
    outer, copy = profiling.take()
    assert copy.counts == {"syncs": 1} and copy.parent == 0
    assert "syncs" not in outer.counts  # its own wait at the end is not counted
    assert outer.counts["device_allocs"] >= 1


def test_sweep_tail_percentiles_are_over_groups(pipe, tmp_path, monkeypatch):
    """Groups of 2, 2 and 1 taking 2, 8 and 3 s: the steady mean is over
    the images after the first group, p50 / p95 / max over the two groups'
    times over their sizes (4 and 3 s an image), once a group."""
    data = _mini_pie(str(tmp_path / "PIE"), 5)
    clock = iter([0.0, 0.0, 2.0, 2.0, 10.0, 10.0, 13.0, 100.0])
    monkeypatch.setattr(sweep, "time", SimpleNamespace(perf_counter=lambda: next(clock)))
    blank = np.zeros((RES, RES, 3), np.uint8)
    monkeypatch.setattr(sweep, "_edit_group", lambda pipe, method, group, *a: [(blank, blank)] * len(group))
    stats = sweep.run_sweep(pipe, "p2p", data, str(tmp_path / "out"), categories=(0,), resume=False,
                            resolution=RES, batch_size=2, record_metrics=False)
    assert stats["images_done"] == 5
    assert stats["steady_s_per_image"] == round((4 + 4 + 3) / 3, 3)
    assert (stats["p50_s_per_image"], stats["p95_s_per_image"], stats["max_s_per_image"]) == (3.5, 3.95, 4.0)

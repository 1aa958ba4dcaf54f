"""The port's PIE-Bench sweep (``eval/sweep.py run_sweep``, batch 1) against
the JAX package's, on the mini PIE of ``tests/test_sweep.py`` and the tiny
pipelines with one set of weights (``shared_pipelines``), 4 steps at 32², in
f32 on both sides (the JAX side on its ``use_flash=False`` path, as
``tests/test_sweep.py`` runs it). Each case runs both sweeps with the same
arguments and holds the port to JAX:

- the stats: the same keys, equal counts and modes, metric means within
  ``MEAN_ATOL`` = 1e-4 of JAX's (JAX's means are of its own images, which
  differ from the port's by a level at a few pixels: up to 4e-5 dB of PSNR
  in these runs, 0 of MSE and SSIM at 5 decimals);
- every image: ``source.png`` equal, ``inversion.png`` and ``edit.png``
  within ``LEVELS`` levels of 255 per pixel (f32 on both sides, rounded to
  uint8 at the end; the limit ``tests/test_torch_cli.py`` holds
  ``edit_real``'s images to);
- the event log: strict JSON, the same lines (key, prompts, metric names),
  metrics within ``METRIC_ATOL`` of the JAX functions' values on the port's
  own images (both logs round to 5 decimals, so 1e-5 is one unit of the
  last place, plus the metrics' own limits of ``test_torch_metrics.py``).

The cases mirror the serial tests of ``tests/test_sweep.py``: resume, the
cache written by one package and read by the other in both directions,
direct inversion from a cache (audited), the metrics and a failing metric,
sharding and ``max_items``, the four methods, null-text inversion, and the
tiny SDXL pipeline. What the port does not have yet raises, naming the
ROADMAP entry: ``batch_size`` > 1 (A4), ``clip_checkpoint`` and
``lpips_weights`` (A3)."""

import json
import os

import numpy as np
import pytest
import torch

from image_editing_framework_torch.core.config import MasaCtrlConfig as TMasaCfg
from image_editing_framework_torch.data import pie as tpie
from image_editing_framework_torch.eval import metrics as tmetrics
from image_editing_framework_torch.eval import sweep as tsweep
from image_editing_framework_torch.utils.images import decode_png
from image_editing_framework_tpu.core.config import MasaCtrlConfig as JMasaCfg
from image_editing_framework_tpu.data import pie as jpie
from image_editing_framework_tpu.eval import metrics as jmetrics
from image_editing_framework_tpu.eval import sweep as jsweep
from test_sweep import mini_pie  # noqa: F401  (the JAX tests' mini PIE fixture)
from torch_port_helpers import fix_vocab, shared_pipelines

STEPS = 4
RES = 32
LEVELS = 2
METRIC_ATOL = 1.5e-5
MEAN_ATOL = 1e-4
PROMPT_WORDS = ["a cat number 0 1 2", "a dog"]


@pytest.fixture(scope="module")
def pipes():
    jpipe, tpipe = shared_pipelines(num_steps=STEPS)
    fix_vocab((jpipe, tpipe), PROMPT_WORDS)
    return jpipe, tpipe


def _strict(line):
    def reject(token):
        raise AssertionError(f"non-strict JSON token {token!r} in the event log")

    return json.loads(line, parse_constant=reject)


def _events(exp, method="p2p", shard=0):
    with open(os.path.join(exp, f"events_{method}_{shard}.jsonl")) as f:
        return sorted((_strict(line) for line in f), key=lambda r: r["key"])


def _png(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


def run_both(pipes, tmp_path, mini_pie, name, method="p2p", jax_kwargs=None, port_kwargs=None,  # noqa: F811
             **kwargs):
    """Both sweeps with the same arguments into ``<name>_jax`` / ``<name>_port``;
    returns (JAX stats, port stats, JAX exp, port exp)."""
    jpipe, tpipe = pipes
    jexp, texp = str(tmp_path / f"{name}_jax"), str(tmp_path / f"{name}_port")
    jstats = jsweep.run_sweep(jpipe, method, mini_pie, jexp, resolution=RES, use_flash=False,
                              **dict(kwargs, **(jax_kwargs or {})))
    tstats = tsweep.run_sweep(tpipe, method, mini_pie, texp, resolution=RES, **dict(kwargs, **(port_kwargs or {})))
    return jstats, tstats, jexp, texp


def check_same(jstats, tstats, jexp, texp, method="p2p", shard=0):
    """The port's stats, images and event log against JAX's (module doc)."""
    assert set(tstats) == set(jstats), set(tstats) ^ set(jstats)
    for key in ("method", "inversion_type", "inversion_type_effective", "images_done", "images_skipped"):
        assert tstats[key] == jstats[key], key
    for key in tstats:
        if key.startswith("recon_"):
            assert abs(tstats[key] - jstats[key]) <= MEAN_ATOL, (key, tstats[key], jstats[key])
    if not os.path.exists(os.path.join(jexp, f"events_{method}_{shard}.jsonl")):
        assert jstats["images_done"] == 0
        return
    jrows, trows = _events(jexp, method, shard), _events(texp, method, shard)
    assert [set(r) for r in trows] == [set(r) for r in jrows]
    for jrow, trow in zip(jrows, trows):
        for key in ("key", "source_prompt", "target_prompt"):
            assert trow[key] == jrow[key]
        src = _png(os.path.join(texp, trow["key"], "source.png"))
        np.testing.assert_array_equal(src, _png(os.path.join(jexp, jrow["key"], "source.png")))
        for f in ("inversion", "edit"):
            a = _png(os.path.join(texp, trow["key"], f + ".png")).astype(int)
            b = _png(os.path.join(jexp, jrow["key"], f + ".png")).astype(int)
            assert a.shape == b.shape == (RES, RES, 3) and a.std() > 0
            assert np.abs(a - b).max() <= LEVELS, (trow["key"], f, np.abs(a - b).max())
        if "recon_mse" in trow:
            inv = _png(os.path.join(texp, trow["key"], "inversion.png"))
            for metric in ("mse", "psnr", "ssim"):
                want = getattr(jmetrics, metric)(src, inv)
                assert abs(trow[f"recon_{metric}"] - want) <= METRIC_ATOL, (metric, trow, want)


def done_keys(exp):
    return sorted(r["key"] for r in _events(exp)) if os.path.exists(os.path.join(exp, "events_p2p_0.jsonl")) else []


def test_p2p_and_resume(pipes, tmp_path, mini_pie):  # noqa: F811
    out = run_both(pipes, tmp_path, mini_pie, "exp", categories=(0,), max_items=2)
    check_same(*out)
    assert out[1]["images_done"] == 2 and len(os.listdir(os.path.join(out[3], "0_random"))) == 2
    for exp in out[2:]:
        for f in ("source.png", "inversion.png", "edit.png"):
            assert os.path.exists(os.path.join(exp, "0_random", "img_0", f))
    # resume: the done images are skipped, and the event log is not appended to
    again = run_both(pipes, tmp_path, mini_pie, "exp", categories=(0,), max_items=2)
    assert again[0]["images_done"] == again[1]["images_done"] == 0
    assert again[0]["images_skipped"] == again[1]["images_skipped"] == 2
    check_same(*again)


@pytest.mark.parametrize("producer", ["jax", "port"])
def test_inversion_cache_across_packages(pipes, tmp_path, mini_pie, producer):  # noqa: F811
    """``save_inversions`` in both packages writes the same ``.npz`` files
    (f32, NHWC; latents within 1e-4); then each package's sweep reads the
    ``producer``'s cache through ``inversion_path``, and the two edits agree
    (and equal, in the port, its own run with the inversion)."""
    inv = {side: str(tmp_path / f"inv_{side}") for side in ("jax", "port")}
    made = run_both(pipes, tmp_path, mini_pie, "made", categories=(0,), max_items=2,
                    jax_kwargs=dict(save_inversions=inv["jax"]), port_kwargs=dict(save_inversions=inv["port"]))
    check_same(*made)
    for item in jpie.PIE(mini_pie, 0).items[:2]:
        with np.load(os.path.join(inv["jax"], item.key, "inversion.npz")) as a, \
                np.load(os.path.join(inv["port"], item.key, "inversion.npz")) as b:
            assert a.files == b.files == ["latent"]
            assert a["latent"].dtype == b["latent"].dtype == np.float32
            assert a["latent"].shape == b["latent"].shape == (1, RES // 2, RES // 2, 4)
            np.testing.assert_allclose(b["latent"], a["latent"], atol=1e-4, rtol=0)
    used = run_both(pipes, tmp_path, mini_pie, "used", categories=(0,), max_items=2,
                    inversion_path=inv[producer])
    check_same(*used)
    if producer == "port":  # the cache gives back the latent the port's own run edited
        for key in done_keys(used[3]):
            np.testing.assert_array_equal(_png(os.path.join(used[3], key, "edit.png")),
                                          _png(os.path.join(made[3], key, "edit.png")))


def test_direct_inversion_with_a_cache_is_audited(pipes, tmp_path, mini_pie):  # noqa: F811
    inv = str(tmp_path / "inv_d")
    for item in jpie.PIE(mini_pie, 0).items:
        jpie.save_inversion(inv, item.key, np.random.RandomState(2).randn(1, 16, 16, 4).astype(np.float32) * 0.1)
    with pytest.warns(UserWarning, match="replay is NOT applied"):
        out = run_both(pipes, tmp_path, mini_pie, "cache_direct", inversion_type="direct", categories=(0,),
                       max_items=1, inversion_path=inv)
    check_same(*out)
    assert out[1]["inversion_type"] == "direct" and out[1]["inversion_type_effective"].startswith("ddim")
    out = run_both(pipes, tmp_path, mini_pie, "direct", inversion_type="direct", categories=(0,), max_items=1)
    check_same(*out)
    assert out[1]["inversion_type_effective"] == "direct"


def test_metrics_recorded_and_a_failing_metric_keeps_the_stats(pipes, tmp_path, mini_pie, monkeypatch):  # noqa: F811
    out = run_both(pipes, tmp_path, mini_pie, "metrics", categories=(0,), max_items=2)
    check_same(*out)
    for col in ("recon_mse_mean", "recon_psnr_mean", "recon_ssim_mean"):
        assert np.isfinite(out[1][col])
    assert tsweep._json_safe_metrics({"recon_psnr": float("inf"), "recon_mse": 0.0}) == \
        jsweep._json_safe_metrics({"recon_psnr": float("inf"), "recon_mse": 0.0}) == \
        {"recon_psnr": None, "recon_mse": 0.0}
    out = run_both(pipes, tmp_path, mini_pie, "nometrics", categories=(0,), max_items=1, record_metrics=False)
    check_same(*out)
    assert "recon_mse_mean" not in out[1]

    def boom(*a, **kw):
        raise RuntimeError("synthetic metric failure")

    for module in (tmetrics, jmetrics):
        monkeypatch.setattr(module, "mse", boom)
    with pytest.warns(UserWarning, match="metric/event-log"):
        jstats, tstats, jexp, texp = run_both(pipes, tmp_path, mini_pie, "metricfail", categories=(0,), max_items=2)
    assert set(tstats) == set(jstats)
    assert tstats["images_done"] == 2 and tstats["metric_errors"] == jstats["metric_errors"] == 2
    assert "synthetic metric failure" in tstats["metric_error_first"] and tstats["mean_s_per_image"] is not None
    with open(os.path.join(texp, "sweep_stats_p2p_0.json")) as f:
        assert json.load(f)["metric_errors"] == 2
    for key in ("img_0", "img_1"):
        assert os.path.exists(os.path.join(texp, "0_random", key, "edit.png"))


def test_a_failing_save_raises_after_the_stats(pipes, tmp_path, mini_pie, monkeypatch):  # noqa: F811
    """A save that fails leaves the stats file written, then raises."""
    def broken(img, path):
        raise OSError("synthetic save failure")

    monkeypatch.setattr(tsweep, "save_img", broken)
    exp = str(tmp_path / "savefail")
    with pytest.raises(RuntimeError, match="stats file was still written"):
        tsweep.run_sweep(pipes[1], "p2p", mini_pie, exp, categories=(0,), max_items=1, resolution=RES)
    with open(os.path.join(exp, "sweep_stats_p2p_0.json")) as f:
        stats = json.load(f)
    assert stats["save_errors"] == 3 and "synthetic save failure" in stats["save_error_first"]


def test_shards_stride_the_whole_item_list(pipes, tmp_path, mini_pie, monkeypatch):  # noqa: F811
    """Two shards over categories 0 and 6 (four items) take alternate items
    of the whole list, as JAX's do; ``max_items`` caps each shard, counting
    the skipped; the default categories leave out none of these."""
    keys = {}
    for shard in (0, 1):
        out = run_both(pipes, tmp_path, mini_pie, f"shard{shard}", categories=(0, 6), shard_index=shard,
                       shard_count=2, record_metrics=False)
        check_same(*out, shard=shard)
        keys[shard] = sorted(r["key"] for r in _events(out[3], shard=shard))
        assert keys[shard] == sorted(r["key"] for r in _events(out[2], shard=shard))
    items = [it.key for c in (0, 6) for it in tpie.PIE(mini_pie, c).items]
    assert keys == {0: sorted(items[0::2]), 1: sorted(items[1::2])}
    out = run_both(pipes, tmp_path, mini_pie, "shard0", categories=(0, 6), shard_index=0, shard_count=2,
                   max_items=1, record_metrics=False)
    assert out[1]["images_done"] == out[0]["images_done"] == 0
    assert out[1]["images_skipped"] == out[0]["images_skipped"] == 1


@pytest.mark.parametrize("method", ["p2p", "masactrl", "pnp", "p2z"])
def test_four_methods(pipes, tmp_path, mini_pie, method):  # noqa: F811
    kw = {}
    if method == "masactrl":  # gated from the first layer and step, so that the tiny UNet's edit is controlled
        kw = dict(jax_kwargs=dict(method_kwargs={"config": JMasaCfg(start_step=1, start_layer=0)}),
                  port_kwargs=dict(method_kwargs={"config": TMasaCfg(start_step=1, start_layer=0)}))
    out = run_both(pipes, tmp_path, mini_pie, method, method=method, categories=(0,), max_items=1, **kw)
    check_same(*out, method=method)
    assert out[1]["images_done"] == 1


def test_null_text(pipes, tmp_path, mini_pie):  # noqa: F811
    inv = {side: str(tmp_path / f"nti_{side}") for side in ("jax", "port")}
    out = run_both(pipes, tmp_path, mini_pie, "nti", inversion_type="null-text", categories=(0,), max_items=1,
                   jax_kwargs=dict(save_inversions=inv["jax"]), port_kwargs=dict(save_inversions=inv["port"]))
    check_same(*out)
    key = done_keys(out[3])[0]
    with np.load(os.path.join(inv["jax"], key, "inversion.npz")) as a, \
            np.load(os.path.join(inv["port"], key, "inversion.npz")) as b:
        assert b["uncond_seq"].shape == a["uncond_seq"].shape == (STEPS, 77, 32)
        np.testing.assert_allclose(b["uncond_seq"], a["uncond_seq"], atol=1e-3, rtol=0)


def test_tiny_xl(tmp_path, mini_pie):  # noqa: F811
    jpipe, tpipe = shared_pipelines(num_steps=2, model_type="xl")
    fix_vocab((jpipe, tpipe), PROMPT_WORDS)
    out = run_both((jpipe, tpipe), tmp_path, mini_pie, "xl", categories=(0,), max_items=1)
    check_same(*out)
    assert tpipe.decode_tile_latent is None


def test_xl_decode_tile_default_is_restored(tmp_path, mini_pie, monkeypatch):  # noqa: F811
    """At 1024² an XL pipe decodes in 64-latent tiles during the sweep (the
    JAX package's memory default), and gets its own setting back after it,
    also when an edit fails; a pipe's own setting is kept."""
    from image_editing_framework_torch import cli
    from image_editing_framework_torch.pipelines import tiny_pipeline

    pipe = tiny_pipeline(num_steps=2, model_type="xl", device="cpu")
    seen = []

    def invert(pipe, image, prompt, inversion_type, method):
        assert image.shape == (1024, 1024, 3)
        return torch.zeros(1, 512, 512, 4), None, None

    def run_method(method, pipe, prompts, latent, sampler, uncond_seq, kw, source_replay=None):
        seen.append(pipe.decode_tile_latent)
        if len(seen) == 2:
            raise RuntimeError("synthetic edit failure")
        return np.zeros((1024, 1024, 3), np.uint8), np.zeros((1024, 1024, 3), np.uint8)

    monkeypatch.setattr(cli, "invert", invert)
    monkeypatch.setattr(cli, "run_method", run_method)
    tsweep.run_sweep(pipe, "p2p", mini_pie, str(tmp_path / "a"), categories=(0,), max_items=1, record_metrics=False)
    assert seen == [64] and pipe.decode_tile_latent is None
    with pytest.raises(RuntimeError, match="synthetic edit failure"):
        tsweep.run_sweep(pipe, "p2p", mini_pie, str(tmp_path / "b"), categories=(0,), max_items=1)
    assert seen == [64, 64] and pipe.decode_tile_latent is None
    pipe.decode_tile_latent = 32
    tsweep.run_sweep(pipe, "p2p", mini_pie, str(tmp_path / "c"), categories=(0,), max_items=1, record_metrics=False)
    assert seen == [64, 64, 32] and pipe.decode_tile_latent == 32


@pytest.mark.parametrize("kwargs,entry", [(dict(batch_size=2), "A4"), (dict(clip_checkpoint="clip"), "A3"),
                                          (dict(lpips_weights={}), "A3")])
def test_what_is_not_ported_raises(pipes, tmp_path, mini_pie, kwargs, entry):  # noqa: F811
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {entry}"):
        tsweep.run_sweep(pipes[1], "p2p", mini_pie, str(tmp_path / "x"), categories=(0,), resolution=RES, **kwargs)
    assert not os.path.exists(tmp_path / "x")


def test_auto_p2p_config():
    for pair in (("a cat sat", "a dog sat"), ("a cat", "a big cat")):
        assert tsweep._auto_p2p_config(*pair).edit_type == jsweep._auto_p2p_config(*pair).edit_type
    assert tsweep._auto_p2p_config("a cat sat", "a dog sat").edit_type == "replace"

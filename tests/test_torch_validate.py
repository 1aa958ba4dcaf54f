"""The port's validation runway (``eval/validate.py``) against the JAX
package's, on the tiny pipelines with one set of weights
(``shared_pipelines``), 4 steps at 32², f32 on both sides (JAX on its
``use_flash=False`` path). The synthesized start latent and the refiner's
noise are JAX's ``PRNGKey(seed)`` draws, injected into the port through
``validate.seeded_latent`` (the port draws its own from
``torch.Generator``: ROADMAP C2).

- ``validate_pipeline`` with P2P, a source image and a tiny CLIP
  checkpoint in both packages: every PNG within ``LEVELS`` = 2 levels (the
  ``edit_real`` limit of ``tests/test_torch_cli.py``); ``recon_mse`` and
  ``recon_psnr`` within ``RECON_RTOL`` = 1e-4 relative of JAX's report and
  of JAX's functions on the port's own PNGs, ``recon_ssim`` within
  ``SSIM_ATOL`` = 1e-5 of the latter (SSIM is near 0 here, and the two
  reports' images are up to 2 levels apart); the CLIP scores within 1e-4 of JAX's
  ``CLIPScore`` on the port's own PNGs, and ``recon_lpips`` within 1e-5
  relative of JAX's LPIPS on them (JAX's runway cannot compute it: ROADMAP
  C3); the report's keys JAX's less ``flash_layout`` / ``flash_bwd_layout``
  (ROADMAP C2), the port's LPIPS key added;
- the port alone over all four methods: structure, and equal hashes on a
  rerun;
- ``validate_refiner`` on the tiny refiner against JAX: the PNG within 2
  levels, the metrics held as ``recon_*`` are;
- ``main``: the same calls from the same command lines as JAX's ``main``;
- the sweep's CLIP and LPIPS columns (``run_sweep`` with
  ``clip_checkpoint`` and ``lpips_weights``) at ``batch_size`` 1 and 2, both
  sweeps held by ``tests/test_torch_sweep.py``'s ``check_same`` (stats and
  event-log keys, images), each image's ``clip_score_edit`` and
  ``lpips_src_edit`` within its ``METRIC_ATOL`` of JAX's towers on the
  port's own images (the log rounds to 5 decimals). The pipelines are that
  file's ``pipes``.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_editing_framework_torch import pipelines as tpipelines
from image_editing_framework_torch.eval import validate as tvalidate
from image_editing_framework_torch.models import registry as tregistry
from image_editing_framework_tpu import pipelines as jpipelines
from image_editing_framework_tpu.eval import lpips as jlpips
from image_editing_framework_tpu.eval import metrics as jmetrics
from image_editing_framework_tpu.eval import validate as jvalidate
from image_editing_framework_tpu.models import registry as jregistry
from image_editing_framework_tpu.utils import jax_cache
from image_editing_framework_torch.utils.images import decode_png
from test_sweep import mini_pie  # noqa: F401  (the JAX tests' mini PIE fixture)
from test_torch_clip_score import tiny_clip  # noqa: F401  (the tiny CLIP checkpoint fixture)
from test_torch_sweep import METRIC_ATOL, _events, check_same, pipes, run_both  # noqa: F401
from torch_port_helpers import chip_smoke, fix_vocab, shared_pipelines

STEPS = 4
RES = 32
SEED = 7
LEVELS = 2
RECON_RTOL = 1e-4
SSIM_ATOL = 1e-5
CLIP_ATOL = 1e-4
LPIPS_RTOL = 1e-5
JAX_ONLY = {"flash_layout", "flash_bwd_layout"}
PROMPTS = ["a gray horse in the field", "a whie horse in the field"]  # the runway's defaults
HASHES = ("syn_source_sha256", "syn_edit_sha256", "real_inversion_sha256", "real_edit_sha256")



@pytest.fixture
def jax_latents(monkeypatch):
    """The port's seeded draws replaced by JAX's: normal(PRNGKey(seed))."""
    def seeded_latent(pipe, shape, seed):
        x = np.array(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
        return torch.from_numpy(x).to(pipe.device, pipe.dtype)

    monkeypatch.setattr(tvalidate, "seeded_latent", seeded_latent)


@pytest.fixture(scope="module")
def lpips_file(tmp_path_factory):
    """(path of chip_smoke's seeded LPIPS file, JAX's LPIPS of the same weights)."""
    from safetensors.numpy import load_file

    path = str(tmp_path_factory.mktemp("lpips") / "lpips.safetensors")
    chip_smoke().write_lpips_weights(path)
    arrays = load_file(path)
    return path, jlpips.LPIPS.from_torch_files(arrays, arrays)


def _source():
    return np.random.RandomState(0).randint(0, 255, (RES, RES, 3), np.uint8)


def _png(out, sub, name):
    with open(os.path.join(out, sub, name + ".png"), "rb") as f:
        return decode_png(f.read())


def _check_metrics(entry, prefix, source, image):
    """``entry``'s MSE and PSNR within ``RECON_RTOL`` of JAX's functions on
    the same images, SSIM within ``SSIM_ATOL``: JAX's report holds them of
    its own images, up to ``LEVELS`` away, and SSIM, a difference of window
    means near 0 for these random reconstructions, carries float32 noise of
    its own (``tests/test_torch_metrics.py``'s limit)."""
    for key in ("mse", "psnr"):
        want = getattr(jmetrics, key)(source, image)
        assert abs(entry[f"{prefix}_{key}"] - want) <= RECON_RTOL * abs(want), (key, entry, want)
    assert abs(entry[f"{prefix}_ssim"] - jmetrics.ssim(source, image)) <= SSIM_ATOL


def test_validate_pipeline_p2p_matches_jax(pipes, tmp_path, jax_latents, tiny_clip, lpips_file):  # noqa: F811
    jpipe, tpipe = pipes
    fix_vocab(pipes, PROMPTS)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(methods=("p2p",), source_image=_source(), resolution=RES, seed=SEED, clip_checkpoint=tiny_clip)
    want = jvalidate.validate_pipeline(jpipe, jout, use_flash=False, **kw)
    got = tvalidate.validate_pipeline(tpipe, tout, lpips_weights=lpips_file[0], **kw)

    assert set(got) == set(want) - JAX_ONLY
    assert got["backend"] == "cpu" and want["backend"] == "cpu"
    for key in set(got) - {"methods"}:
        assert got[key] == want[key], key
    entry, ref = got["methods"]["p2p"], want["methods"]["p2p"]
    assert set(entry) == set(ref) | {"recon_lpips"}
    for name in ("syn_source", "syn_edit", "real_inversion", "real_edit"):
        a, b = _png(tout, "p2p", name).astype(int), _png(jout, "p2p", name).astype(int)
        assert a.shape == b.shape and a.std() > 0 and np.abs(a - b).max() <= LEVELS, (name, np.abs(a - b).max())
    for key in ("recon_mse", "recon_psnr"):
        assert abs(entry[key] - ref[key]) <= RECON_RTOL * abs(ref[key]), (key, entry[key], ref[key])
    _check_metrics(entry, "recon", _source(), _png(tout, "p2p", "real_inversion"))
    clip = jmetrics.CLIPScore(tiny_clip)
    for flow in ("syn", "real"):
        assert abs(entry[f"{flow}_clip_score"] - clip(_png(tout, "p2p", f"{flow}_edit")[None], [PROMPTS[1]])) \
            <= CLIP_ATOL
    want_lpips = lpips_file[1](_source()[None], _png(tout, "p2p", "real_inversion")[None])
    assert entry["recon_lpips"] > 0 and abs(entry["recon_lpips"] - want_lpips) <= LPIPS_RTOL * want_lpips
    with open(os.path.join(tout, "report.json")) as f:
        assert json.load(f) == got
    assert os.path.exists(os.path.join(tout, "report.md"))


def test_validate_pipeline_four_methods(pipes, tmp_path, tiny_clip, lpips_file):  # noqa: F811
    tpipe = pipes[1]
    out = str(tmp_path / "all")
    report = tvalidate.validate_pipeline(tpipe, out, source_image=_source(), resolution=RES, seed=SEED,
                                         clip_checkpoint=tiny_clip, lpips_weights=lpips_file[0], sd_version="1.5")
    assert tuple(report["methods"]) == tvalidate.METHODS == jvalidate.METHODS
    assert report["provenance"] == "loaded checkpoint" and report["sd_version"] == "1.5"
    for method, entry in report["methods"].items():
        assert all(len(entry[k]) == 64 and int(entry[k], 16) >= 0 for k in HASHES), method
        assert all(np.isfinite(entry[k]) for k in ("recon_mse", "recon_psnr", "recon_ssim", "recon_lpips"))
        assert all(0.0 <= entry[k] <= 100.0 for k in ("syn_clip_score", "real_clip_score"))
        assert entry["syn_elapsed_s"] >= 0 and entry["real_elapsed_s"] >= 0
        for name in ("syn_source", "syn_edit", "real_inversion", "real_edit"):
            assert _png(out, method, name).dtype == np.uint8
    with open(os.path.join(out, "report.md")) as f:
        table = f.read()
    assert all(f"| {m} | `{report['methods'][m]['syn_edit_sha256'][:16]}` |" in table for m in tvalidate.METHODS)
    # deterministic: the same seed and weights give the same hashes
    again = tvalidate.validate_pipeline(tpipe, str(tmp_path / "again"), methods=("p2p",), source_image=_source(),
                                        resolution=RES, seed=SEED)
    assert {k: again["methods"]["p2p"][k] for k in HASHES} == {k: report["methods"]["p2p"][k] for k in HASHES}
    # the synthesized flow alone
    syn = tvalidate.validate_pipeline(tpipe, str(tmp_path / "syn"), methods=("pnp",), resolution=RES, seed=SEED)
    assert set(syn["methods"]["pnp"]) == {"syn_elapsed_s", "syn_source_sha256", "syn_edit_sha256"}


def test_validate_refiner_matches_jax(tmp_path, jax_latents):
    jpipe, tpipe = shared_pipelines(num_steps=STEPS, model_type="xl-refiner")
    fix_vocab((jpipe, tpipe), PROMPTS)
    image = np.random.RandomState(1).randint(0, 255, (RES, RES, 3), np.uint8)
    kw = dict(source_image=image, strength=0.5, seed=SEED, resolution=RES)
    want = jvalidate.validate_refiner(jpipe, str(tmp_path / "jax"), use_flash=False, **kw)
    got = tvalidate.validate_refiner(tpipe, str(tmp_path / "port"), **kw)
    assert set(got) == set(want) - JAX_ONLY
    for key in ("flow", "seed", "strength", "resolution", "num_steps", "model_type", "backend",
                "decode_tile_latent", "provenance"):
        assert got[key] == want[key], key
    # the PNG encoders differ (zlib here, Pillow there): the pixels are the same
    for out in ("port", "jax"):
        with open(os.path.join(tmp_path, out, "source.png"), "rb") as f:
            np.testing.assert_array_equal(decode_png(f.read()), image)
    with open(os.path.join(tmp_path, "port", "refined.png"), "rb") as f:
        refined = decode_png(f.read())
    with open(os.path.join(tmp_path, "jax", "refined.png"), "rb") as f:
        b = decode_png(f.read()).astype(int)
    assert refined.shape == (RES, RES, 3) and refined.std() > 0 and np.abs(refined.astype(int) - b).max() <= LEVELS
    _check_metrics(got, "refine", image, refined)
    again = tvalidate.validate_refiner(tpipe, str(tmp_path / "again"), **kw)
    assert again["refined_sha256"] == got["refined_sha256"]


def _record_main(monkeypatch, validate, registry, pipelines, dtype_name):
    """Run ``validate.main`` with the loaders and the two flows replaced by
    recorders; returns a function argv -> the calls it made."""
    calls = []

    def pipe(version):
        model_type = "xl" if version.startswith("xl") else "sd"
        return types.SimpleNamespace(model_type=model_type, decode_tile_latent=None, refiner=None, version=version)

    def load(kind):
        def loader(sd_version, num_steps, dtype=None, **kw):
            calls.append((kind, sd_version, num_steps, dtype_name(dtype), kw))
            return pipe(sd_version)
        return loader

    def flow(name, result):
        def run(p, out_dir, **kw):
            calls.append((name, p.version, out_dir, {k: (None if v is None else np.asarray(v).tolist())
                                                     if k == "source_image" else v for k, v in kw.items()}))
            calls.append(("decode_tile_latent", p.decode_tile_latent))
            return result
        return run

    monkeypatch.setattr(registry, "load_pipeline", load("load_pipeline"))
    monkeypatch.setattr(pipelines, "random_pipeline", load("random_pipeline"))
    monkeypatch.setattr(validate, "validate_pipeline", flow("validate_pipeline", {"methods": {}}))
    monkeypatch.setattr(validate, "validate_refiner",
                        flow("validate_refiner", {"refined_sha256": "0" * 64, "refine_ssim": 1.0}))

    def main(argv):
        del calls[:]
        validate.main(argv)
        return list(calls)

    return main


@pytest.mark.parametrize("argv", [
    ["--path", "ckpt", "--out", "v"],
    ["--random_weights", "--sd_version", "xl", "--methods", "p2p,pnp", "--seed", "3", "--num_steps", "4",
     "--report_name", "r", "--inversion_type", "null-text", "--clip_checkpoint", "c", "--lpips_weights", "l",
     "--source_prompt", "a cat", "--target_prompt", "a dog", "--resolution", "64"],
    ["--sd_version", "xl-refiner", "--source_image", "synth", "--resolution", "64", "--random_weights"],
    ["--sd_version", "xl-refiner", "--resolution", "1024"],
    ["--sd_version", "xl", "--decode_tile", "32", "--source_image", "synth", "--resolution", "64"],
    ["--sd_version", "xl", "--methods", "p2z"],
])
def test_main_makes_jaxs_calls(monkeypatch, argv):
    # JAX's main points the compilation cache at a directory of its own: keep the suite's
    monkeypatch.setattr(jax_cache, "compilation_cache_dir", lambda: jax.config.jax_compilation_cache_dir)
    min_compile = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        want = _record_main(monkeypatch, jvalidate, jregistry, jpipelines, lambda d: jnp.dtype(d).name)(argv)
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile)
    got = _record_main(monkeypatch, tvalidate, tregistry, tpipelines, lambda d: str(d).replace("torch.", ""))(argv)
    assert got == want and got[0][3] == "bfloat16"


@pytest.mark.parametrize("batch_size", [1, 2])
def test_sweep_clip_and_lpips_columns(pipes, tmp_path, mini_pie, tiny_clip, lpips_file, batch_size):  # noqa: F811
    out = run_both(pipes, tmp_path, mini_pie, f"towers{batch_size}", categories=(0,), batch_size=batch_size,
                   clip_checkpoint=tiny_clip, jax_kwargs=dict(lpips_weights=lpips_file[1].params),
                   port_kwargs=dict(lpips_weights=lpips_file[0]))
    check_same(*out)
    tstats, texp = out[1], out[3]
    assert tstats["images_done"] == 3 and "metric_errors" not in tstats
    clip, lpips = jmetrics.CLIPScore(tiny_clip), lpips_file[1]
    rows = _events(texp)
    for row in rows:
        src, edit = (_png(texp, row["key"], name) for name in ("source", "edit"))
        assert abs(row["clip_score_edit"] - clip(edit[None], [row["target_prompt"]])) <= METRIC_ATOL, row
        want = lpips(src[None], edit[None])
        assert want > 0 and abs(row["lpips_src_edit"] - want) <= METRIC_ATOL, (row, want)
    for key in ("clip_score_edit", "lpips_src_edit"):
        assert abs(tstats[f"{key}_mean"] - np.mean([r[key] for r in rows])) <= METRIC_ATOL, key


def test_a_failing_tower_is_a_metric_error(pipes, tmp_path, mini_pie, lpips_file, monkeypatch):  # noqa: F811
    from image_editing_framework_torch.eval import lpips as tlpips

    def fail(self, a, b):
        raise RuntimeError("synthetic tower failure")

    monkeypatch.setattr(tlpips.LPIPS, "distances", fail)
    from image_editing_framework_torch.eval import sweep as tsweep

    with pytest.warns(UserWarning, match="synthetic tower failure"):
        stats = tsweep.run_sweep(pipes[1], "p2p", mini_pie, str(tmp_path / "x"), categories=(0,), resolution=32,
                                 batch_size=2, lpips_weights=lpips_file[0])
    assert stats["images_done"] == 3 and stats["metric_errors"] == 3
    assert "synthetic tower failure" in stats["metric_error_first"] and "lpips_src_edit_mean" not in stats
    rows = _events(str(tmp_path / "x"))
    assert len(rows) == 3 and all("recon_mse" in r and "lpips_src_edit" not in r for r in rows)

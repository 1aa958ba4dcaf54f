"""The port's counterparts of the repo-root tools
(``image_editing_framework_torch/tools/``), on the CPU.

* ``convert_checkpoint``: against the JAX tool on the same single file, for
  each family, tensor for tensor, bitwise. The file is small but has the
  full key set of SD1.5, SD2.1 (with the 24 OpenCLIP resblocks and the
  ``text_projection`` a real SD2.x file carries) and SDXL: every key of the
  full-width modules, each tensor cut to at most 3 along every axis (fp16).
  One difference is the JAX tool's: ``safetensors.numpy.save_file`` writes a
  transposed view's memory in storage order, so its ``text_projection.weight``
  (OpenCLIP's x @ W transposed by the converter) comes out untransposed; the
  port writes the converter's tensor.
* the 24th OpenCLIP block: both converters keep it, both loaders ignore it
  (a tiny tower written with one block more than its config has).
* ``golden_check``: exits 0 on a matching report, 1 on a changed hash, 2 on
  a TPU report, on a loaded-checkpoint report without ``--path`` and on a
  method the report lacks; the pipeline built small by replacing
  ``random_pipeline``'s ``_build`` function.
* ``validate_real_weights``: ``eval/validate.py main`` with its flags, to
  ``./validation_torch`` by default.
* the rehearsals and the shard demo end to end on the tiny pipeline (2-4
  images, subprocesses on the CPU).
"""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from image_editing_framework_torch import pipelines as tpipelines
from image_editing_framework_torch.eval import validate as tvalidate
from image_editing_framework_torch.models import clip as tclip
from image_editing_framework_torch.models import configs as tconfigs
from image_editing_framework_torch.models import convert_ldm as port_convert
from image_editing_framework_torch.models.loader import load_params, save_safetensors
from image_editing_framework_torch.models.unet import UNet2DCondition
from image_editing_framework_torch.models.vae import TINY_VAE, AutoencoderKL, VAEConfig
from image_editing_framework_torch.tools import (
    concurrent_shard_demo,
    convert_checkpoint,
    golden_check,
    nti_cache_rehearsal,
    sweep_rehearsal,
    validate_real_weights,
)
from image_editing_framework_tpu.models import clip as jclip
from image_editing_framework_tpu.models import convert_ldm as jax_convert
from image_editing_framework_tpu.models import loader
from torch_port_helpers import chip_smoke, n, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """A root ``tools/*.py`` of the JAX package as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _small(state, seed):
    """Every tensor of ``state`` (meta or real) as an fp16 tensor of the same
    rank, each axis cut to at most 3, seeded values."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn([min(s, 3) for s in v.shape], generator=gen).to(torch.float16) if v.is_floating_point()
            else torch.zeros([min(s, 3) for s in v.shape], dtype=v.dtype) for k, v in state.items()}


def _meta_state(cls, cfg):
    with torch.device("meta"):
        return cls(cfg).state_dict()


def full_key_single_file(family, path):
    """A single file with every key of ``family``'s full-width checkpoint,
    small tensors. SD2.1's text tower has 24 resblocks and a
    ``text_projection``, as real SD2.x files do."""
    cs = chip_smoke()
    ucfg = {"sd": tconfigs.SD15_UNET, "sd21": tconfigs.SD21_UNET, "xl": tconfigs.SDXL_UNET}[family]
    state = {**cs.to_ldm_unet(_small(_meta_state(UNet2DCondition, ucfg), 0), ucfg),
             **cs.to_ldm_vae(_small(_meta_state(AutoencoderKL, VAEConfig()), 1), VAEConfig())}
    if family == "sd":
        text = dict(_small(_meta_state(tclip.CLIPTextModel, tclip.CLIP_VIT_L), 2), **cs.clip_position_ids())
        state.update({f"cond_stage_model.transformer.{k}": v for k, v in text.items()})
    elif family == "sd21":
        tower = _small(_meta_state(tclip.CLIPTextModel, dataclasses.replace(tclip.OPEN_CLIP_VIT_H, num_layers=24,
                                                                            projection_dim=1024)), 2)
        state.update(cs.to_open_clip(tower, "cond_stage_model.model."))
    else:
        text = dict(_small(_meta_state(tclip.CLIPTextModel, tclip.CLIP_VIT_L), 2), **cs.clip_position_ids())
        state.update({f"conditioner.embedders.0.transformer.{k}": v for k, v in text.items()})
        state.update(cs.to_open_clip(_small(_meta_state(tclip.CLIPTextModel, tclip.OPEN_CLIP_BIG_G), 3),
                                     "conditioner.embedders.1.model."))
    save_safetensors(state, path)
    return state


@pytest.mark.parametrize("family", ["sd", "sd21", "xl"])
def test_convert_checkpoint_matches_the_jax_tool(tmp_path, monkeypatch, family):
    src = str(tmp_path / "model.safetensors")
    full_key_single_file(family, src)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert convert_checkpoint.main([src, port_dir, "--family", family]) == 0
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", src, jax_dir, "--family", family])
    _jax_tool("convert_checkpoint").main()
    subs = ["unet", "vae", "text_encoder"] + (["text_encoder_2"] if family == "xl" else [])
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir)) == sorted(subs)
    for sub in subs:
        base = "model" if sub.startswith("text") else "diffusion_pytorch_model"
        got = load_file(os.path.join(port_dir, sub, base + ".safetensors"))
        want = load_file(os.path.join(jax_dir, sub, base + ".safetensors"))
        assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
        for key, value in want.items():
            assert got[key].dtype == value.dtype == np.float16 or key.endswith("position_ids"), key
            if key == "text_projection.weight":
                continue  # the JAX tool's storage-order write (the module docstring)
            np.testing.assert_array_equal(got[key], value, err_msg=f"{sub}/{key}")
    text = load_file(os.path.join(port_dir, "text_encoder" if family == "sd21" else subs[-1], "model.safetensors"))
    if family == "sd21":
        assert "text_model.encoder.layers.23.mlp.fc2.bias" in text  # the 24th block, kept as JAX keeps it
    if family != "sd":
        w = load_file(src)[("cond_stage_model.model." if family == "sd21" else "conditioner.embedders.1.model.")
                           + "text_projection"]
        np.testing.assert_array_equal(text["text_projection.weight"], w.T)
        jtext = load_file(os.path.join(jax_dir, "text_encoder" if family == "sd21" else subs[-1], "model.safetensors"))
        np.testing.assert_array_equal(jtext["text_projection.weight"].reshape(-1), w.reshape(-1))


def test_24th_open_clip_block_is_kept_and_ignored_as_in_jax(tmp_path):
    """An SD2.x single file whose OpenCLIP tower has one resblock more than
    the config: both converters keep it, both loaders ignore it, and the
    towers they load agree (1e-4, f32); a strict load names it."""
    cs = chip_smoke()
    tiny = dict(hidden_size=32, num_layers=3, num_heads=2, intermediate_size=128, hidden_act="gelu",
                projection_dim=None, vocab_size=64)
    tcfg, jcfg = dataclasses.replace(tclip.TINY_CLIP, **tiny), dataclasses.replace(jclip.TINY_CLIP, **tiny)
    longer = tclip.CLIPTextModel(dataclasses.replace(tcfg, num_layers=4))
    gen = torch.Generator().manual_seed(0)
    state = {k: torch.randn(v.shape, generator=gen) * 0.02 + k.endswith(("norm1.weight", "norm2.weight",
                                                                         "final_layer_norm.weight"))
             for k, v in longer.state_dict().items()}
    ldm = cs.to_open_clip(state, "cond_stage_model.model.")
    got = port_convert.convert_ldm_text(ldm)
    want = jax_convert.convert_ldm_text({k: v.numpy() for k, v in ldm.items()})
    assert set(got) == set(want) and "text_model.encoder.layers.3.mlp.fc1.weight" in got
    with torch.device("meta"):
        meta = tclip.CLIPTextModel(tcfg)
    tower = load_params(meta, got, torch.float32, "cpu")
    with torch.device("meta"), pytest.raises(KeyError, match="layers.3"):
        load_params(tclip.CLIPTextModel(tcfg), got, strict=True)
    jtower = jclip.CLIPTextModel(jcfg)
    skeleton = jax.eval_shape(lambda: jtower.init(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32)))
    params = loader.load_params(skeleton, want, loader.clip_key)
    ids = np.random.RandomState(1).randint(0, 63, (2, 77)).astype(np.int32)
    ref = jtower.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        out = tower(t(ids).long())
    np.testing.assert_allclose(n(out["last_hidden_state"]), n(ref["last_hidden_state"]), atol=1e-4, rtol=0)


# ----------------------------------------------------------------- golden_check

STEPS, RES, SEED = 2, 32, 42


@pytest.fixture
def tiny_random_pipeline(monkeypatch):
    """``random_pipeline`` builds the tiny modules: its ``_build`` maps each
    production config to the tiny one (the vocabulary kept at 49408, which
    its tokenizer uses)."""
    real = tpipelines._build
    tiny = {UNet2DCondition: tconfigs.TINY_UNET, AutoencoderKL: TINY_VAE,
            tclip.CLIPTextModel: dataclasses.replace(tclip.TINY_CLIP, vocab_size=49408)}

    def build(cls, config, device, dtype, seed):
        return real(cls, tiny[cls], device, dtype, seed)

    monkeypatch.setattr(tpipelines, "_build", build)


@pytest.fixture
def anchor(tmp_path, tiny_random_pipeline):
    """A report of the port's runway: P2P on the random (tiny) pipeline, the
    synthesized source image, as ``validate_real_weights --random_weights``
    writes it."""
    pipe = tpipelines.random_pipeline("1.5", STEPS, dtype=torch.bfloat16, seed=SEED, device="cpu")
    out = str(tmp_path / "anchor" / "1.5")
    tvalidate.validate_pipeline(pipe, out, methods=("p2p",), source_image=tvalidate.synth_source_image(SEED, RES),
                                seed=SEED, resolution=RES, provenance=f"random_weights seed={SEED} "
                                "(pipelines.random_pipeline)", sd_version="1.5")
    return os.path.join(out, "report.json")


def _rewrite(path, tmp_path, name, change):
    with open(path) as f:
        report = json.load(f)
    change(report)
    new = str(tmp_path / name)
    with open(new, "w") as f:
        json.dump(report, f)
    return new


def test_golden_check_exit_codes(anchor, tmp_path, capsys):
    run = lambda report, *more: golden_check.main(["--report", report, "--device", "cpu", *more])  # noqa: E731
    assert run(anchor, "--out", str(tmp_path / "rerun")) == 0
    with open(tmp_path / "rerun" / "report.json") as f, open(anchor) as g:
        assert json.load(f)["methods"]["p2p"]["real_edit_sha256"] == json.load(g)["methods"]["p2p"]["real_edit_sha256"]
    assert "golden check OK: 4 hashes match" in capsys.readouterr().out

    changed = _rewrite(anchor, tmp_path, "changed.json",
                       lambda r: r["methods"]["p2p"].update(real_edit_sha256="0" * 64))
    assert run(changed) == 1
    assert "GOLDEN REGRESSION: 1/4 hashes changed (real_edit_sha256)" in capsys.readouterr().out

    tpu = _rewrite(anchor, tmp_path, "tpu.json", lambda r: r.update(backend="tpu"))
    assert run(tpu) == 2
    assert "produced on a TPU" in capsys.readouterr().out
    assert run(os.path.join(ROOT, "validation", "1.5", "report.json")) == 2  # the JAX package's goldens, read only
    loaded = _rewrite(anchor, tmp_path, "loaded.json", lambda r: r.update(provenance="loaded checkpoint"))
    assert run(loaded) == 2
    assert "--path" in capsys.readouterr().out
    assert run(anchor, "--method", "pnp") == 2


def test_validate_real_weights_defaults_to_its_own_out(monkeypatch):
    seen = []
    monkeypatch.setattr(tvalidate, "main", lambda argv: seen.append(list(argv)))
    assert validate_real_weights.main(["--sd_version", "2.1", "--random_weights"]) == 0
    assert validate_real_weights.main(["--out", "elsewhere"]) == 0
    assert validate_real_weights.main(["--out=x"]) == 0
    assert seen == [["--sd_version", "2.1", "--random_weights", "--out", "./validation_torch"], ["--out", "elsewhere"],
                    ["--out=x"]]


# -------------------------------------------------- rehearsals and the shard demo

TINY_FLAGS = ["--tiny", "--device", "cpu", "--num_steps", "2", "--resolution", "32"]


@pytest.fixture
def one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_sweep_rehearsal_kills_and_resumes(tmp_path, one_thread):
    out = str(tmp_path / "rehearsal.json")
    assert sweep_rehearsal.main(["--n", "4", "--batch_size", "1", "--kill_after_images", "1", "--root",
                                 str(tmp_path / "root"), "--out", out, *TINY_FLAGS]) == 0
    with open(out) as f:
        result = json.load(f)
    assert result["resume_verified"] and result["final_images_done"] == 4
    assert 1 <= result["phase_a_images_done"] <= 4
    assert result["phase_b_stats"]["images_skipped"] >= result["phase_a_images_done"] - 1


def test_nti_cache_rehearsal_produces_then_consumes(tmp_path, one_thread):
    out = str(tmp_path / "nti.json")
    assert nti_cache_rehearsal.main(["--n", "2", "--batch_size", "2", "--root", str(tmp_path / "root"), "--out", out,
                                     *TINY_FLAGS]) == 0
    with open(out) as f:
        result = json.load(f)
    assert result["cache_files"] == 2 and result["cache_bytes"] > 0
    assert result["produce_stats"]["images_done"] == result["consume_stats"]["images_done"] == 2
    assert result["consume_images_done"] == 2 and result["consume_stats"]["inversion_type_effective"] == "null-text"


def test_concurrent_shard_demo(tmp_path, one_thread):
    out = str(tmp_path / "shards.json")
    assert concurrent_shard_demo.main(["--n", "4", "--shards", "2", "--num_steps", "2", "--root",
                                       str(tmp_path / "root"), "--out", out]) == 0
    with open(out) as f:
        result = json.load(f)
    assert result["images_done_total"] == result["images_on_disk"] == 4
    assert sorted(result["per_shard"]) == ["0", "1"]
    assert all(s["images_done"] == 2 for s in result["per_shard"].values())


def test_tools_keep_their_jax_twins_flags():
    """Every flag of each JAX tool is a flag of its port, with its default
    (the output paths excepted: the port's default to files of its own)."""
    import argparse

    def flags(main, argv):
        seen = {}

        def parse(self, args=None, namespace=None):
            seen.update({a.dest: a.default for a in self._actions if a.dest != "help"})
            raise SystemExit(0)

        real = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = parse
        try:
            with pytest.raises(SystemExit):
                main(argv)
        finally:
            argparse.ArgumentParser.parse_args = real
        return seen

    for name, port in (("convert_checkpoint", convert_checkpoint), ("golden_check", golden_check),
                       ("sweep_rehearsal", sweep_rehearsal), ("nti_cache_rehearsal", nti_cache_rehearsal),
                       ("concurrent_shard_demo", concurrent_shard_demo)):
        jax_main = _jax_tool(name).main
        want = flags(lambda argv: jax_main(), [])
        got = flags(port.main, [])
        assert set(want) <= set(got), (name, set(want) - set(got))
        for dest, default in want.items():
            if dest not in ("out", "report", "root"):
                assert got[dest] == default, (name, dest)

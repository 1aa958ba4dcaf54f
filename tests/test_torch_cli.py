"""The port's edit entry points (``cli.edit_real_main`` / ``edit_syn_main``)
and its shim table (``shims.py``) against the JAX package's.

``edit_real_main`` goes through ``load_pipe`` and the registry on a fake
SD checkpoint directory (``test_torch_registry.py``'s), DDIM inversion and
the p2p shim's refine edit, in both packages in f32 (``load_pipe`` patched
to that dtype, 4 steps, 32² as ``tests/test_cli.py`` runs it). Limit:
``exp/inversion.png`` and ``exp/edit.png`` within 2 levels per pixel of the
JAX package's (f32 on both sides, rounded to uint8 at the end; ``source.png``
equal). ``edit_syn_main``, the MasaCtrl flags and null-text inversion run on
the tiny pipeline, as ``tests/test_cli.py`` runs them. Each of the twelve
JAX shims (``edit_real``, ``edit_syn`` and the PIE-Bench ``test`` of each
method), run with ``runpy`` and its entry patched to record the call,
passes what the port's table holds. ``test_main`` parses JAX's flags into
the same ``run_sweep`` call, and runs the sweep through the p2p shim on the
tiny pipeline and the mini PIE of ``tests/test_sweep.py``."""

import dataclasses
import os
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import image_editing_framework_tpu.cli as jax_cli
from image_editing_framework_torch import cli, sd_mapping, shims
from image_editing_framework_torch.models import registry
from image_editing_framework_torch.pipelines import tiny_pipeline
from image_editing_framework_torch.utils.images import decode_png
from image_editing_framework_tpu import sd_mapping as jax_sd_mapping
from image_editing_framework_tpu.core import config as jax_config
from image_editing_framework_tpu.models import registry as jax_registry
from test_sweep import mini_pie  # noqa: F401  (the JAX tests' mini PIE fixture)
from test_torch_registry import PROMPTS, ckpts  # noqa: F401  (the fake checkpoints fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 4
LEVELS = 2


def _png(path):
    with open(path, "rb") as f:
        return decode_png(f.read())


def test_edit_real_main_matches_jax(ckpts, monkeypatch, tmp_path):  # noqa: F811
    jspec, pspec = ckpts["sd_spec"]
    for mapping, table, spec in ((sd_mapping, registry.VERSION_SPECS, pspec),
                                 (jax_sd_mapping, jax_registry.VERSION_SPECS, jspec)):
        monkeypatch.setitem(mapping.sd_maps, "1.5", ckpts["sd"])
        monkeypatch.setitem(table, "1.5", spec)
    real_port, real_jax = cli.load_pipe, jax_cli.load_pipe
    seen = []

    def port_load_pipe(sd_version, dtype=None, device=None):
        seen.append(device)
        return real_port(sd_version, dtype=torch.float32, device="cpu")

    monkeypatch.setattr(cli, "load_pipe", port_load_pipe)
    monkeypatch.setattr(jax_cli, "load_pipe", lambda v, dtype=None: real_jax(v, dtype=jnp.float32))
    for module in (cli, jax_cli):
        monkeypatch.setattr(module, "NUM_INFERENCE_STEPS", STEPS)
        monkeypatch.setattr(module, "resolution_for", lambda pipe: 32)
    source = (np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)
    Image.fromarray(source).save(tmp_path / "source.png")
    argv = ["--source_image", str(tmp_path / "source.png"), "--inversion_type", "ddim",
            "--source_prompt", PROMPTS[0], "--target_prompt", PROMPTS[1]]
    method, kwargs = shims.SHIMS["p2p", "edit_real"]
    out = {}
    for name, run in (("port", lambda: cli.edit_real_main(method, argv=argv, **kwargs)),
                      ("jax", lambda: jax_cli.edit_real_main("p2p", argv=argv, method_kwargs={
                          "config": jax_config.P2PConfig(edit_type="refine", cross_replace_steps=0.8,
                                                         self_replace_steps=0.6)}))):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        run()
        out[name] = {f: np.asarray(Image.open(os.path.join("exp", f + ".png"))) for f in
                     ("source", "inversion", "edit")}
        if name == "port":  # the port's own reader gives Pillow's pixels
            for f, img in out[name].items():
                np.testing.assert_array_equal(_png(os.path.join("exp", f + ".png")), img)
    assert seen == [torch.device("cuda", 0)]  # the card unless a test moves it
    np.testing.assert_array_equal(out["port"]["source"], source)
    np.testing.assert_array_equal(out["jax"]["source"], source)
    for f in ("inversion", "edit"):
        a, b = out["port"][f].astype(int), out["jax"][f].astype(int)
        assert a.shape == b.shape == (32, 32, 3) and a.std() > 0
        assert np.abs(a - b).max() <= LEVELS, (f, np.abs(a - b).max())


@pytest.fixture()
def tiny_env(monkeypatch, tmp_path):
    pipe = tiny_pipeline(num_steps=STEPS, device="cpu")
    monkeypatch.setattr(cli, "load_pipe", lambda v, dtype=None, device=None: pipe)
    monkeypatch.setattr(cli, "resolution_for", lambda p: 32)
    monkeypatch.chdir(tmp_path)
    img = (np.random.RandomState(1).rand(32, 32, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save("test.jpg")
    return pipe


def test_edit_syn_main(tiny_env):
    cli.edit_syn_main("p2p", argv=["--seed", "7", "--source_prompt", "a cat sat", "--target_prompt", "a dog sat"])
    for f in ("source", "edit"):
        img = _png(os.path.join("exp", f + ".png"))
        assert img.shape[2] == 3 and img.dtype == np.uint8


def test_edit_syn_main_masactrl_flags(tiny_env):
    cli.edit_syn_main("masactrl", argv=["--source_prompt", "a cat", "--target_prompt", "a standing cat",
                                        "--neg_prompt", "ugly, blurry", "--step_idx", "1,3", "--layer_idx", "0,1"])
    assert os.path.exists("exp/edit.png")


def test_edit_real_main_null_text_from_a_jpeg(tiny_env):
    """null-text inversion, the reference's default, on a JPEG source (read
    and resized by Pillow)."""
    cli.edit_real_main("p2p", argv=["--source_image", "./test.jpg", "--source_prompt", "a cat",
                                    "--target_prompt", "a dog"])
    for f in ("source", "inversion", "edit"):
        assert _png(os.path.join("exp", f + ".png")).shape == (32, 32, 3)


def _record_jax_shim(monkeypatch, directory, entry):
    calls = []
    for name in ("edit_real_main", "edit_syn_main", "test_main"):
        monkeypatch.setattr(jax_cli, name, lambda method, **kw: calls.append((method, kw)))
    monkeypatch.syspath_prepend(os.path.join(ROOT, directory))
    monkeypatch.setattr(sys, "argv", [entry + ".py"])
    runpy.run_path(os.path.join(ROOT, directory, entry + ".py"), run_name="__main__")
    assert len(calls) == 1
    return calls[0]


def _fields(kwargs):
    """The call's keyword arguments with configs as dicts."""
    out = dict(kwargs)
    if "method_kwargs" in out:
        out["method_kwargs"] = {k: (type(v).__name__, dataclasses.asdict(v)) for k, v in out["method_kwargs"].items()}
    return out


@pytest.mark.parametrize("directory,name", [("p2p", "p2p"), ("masactrl", "masactrl"), ("pnp", "pnp"),
                                            ("pix2pix-zero", "p2z")])
@pytest.mark.parametrize("entry", ["edit_real", "edit_syn", "test"])
def test_shim_table_matches_the_jax_shims(monkeypatch, directory, name, entry):
    method, kwargs = _record_jax_shim(monkeypatch, directory, entry)
    port_method, port_kwargs = shims.SHIMS[name, entry]
    assert port_method == method == name
    assert _fields(port_kwargs) == _fields(kwargs)


def test_shims_main_dispatches(monkeypatch):
    calls = []
    monkeypatch.setattr(cli, "edit_real_main", lambda method, argv=None, **kw: calls.append(("real", method, argv, kw)))
    monkeypatch.setattr(cli, "edit_syn_main", lambda method, argv=None, **kw: calls.append(("syn", method, argv, kw)))
    monkeypatch.setattr(cli, "test_main", lambda method, argv=None, **kw: calls.append(("test", method, argv, kw)))
    shims.main(["pnp", "edit_real", "--seed", "3"])
    shims.main(["p2z", "edit_syn"])
    for method in ("p2p", "masactrl", "pnp", "p2z"):
        shims.main([method, "test", "--exp_path", "out"])
    assert calls == [("real", "pnp", ["--seed", "3"], shims.SHIMS["pnp", "edit_real"][1]),
                     ("syn", "p2z", [], shims.SHIMS["p2z", "edit_syn"][1])] + [
        ("test", method, ["--exp_path", "out"], {}) for method in ("p2p", "masactrl", "pnp", "p2z")]
    for argv in ([], ["p2p"], ["pix2pix-zero", "edit_real"], ["pix2pix-zero", "test"], ["p2p", "sweep"]):
        with pytest.raises(SystemExit, match="usage"):
            shims.main(argv)


def test_parser_matches_jax():
    for kw in (dict(real=True, method="masactrl"), dict(real=False, default_seed=8888), dict(real=True)):
        port, ref = cli.common_parser("x", **kw), jax_cli.common_parser("x", **kw)
        assert vars(port.parse_args([])) == vars(ref.parse_args([]))


TEST_ARGVS = [[], ["--sd_version", "xl-base", "--seed", "3", "--dataset_path", "d", "--exp_path", "e",
                   "--inversion_type", "null-text", "--resume", "--shard_index", "1", "--shard_count", "4",
                   "--batch_size", "1", "--inversion_path", "i", "--save_inversions", "s"]]


@pytest.mark.parametrize("argv", TEST_ARGVS)
def test_test_main_flags_match_jax(monkeypatch, argv):
    """``test_main`` parses the JAX entry's flags, with its defaults, into
    the same ``load_pipe`` and ``run_sweep`` calls (the JAX call's
    ``use_flash`` aside: the port has none)."""
    import image_editing_framework_tpu.eval.sweep as jax_sweep
    from image_editing_framework_torch.eval import sweep as port_sweep

    calls = {}
    for name, module, sweep in (("port", cli, port_sweep), ("jax", jax_cli, jax_sweep)):
        monkeypatch.setattr(module, "load_pipe", lambda version, name=name: calls.setdefault(name, [version]) and name)
        monkeypatch.setattr(sweep, "run_sweep", lambda *a, name=name, **kw: calls[name].append((a, kw)))
    cli.test_main("pnp", argv=list(argv), method_kwargs={"x": 1})
    jax_cli.test_main("pnp", argv=list(argv), method_kwargs={"x": 1})
    port_call, jax_call = calls["port"], calls["jax"]
    assert port_call[0] == jax_call[0] == ("xl-base" if argv else "1.5")
    assert port_call[1][0] == ("port", "pnp") + jax_call[1][0][2:] and jax_call[1][0][:2] == ("jax", "pnp")
    assert port_call[1][1] == jax_call[1][1] and port_call[1][1]["method_kwargs"] == {"x": 1}


def test_test_main_runs_the_sweep_through_the_shim(tiny_env, mini_pie, monkeypatch):  # noqa: F811
    """``shims p2p test`` on the tiny pipeline over the mini PIE: its four
    items (categories 0 and 6, both in the default categories), their
    images, the event log and the stats; run again, it resumes."""
    import json

    from image_editing_framework_torch.eval import sweep as port_sweep

    real = port_sweep.run_sweep
    monkeypatch.setattr(port_sweep, "run_sweep", lambda *a, **kw: real(*a, resolution=32, **kw))
    shims.main(["p2p", "test", "--dataset_path", mini_pie, "--exp_path", "out"])
    with open(os.path.join("out", "sweep_stats_p2p_0.json")) as f:
        stats = json.load(f)
    assert stats["images_done"] == 4 and stats["images_skipped"] == 0 and stats["method"] == "p2p"
    for key in ("0_random/img_0", "0_random/img_1", "0_random/img_2", "6_other/img"):
        for name in ("source", "inversion", "edit"):
            assert _png(os.path.join("out", key, name + ".png")).shape == (32, 32, 3)
    with open(os.path.join("out", "events_p2p_0.jsonl")) as f:
        assert len(f.readlines()) == 4
    shims.main(["p2p", "test", "--dataset_path", mini_pie, "--exp_path", "out"])
    with open(os.path.join("out", "sweep_stats_p2p_0.json")) as f:
        assert json.load(f)["images_skipped"] == 4

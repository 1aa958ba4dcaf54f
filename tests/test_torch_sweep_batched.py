"""The port's batched PIE-Bench sweep (``eval/sweep.py run_sweep`` with
``batch_size`` > 1) against the JAX package's, with the helpers, mini PIE,
pipelines and limits of ``tests/test_torch_sweep.py``: stats, images
(within its ``LEVELS`` = 2 levels of JAX's) and event logs held by its
``check_same``. Category 0 holds three items, so a batch of 2 makes a group
of two and a group of one. The cases mirror the batched tests of
``tests/test_sweep.py``: DDIM and resume, direct inversion, null-text
inversion (image by image within the group) with the cache written and then
consumed (a cache without embeddings refused for null-text), the four
methods, the tiny SDXL pipeline; and an inversion type that is not batched
raises in both.
"""

import os

import numpy as np
import pytest

from image_editing_framework_torch.core.config import MasaCtrlConfig as TMasaCfg
from image_editing_framework_torch.eval import sweep as tsweep
from image_editing_framework_tpu.core.config import MasaCtrlConfig as JMasaCfg
from image_editing_framework_tpu.eval import sweep as jsweep
from test_sweep import mini_pie  # noqa: F401  (the JAX tests' mini PIE fixture)
from test_torch_sweep import PROMPT_WORDS, RES, _png, check_same, done_keys, pipes, run_both  # noqa: F401
from torch_port_helpers import fix_vocab, shared_pipelines

BATCH = 2


def test_batched_ddim_and_resume(pipes, tmp_path, mini_pie):  # noqa: F811
    out = run_both(pipes, tmp_path, mini_pie, "b", categories=(0,), batch_size=BATCH)
    check_same(*out)
    jstats, tstats = out[:2]
    assert tstats["images_done"] == 3
    # the steady-state stats leave out the first group: one image remains
    assert tstats["p50_s_per_image"] == tstats["steady_s_per_image"] == tstats["max_s_per_image"]
    assert set(jstats) == set(tstats)
    again = run_both(pipes, tmp_path, mini_pie, "b", categories=(0,), batch_size=BATCH)
    assert again[0]["images_done"] == again[1]["images_done"] == 0
    assert again[1]["images_skipped"] == 3
    # the port's batched sweep against its own serial sweep
    serial = tsweep.run_sweep(pipes[1], "p2p", mini_pie, str(tmp_path / "serial"), resolution=RES, categories=(0,))
    assert serial["images_done"] == 3
    for key in done_keys(out[3]):
        for f in ("inversion", "edit"):
            a, b = (_png(os.path.join(d, key, f + ".png")).astype(int) for d in (out[3], str(tmp_path / "serial")))
            assert np.abs(a - b).max() <= 1, (key, f)


def test_batched_direct_inversion(pipes, tmp_path, mini_pie):  # noqa: F811
    out = run_both(pipes, tmp_path, mini_pie, "bd", inversion_type="direct", categories=(0,), max_items=2,
                   batch_size=BATCH)
    check_same(*out)
    assert out[1]["inversion_type_effective"] == "direct" and out[1]["images_done"] == 2


def test_batched_null_text_and_the_cache(pipes, tmp_path, mini_pie):  # noqa: F811
    inv = {side: str(tmp_path / f"inv_{side}") for side in ("jax", "port")}
    out = run_both(pipes, tmp_path, mini_pie, "bn", inversion_type="null-text", categories=(0,), max_items=2,
                   batch_size=BATCH, jax_kwargs=dict(save_inversions=inv["jax"]),
                   port_kwargs=dict(save_inversions=inv["port"]))
    check_same(*out)
    for key in done_keys(out[3]):
        with np.load(os.path.join(inv["jax"], key, "inversion.npz")) as a, \
                np.load(os.path.join(inv["port"], key, "inversion.npz")) as b:
            assert a.files == b.files
            np.testing.assert_allclose(b["latent"], a["latent"], atol=1e-4, rtol=0)
            np.testing.assert_allclose(b["uncond_seq"], a["uncond_seq"], atol=1e-3, rtol=0)
    # the cache consumer: each package reads the port's cache, no inversion
    used = run_both(pipes, tmp_path, mini_pie, "bn_cache", inversion_type="null-text", categories=(0,),
                    max_items=2, batch_size=BATCH, inversion_path=inv["port"])
    check_same(*used)
    for key in done_keys(used[3]):  # the cache gives back what the port's own run edited
        np.testing.assert_array_equal(_png(os.path.join(used[3], key, "edit.png")),
                                      _png(os.path.join(out[3], key, "edit.png")))


def test_batched_null_text_needs_every_embedding(pipes, tmp_path, mini_pie):  # noqa: F811
    """A DDIM cache holds no embeddings: the batched null-text consumer
    refuses it in both packages."""
    inv = str(tmp_path / "inv_ddim")
    run_both(pipes, tmp_path, mini_pie, "bdd", categories=(0,), max_items=2, batch_size=BATCH,
             port_kwargs=dict(save_inversions=inv))
    for sweep, pipe, kw in ((jsweep, pipes[0], dict(use_flash=False)), (tsweep, pipes[1], {})):
        with pytest.raises(ValueError, match="needs a cached uncond_seq"):
            sweep.run_sweep(pipe, "p2p", mini_pie, str(tmp_path / "refused"), inversion_type="null-text",
                            categories=(0,), max_items=2, resolution=RES, batch_size=BATCH, inversion_path=inv,
                            resume=False, **kw)


@pytest.mark.parametrize("method", ["p2p", "masactrl", "pnp", "p2z"])
def test_batched_four_methods(pipes, tmp_path, mini_pie, method):  # noqa: F811
    kw = {}
    if method == "masactrl":  # gated from the first layer and step, so that the tiny UNet's edit is controlled
        kw = dict(jax_kwargs=dict(method_kwargs={"config": JMasaCfg(start_step=1, start_layer=0)}),
                  port_kwargs=dict(method_kwargs={"config": TMasaCfg(start_step=1, start_layer=0)}))
    out = run_both(pipes, tmp_path, mini_pie, f"b_{method}", method=method, categories=(0,), max_items=2,
                   batch_size=BATCH, **kw)
    check_same(*out, method=method)
    assert out[1]["images_done"] == 2


def test_batched_tiny_xl(tmp_path, mini_pie):  # noqa: F811
    jpipe, tpipe = shared_pipelines(num_steps=2, model_type="xl")
    fix_vocab((jpipe, tpipe), PROMPT_WORDS)
    out = run_both((jpipe, tpipe), tmp_path, mini_pie, "bxl", categories=(0,), max_items=2, batch_size=BATCH)
    check_same(*out)
    assert out[1]["images_done"] == 2


def test_test_main_batch_size_runs_the_batched_sweep(pipes, tmp_path, mini_pie, monkeypatch):  # noqa: F811
    """``shims p2p test --batch_size 3`` reaches the batched sweep: the four
    items of the default categories in a group of 3 and a group of 1, one
    batched edit each, and their images."""
    from image_editing_framework_torch import cli, shims
    from image_editing_framework_torch.eval import batched as tbatched

    groups = []
    real_sweep, real_edit = tsweep.run_sweep, tbatched.edit_batch
    monkeypatch.setattr(cli, "load_pipe", lambda *a, **kw: pipes[1])
    monkeypatch.setattr(tsweep, "run_sweep", lambda *a, **kw: real_sweep(*a, resolution=RES, **kw))
    monkeypatch.setattr(tbatched, "edit_batch", lambda *a, **kw: groups.append(len(a[2])) or real_edit(*a, **kw))
    out = str(tmp_path / "shim")
    shims.main(["p2p", "test", "--dataset_path", mini_pie, "--exp_path", out, "--batch_size", "3"])
    assert groups == [3, 1] and len(done_keys(out)) == 4
    for key in done_keys(out):
        assert _png(os.path.join(out, key, "edit.png")).shape == (RES, RES, 3)


def test_other_inversion_types_are_refused(pipes, tmp_path, mini_pie):  # noqa: F811
    for sweep, pipe, kw in ((jsweep, pipes[0], dict(use_flash=False)), (tsweep, pipes[1], {})):
        with pytest.raises(ValueError, match="batched sweep supports"):
            sweep.run_sweep(pipe, "p2p", mini_pie, str(tmp_path / "x"), inversion_type="other", categories=(0,),
                            resolution=RES, batch_size=BATCH, **kw)

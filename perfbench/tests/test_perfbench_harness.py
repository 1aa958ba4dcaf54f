"""The harness on the tiny pipeline, on the CPU: the result line, cells,
mixes and metrics found as files, the generators, the JAX guard, and the
check failing the control and every planted fault."""

import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import REPO, make_root, tiny_traffic

from perfbench import gen, harness
from perfbench.check import verdict

SEED = 2**31 + 977  # wider than 32 signed bits, as a check's seeds may be
CELL_OF = {"tiny-p2p": "sd15-p2p-sweep-b4", "tiny-p2z": "sd15-p2z-sweep-b4", "tiny-xl-p2p": "sdxl-p2p-sweep-b2"}


# pix2pix-zero's update 0.1 g is about 1e-8 of the latent at tiny width with
# the weights' std of 0.02, under float32's rounding; at 0.3 it is 1e-5-1e-4,
# so the tiny p2z cells can show the step applied or left out
P2Z_TINY_STD = 0.3


@pytest.fixture
def visible_update(monkeypatch):
    def use(cell):
        if "p2z" in cell:
            monkeypatch.setattr(gen, "WEIGHT_STD", P2Z_TINY_STD)
    return use


def _limits(cell):
    with open(os.path.join(REPO, "perfbench", "checks", CELL_OF[cell] + ".json")) as f:
        return json.load(f)["limits"]


def _with_limits(root, cell):
    shutil.copy(os.path.join(REPO, "perfbench", "checks", CELL_OF[cell] + ".json"),
                os.path.join(root, "perfbench", "checks", cell + ".json"))


def test_without_a_card_it_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "sd15-p2p-sweep-b4", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("cell", sorted(CELL_OF))
def test_a_tiny_cell_is_correct_and_prints_the_contract_line(tiny_root, visible_update, cell):
    from perfbench.run import emit

    visible_update(cell)
    _with_limits(tiny_root, cell)
    result = harness.run(tiny_root, cell, SEED, 0.0, False, device="cpu")
    out, err = io.StringIO(), io.StringIO()
    emit(result, out, err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["check"]
    assert line["attempted"] == 2 and line["failed"] == 0
    assert set(line["metrics"]) == {"images_per_s", "device_peak_gib", "setup_s"}
    assert all(v["value"] > 0 for k, v in line["metrics"].items() if k != "device_peak_gib")
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert set(line["check"]) == set(_limits(cell))
    assert err.getvalue().strip().splitlines()[-1] == "correct True"


def test_a_configuration_mix_and_metric_added_as_files_are_found(tmp_path):
    traffic = tiny_traffic("p2p")
    root = make_root(tmp_path, {"tiny-new": ("sd2", traffic)})
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    shutil.copy(os.path.join(REPO, "perfbench", "tests", "tiny", "sd.json"),
                os.path.join(root, "perfbench", "configs", "tiny_sd2.json"))
    bench["configs"].append({"name": "sd2", "source": "tiny", "file": "perfbench/configs/tiny_sd2.json",
                             "reduced": [], "why": "test"})
    bench["per_layer"].append({"name": "images_in_window", "unit": "images", "better": "higher",
                               "source": "program_counter", "layer": "sweep", "moves": "images_per_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(root, "perfbench", "metrics", "images_in_window.py"), "w") as f:
        f.write("def read(run):\n    return float(run.images)\n")
    result = harness.run(root, "tiny-new", SEED, 0.0, True, device="cpu")
    metrics = result["metrics"]
    assert metrics["images_in_window"]["value"] == 4.0  # the traced run covers two groups
    assert {"invert_s_per_image", "edit_s_per_image", "sweep_host_s_per_image"} <= set(metrics)
    # the device's metrics have nothing to read on the CPU and are left out
    assert not {"mfu", "idle_share", "attn_fwd_roofline"} & set(metrics)


def test_generators_repeat_by_seed(tmp_path):
    traffic = tiny_traffic("p2p", items=12)
    assert gen.items(traffic, SEED) == gen.items(traffic, SEED)
    assert gen.items(traffic, SEED) != gen.items(traffic, SEED + 1)
    a = gen.write_pie(str(tmp_path / "a"), gen.items(traffic, SEED), 32)
    b = gen.write_pie(str(tmp_path / "b"), gen.items(traffic, SEED), 32)
    for key in gen.sweep_order(a, traffic["categories"]):
        with open(os.path.join(a, "annotation_images", key + ".jpg"), "rb") as fa, \
                open(os.path.join(b, "annotation_images", key + ".jpg"), "rb") as fb:
            assert fa.read() == fb.read()
    kinds = [len(it["source"].split()) == len(it["target"].split()) for it in gen.items(traffic, SEED)]
    assert kinds == [k % 2 == 0 for k in range(12)]
    with open(os.path.join(REPO, "perfbench", "tests", "tiny", "sd.json")) as f:
        cfg = json.load(f)
    w1 = harness.make_weights(cfg, SEED, "cpu", torch.float32)
    w2 = harness.make_weights(cfg, SEED, "cpu", torch.float32)
    w3 = harness.make_weights(cfg, SEED + 1, "cpu", torch.float32)
    assert all(torch.equal(w1[m][k], w2[m][k]) for m in w1 for k in w1[m])
    assert not torch.equal(w1["unet"]["conv_in.weight"], w3["unet"]["conv_in.weight"])
    assert float(w1["unet"]["conv_norm_out.weight"].mean()) == pytest.approx(1.0, abs=0.05)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "image_editing_framework_torch_extra", sys)
    assert "image_editing_framework_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "image_editing_framework_tpu.ops", sys)
    assert harness.forbidden_modules() == ["image_editing_framework_tpu"]


def test_a_run_loads_no_jax():
    code = ("import sys, pathlib, tempfile; sys.path[:0] = [%r, %r]; import conftest; "
            "from perfbench import harness; "
            "root = conftest.make_root(pathlib.Path(tempfile.mkdtemp()), "
            "{'c': ('xl', conftest.tiny_traffic('p2p'))}); "
            "harness.run(root, 'c', 3, 0.0, False, device='cpu'); print(harness.forbidden_modules())"
            ) % (REPO, os.path.join(REPO, "perfbench", "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("cell", sorted(CELL_OF))
def test_the_control_is_not_correct(tiny_root, visible_update, cell):
    visible_update(cell)
    result = harness.run(tiny_root, cell, SEED, 0.0, False, device="cpu", control=True)
    ok, rows = verdict(result["control"], _limits(cell))
    assert not ok, rows


def _state_unchanged(rec, method):
    from image_editing_framework_torch.methods import base, p2z

    def wrap(orig):
        def f(sched, eps, i, sample):
            orig(sched, eps, i, sample)
            return sample.clone()
        return f

    rec._patch(base if method == "p2p" else p2z, "ddim_step", wrap)


def _half_batch(rec, method):
    """The group's second half takes the mean of the first half's noise."""
    from image_editing_framework_torch.methods import base, p2z

    def wrap(orig):
        def f(sched, eps, i, sample):
            g = eps.shape[0]
            eps = torch.cat([eps[: g // 2], eps[: g // 2].mean(0, keepdim=True).expand_as(eps[g // 2:])])
            return orig(sched, eps, i, sample)
        return f

    rec._patch(base if method == "p2p" else p2z, "ddim_step", wrap)


def _answer_altered(rec, method):
    from image_editing_framework_torch.eval import batched

    def wrap(orig):
        def f(pipe, final):
            imgs = orig(pipe, final).copy()
            imgs[-1, 1] = 255 - imgs[-1, 1]
            return imgs
        return f

    rec._patch(batched, "_decode_pairs", wrap)


def _update_left_out(rec, method):
    """pix2pix-zero's gradient computed (and recorded) but its step not
    taken: the noise is taken at the latent as it was."""
    from image_editing_framework_torch.methods import p2z

    def wrap(orig):
        def f(*a, **kw):
            losses, g = orig(*a, **kw)
            return losses, torch.zeros_like(g)
        return f

    rec._patch(p2z, "guidance_gradient_group", wrap)


def _step_inlined(rec, method):
    """A restructured loop that no longer calls the module-level DDIM step
    the check reads its states at."""
    from image_editing_framework_torch.core import scheduler
    from image_editing_framework_torch.methods import base

    rec._patch(base, "ddim_step", lambda wrapped: scheduler.ddim_step)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered])
@pytest.mark.parametrize("cell", sorted(CELL_OF))
def test_a_broken_timed_path_is_not_correct(tiny_root, visible_update, cell, fault):
    visible_update(cell)
    _with_limits(tiny_root, cell)
    method = "p2z" if "p2z" in cell else "p2p"
    result = harness.run(tiny_root, cell, SEED, 0.0, False, device="cpu", faults=lambda rec: fault(rec, method))
    assert result["correct"] is False, result["check"]


def test_the_update_number_reads_a_left_out_step(tiny_root, visible_update):
    """Where the update is above the state's rounding, ``pass2_update_rel``
    reads a step left out as 1; at full width in bf16 it is not (the cell
    does not compare it)."""
    visible_update("tiny-p2z")
    _with_limits(tiny_root, "tiny-p2z")
    sound = harness.run(tiny_root, "tiny-p2z", SEED, 0.0, False, device="cpu")
    left_out = harness.run(tiny_root, "tiny-p2z", SEED, 0.0, False, device="cpu",
                           faults=lambda rec: _update_left_out(rec, "p2z"))
    assert sound["readings"]["pass2_update_rel"] < 0.05
    assert left_out["readings"]["pass2_update_rel"] > 0.9


def test_an_unseen_hook_is_named_and_not_correct(tiny_root, capsys):
    _with_limits(tiny_root, "tiny-p2p")
    result = harness.run(tiny_root, "tiny-p2p", SEED, 0.0, False, device="cpu",
                         faults=lambda rec: _step_inlined(rec, "p2p"))
    assert result["correct"] is False
    assert result["readings"] == {"missing_state": float("inf")}
    assert "the hook on methods.base.ddim_step saw no call" in capsys.readouterr().err

"""chip_smoke.py refuses to report a result where it cannot run the port on
a card: with no CUDA device visible, and from a directory that holds the
script and nothing else of the repository."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _run(script, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _run(SCRIPT, ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    out = _run(str(lone), str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _load_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # importing it runs nothing: main() is behind the __main__ check
    return module


def test_chip_smoke_builds_every_kernel_source():
    """Every CUDA source of the port is in SOURCES, so the script alone
    builds them all (one nvcc each, started together)."""
    smoke = _load_script()
    csrc = os.path.join(ROOT, "image_editing_framework_torch", "csrc")
    on_disk = sorted(name[:-3] for name in os.listdir(csrc) if name.endswith(".cu"))
    assert sorted(smoke.SOURCES) == on_disk and "mma_probe" in smoke.SOURCES


def test_chip_smoke_wires_every_phase_into_main():
    """main() runs the earlier phases and the SDXL slice's: the probe, both
    models' main, NTI and profile phases, and the refiner; the kernels line
    names all four kernels; the XL shapes are SDXL's 70 sites at head dim 64."""
    import inspect

    smoke = _load_script()
    source = inspect.getsource(smoke.main)
    for phase in ("phase_device", "phase_kernels", "phase_bwd_kernels", "phase_probe", "phase_tiny",
                  "phase_main_path", "phase_nti_path", "phase_profile", "phase_refiner"):
        assert callable(getattr(smoke, phase)) and phase in source, phase
    assert '("sd", ""), ("xl", "xl_")' in source  # both models go through main, NTI and profile
    for kernel in ("flash_fwd", "flash_bwd_", "mma_probe"):
        assert f'"name": "{kernel}' in source or f'"name": f"{kernel}' in source, kernel
    assert smoke.PATH_SHAPES["xl"] == [(4096, 64, 10, 10), (1024, 64, 20, 60)]
    assert smoke.SITES == {"sd": 16, "xl": 70} and smoke.GRAD_SITES == {"sd": 15, "xl": 69}
    assert smoke.PATH_SHAPES["sd"][0] == (4096, 40, 8, 5)  # the SD1.5 shapes stay
    assert "xl_tiny" in inspect.getsource(smoke.phase_tiny)
    last = source.rstrip().splitlines()
    assert '"ok": True' in "".join(last[-4:])  # the result object is printed last


def _source_constant(name, constant):
    import re

    with open(os.path.join(ROOT, "image_editing_framework_torch", "csrc", name)) as f:
        text = f.read()
    return int(re.search(rf"constexpr int {constant} = (\d+);", text).group(1)), text


def test_chip_smoke_key_tiles_are_the_kernels():
    """The planted faults emulate tiles of the kernels they check: the
    forward's key tiles (128 up to d = 80, 64 at d = 160) and the backward's
    64 are read from the CUDA sources."""
    smoke = _load_script()
    fwd, fwd_text = _source_constant("flash_fwd.cu", "kBK")
    wide, _ = _source_constant("flash_fwd.cu", "kBKWide")
    bwd, _ = _source_constant("flash_bwd.cu", "kTile")
    assert (smoke.FWD_KEY_TILE, smoke.FWD_KEY_TILE_WIDE, smoke.BWD_KEY_TILE) == (fwd, wide, bwd)
    assert "DP > 80 ? kBKWide : kBK" in fwd_text
    assert [smoke.fwd_key_tile(d) for d in (16, 40, 64, 80, 160)] == [fwd] * 4 + [wide]


@pytest.mark.parametrize("nq,nk,d", [(200, 300, 64), (130, 200, 160)])
def test_planted_faults_exceed_the_limit_at_the_new_tile(nq, nk, d):
    """At the forward's key tile, a skipped last tile and a missing
    accumulator rescale each move O by more than ``parity_atol``."""
    from image_editing_framework_torch.ops import flash_attention as fa

    smoke = _load_script()
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, n, d).astype(np.float32)).to(torch.bfloat16) for n in (nq, nk, nk))
    ref = fa.flash_attention_reference(q, k, v)
    faults = smoke.fault_readings(q, k, v, ref)
    tol = fa.parity_atol(ref)
    assert nk > smoke.fwd_key_tile(d)
    assert faults["skipped_key_tile"] > tol and faults["no_acc_rescale"] > tol, (faults, tol)

"""chip_smoke.py refuses to report a result where it cannot run the port on
a card: with no CUDA device visible, and from a directory that holds the
script and nothing else of the repository."""

import os
import shutil
import subprocess
import sys

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

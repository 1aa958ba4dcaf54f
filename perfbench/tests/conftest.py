"""Shared set-up of the benchmark's CPU tests: the repository root on the
import path, one intra-op thread per worker, and a tiny benchmark root (a
copy of ``perfbench/`` with a ``BENCHMARK.json`` of tiny cells)."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

torch.set_num_threads(1)

TINY = os.path.join(REPO, "perfbench", "tests", "tiny")


def tiny_traffic(method: str, batch: int = 2, items: int = 8) -> dict:
    with open(os.path.join(REPO, "perfbench", "traffic", "p2p-sweep-b4.json")) as f:
        traffic = json.load(f)
    traffic.update(method=method, batch_size=batch, items=items, image_side=32, prompt_words=[3, 7])
    return traffic


def make_root(tmp_path, cells) -> str:
    """A checkout-like root: ``perfbench/`` copied, the tiny configurations
    and the given cells ({name: (config, traffic dict)}) added as files."""
    root = tmp_path / "root"
    shutil.copytree(os.path.join(REPO, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    configs = [{"name": n, "source": "tiny", "file": f"perfbench/configs/tiny_{n}.json", "reduced": [], "why": "test"}
               for n in ("sd", "xl")]
    for n in ("sd", "xl"):
        shutil.copy(os.path.join(TINY, f"{n}.json"), root / "perfbench" / "configs" / f"tiny_{n}.json")
    workloads = []
    for name, (config, traffic) in cells.items():
        (root / "perfbench" / "traffic" / f"{name}.json").write_text(json.dumps(traffic))
        workloads.append({"name": name, "config": config, "traffic": name, "chips": 1, "why": "test"})
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench.update(configs=configs, workloads=workloads)
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path, {"tiny-p2p": ("sd", tiny_traffic("p2p")), "tiny-p2z": ("sd", tiny_traffic("p2z")),
                                "tiny-xl-p2p": ("xl", tiny_traffic("p2p"))})

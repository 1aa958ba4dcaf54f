"""The port's process group, mesh and distributed sweep launcher
(``parallel/mesh.py``, ``tools/launch_distributed_sweep.py``) on the CPU.

* ``make_mesh`` on a gloo group of 4 rank processes (``torch_cp_workers.py
  suite_mesh``): the JAX package's shapes (tests/test_parallel.py:20), the
  placements of ``data_sharding`` / ``replicated``, the refusal of a
  product other than the world size;
* ``initialize_distributed`` for one process (a no-op returning 0) and for
  2 and 4 (each rank process joins through it and gets its process id);
* the launcher as two processes over gloo on the tiny pipeline and a
  synthetic PIE of 4 images: the shards partition the list, every image is
  edited exactly once (the JAX package's ``_dryrun_shard_sweep``); and its
  refusal of ``--shard_index`` without a larger ``--shard_count``.
"""

import concurrent.futures
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist
from PIL import Image

from image_editing_framework_torch.parallel import mesh as mesh_lib
from image_editing_framework_torch.tools import launch_distributed_sweep as launcher
from torch_cp_workers import JOIN_TIMEOUT_S, ROOT, launch

ITEMS = 4


def _mini_pie(root):
    """A PIE of ITEMS 32² JPEGs in category 0."""
    imgdir = os.path.join(root, "annotation_images", "0_shard")
    os.makedirs(imgdir)
    rng = np.random.RandomState(0)
    mapping = {}
    for i in range(ITEMS):
        rel = f"0_shard/img_{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(os.path.join(root, "annotation_images", rel))
        mapping[str(i)] = {"image_path": rel, "original_prompt": f"a [cat] number {i}",
                           "editing_prompt": f"a [dog] number {i}"}
    with open(os.path.join(root, "mapping_file.json"), "w") as f:
        json.dump(mapping, f)


def _launch_sweep(tmp):
    """Two launcher processes on one gloo group; returns (exit codes, logs,
    the exp dir)."""
    pie, exp = os.path.join(tmp, "PIE"), os.path.join(tmp, "exp")
    _mini_pie(pie)
    store = os.path.join(tmp, "store")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "image_editing_framework_torch.tools.launch_distributed_sweep", "--tiny",
         "--device", "cpu", "--num_steps", "2", "--resolution", "32", "--dataset_path", pie, "--exp_path", exp,
         "--coordinator", f"file://{store}", "--num_processes", "2", "--process_id", str(rank)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    logs = []
    for proc in procs:
        try:
            logs.append(proc.communicate(timeout=JOIN_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
            logs.append(proc.communicate()[0])
    return [proc.returncode for proc in procs], logs, exp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the mesh suite's 4 ranks' results, the launcher's run), side by side."""
    tmp = tmp_path_factory.mktemp("parallel")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        mesh = pool.submit(launch, "mesh", 4, tmp)
        sweep = pool.submit(_launch_sweep, str(tmp))
        return mesh.result(), sweep.result()


def test_mesh_shapes(runs):
    for rank, res in enumerate(runs[0]):
        assert res["default/names"].tolist() == ["data", "tensor"]
        assert res["default/shape"].tolist() == [4, 1]
        assert res["tensor2/shape"].tolist() == [2, 2]
        assert res["tensor2/data_sharding"].tolist() == ["Shard(dim=0)", "Replicate()"]
        assert res["tensor2/replicated"].tolist() == ["Replicate()", "Replicate()"]
        assert str(res["bad_product"]) == "(3, 1, 4)"


def test_initialize_distributed_joins_the_group(runs):
    assert [int(res["rank"]) for res in runs[0]] == [0, 1, 2, 3]
    codes, logs, _ = runs[1]
    assert codes == [0, 0], logs
    for rank, log in enumerate(logs):
        assert f"[process {rank}/2]" in log, log


def test_initialize_distributed_one_process():
    assert not dist.is_initialized()
    assert mesh_lib.initialize_distributed() == 0
    assert mesh_lib.initialize_distributed("localhost:1", 1, 0) == 0
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        mesh_lib.initialize_distributed(None, 2, 0)


def test_launcher_shards_partition_the_sweep(runs):
    codes, logs, exp = runs[1]
    assert codes == [0, 0], logs
    done = []
    for shard in range(2):
        with open(os.path.join(exp, f"sweep_stats_p2p_{shard}.json")) as f:
            stats = json.load(f)
        assert stats["images_skipped"] == 0, "shards overlapped"
        done.append(stats["images_done"])
    assert done == [ITEMS // 2, ITEMS // 2]
    edited = sorted(os.listdir(os.path.join(exp, "0_shard")))
    assert edited == [f"img_{i}" for i in range(ITEMS)]
    for key in edited:
        assert os.path.exists(os.path.join(exp, "0_shard", key, "edit.png"))


@pytest.mark.parametrize("count", [None, "1"])
def test_launcher_refuses_a_shard_index_without_a_larger_count(tmp_path, count):
    argv = ["--dataset_path", str(tmp_path), "--exp_path", str(tmp_path / "exp"), "--shard_index", "1"]
    if count is not None:
        argv += ["--shard_count", count]
    with pytest.raises(SystemExit, match="--shard_index requires --shard_count > shard_index"):
        launcher.main(argv)

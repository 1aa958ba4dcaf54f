"""Concurrent multi-process shard demo: N independent sweep processes over
one shared ``--exp_path``.

Counterpart of the JAX package's ``tools/concurrent_shard_demo.py``, with
its flags. The reference's PIE sweep is one serial process
(p2p/test.py:114-181); this package's deployment runs one process per card
or host, each on a strided shard (``tools/launch_distributed_sweep.py
--shard_index/--shard_count``). Here N OS processes run at the same time
against the same output tree; resume-by-output and per-shard stats files
keep them apart: no shard skips an image (none overlaps another) and the
images on disk are exactly ``--n``.

Runs the tiny pipeline on the CPU (one machine stands in for N hosts; the
shard plumbing is the same). Writes ``validation_torch/concurrent_shards.json``.

    python -m image_editing_framework_torch.tools.concurrent_shard_demo --n 24 --shards 8
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional, Sequence

from image_editing_framework_torch.tools.sweep_rehearsal import count_done, launch, sweep_command, synth_pie


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser("concurrent shard demo")
    ap.add_argument("--n", type=int, default=24)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--num_steps", type=int, default=8)
    ap.add_argument("--method", type=str, default="p2p")
    ap.add_argument("--root", type=str, default=os.path.join(tempfile.gettempdir(), "ief_torch_conc_shards"))
    ap.add_argument("--out", type=str, default="validation_torch/concurrent_shards.json")
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    ds, exp = synth_pie(root, args.n, res=32), os.path.join(root, "exp")
    tiny = ["--tiny", "--device", "cpu", "--num_steps", str(args.num_steps), "--resolution", "32"]
    t0 = time.time()
    procs = [launch(sweep_command(ds, exp, args.n, 1, args.method, tiny,
                                  ["--shard_index", str(si), "--shard_count", str(args.shards)]))
             for si in range(args.shards)]
    outs = [p.communicate()[0] for p in procs]
    wall = time.time() - t0

    failures = [i for i, p in enumerate(procs) if p.returncode != 0]
    for i in failures:
        print(f"--- shard {i} FAILED ---\n{outs[i][-1500:]}")
    if failures:
        print(f"shards failed: {failures}")
        return 1

    shard_stats, total_done = {}, 0
    for si in range(args.shards):
        with open(os.path.join(exp, f"sweep_stats_{args.method}_{si}.json")) as f:
            s = json.load(f)
        if s["images_skipped"] != 0:
            print(f"shard {si} overlapped another shard: {s}")
            return 1
        shard_stats[si] = {k: s[k] for k in ("images_done", "wall_s") if k in s}
        total_done += s["images_done"]
    on_disk = count_done(exp)
    if not total_done == args.n == on_disk:
        print(f"images done {total_done}, asked {args.n}, on disk {on_disk}")
        return 1

    result = {
        "n": args.n, "shards": args.shards, "method": args.method, "num_steps": args.num_steps,
        "wall_s": round(wall, 1), "images_done_total": total_done, "images_on_disk": on_disk,
        "per_shard": shard_stats,
        "note": f"tiny pipeline on the CPU; {args.shards} concurrent OS processes, shared exp tree, zero overlap — "
                "the per-host deployment layout of launch_distributed_sweep.py",
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Null-text-inversion cache rehearsal: produce the cache, then consume it.

Counterpart of the JAX package's ``tools/nti_cache_rehearsal.py``, with its
flags. The reference consumes a precomputed inversion cache it cannot
produce (p2p/dataset/pie.py:25-51 reads inversion_latent.pt and the uncond
list); this package produces and consumes it:

  phase P (produce): a ``--n``-image PIE-shaped sweep with null-text
      inversion at ``--batch_size``, ``--save_inversions`` writing one
      ``.npz`` per image (start latent and per-step unconditional
      embeddings);
  phase C (consume): a fresh sweep over the same dataset with
      ``--inversion_path`` at that cache: the inversion and NTI are skipped,
      an image costs its edit and decode.

Writes one JSON: both phases' stats, the cache's files and bytes, and the
producer / consumer ratio of steady s/image. A finished phase P under
``--root`` is reused.

    python -m image_editing_framework_torch.tools.nti_cache_rehearsal --n 100 --batch_size 4 \\
        --out validation_torch/nti_cache_rehearsal.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

from image_editing_framework_torch.tools.sweep_rehearsal import (
    add_pipeline_args,
    count_done,
    launch,
    pipeline_flags,
    sweep_command,
    synth_pie,
)


def run(cmd) -> tuple:
    """(return code, output) of one sweep process run to its end."""
    proc = launch(cmd)
    out, _ = proc.communicate()
    return proc.returncode, out


def cache_footprint(inv: str) -> tuple:
    files = total = 0
    for dirpath, _, fnames in os.walk(inv):
        for f in fnames:
            files += 1
            total += os.path.getsize(os.path.join(dirpath, f))
    return files, total


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser("NTI inversion-cache rehearsal")
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--root", type=str, default=os.path.join(tempfile.gettempdir(), "ief_torch_nti_rehearsal"))
    ap.add_argument("--out", type=str, default="validation_torch/nti_cache_rehearsal.json")
    add_pipeline_args(ap)
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    os.makedirs(root, exist_ok=True)
    ds = os.path.join(root, "ds")
    if not os.path.exists(os.path.join(ds, "mapping_file.json")):
        print(f"synthesizing {args.n}-image PIE clone under {ds} ...")
        synth_pie(root, args.n, res=args.resolution)
    inv = os.path.join(root, "inv_cache")
    produce, consume = os.path.join(root, "exp_produce"), os.path.join(root, "exp_consume")
    result = {"n": args.n, "batch_size": args.batch_size, "inversion_type": "null-text"}
    flags = pipeline_flags(args)

    produce_stats = os.path.join(produce, "sweep_stats_p2p_0.json")
    if os.path.exists(produce_stats):
        # a finished phase P (and its cache) is expensive: reuse it and only
        # drive the consumer again
        print("phase P already complete; reusing its cache ...")
        with open(produce_stats) as f:
            result["produce_wall_s"] = json.load(f).get("wall_s")
    else:
        print("phase P: null-text sweep producing the inversion cache ...")
        t0 = time.time()
        code, out = run(sweep_command(ds, produce, args.n, args.batch_size, "p2p", flags,
                                      ["--inversion_type", "null-text", "--save_inversions", inv]))
        sys.stdout.write(out[-1500:])
        if code != 0:
            print(f"phase P FAILED rc={code}")
            return 1
        result["produce_wall_s"] = round(time.time() - t0, 1)
    with open(produce_stats) as f:
        result["produce_stats"] = json.load(f)
    result["cache_files"], result["cache_bytes"] = cache_footprint(inv)

    print("phase C: fresh sweep consuming the cache (no inversion, no NTI) ...")
    t1 = time.time()
    code, out = run(sweep_command(ds, consume, args.n, args.batch_size, "p2p", flags,
                                  ["--inversion_type", "null-text", "--inversion_path", inv]))
    sys.stdout.write(out[-1500:])
    if code != 0:
        print(f"phase C FAILED rc={code}")
        return 1
    result["consume_wall_s"] = round(time.time() - t1, 1)
    with open(os.path.join(consume, "sweep_stats_p2p_0.json")) as f:
        result["consume_stats"] = json.load(f)
    result["consume_images_done"] = count_done(consume)
    ps, cs = result["produce_stats"].get("steady_s_per_image"), result["consume_stats"].get("steady_s_per_image")
    if ps and cs:
        result["producer_consumer_speedup"] = round(ps / cs, 2)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())

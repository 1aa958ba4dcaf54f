"""PIE-sweep dress rehearsal: a sweep killed mid-run, then resumed.

Counterpart of the JAX package's ``tools/sweep_rehearsal.py``, with its
flags:

1. synthesizes a PIE-Bench-shaped dataset of ``--n`` images (``synth_pie``),
2. phase A: runs the sweep (``tools/launch_distributed_sweep.py``) as a
   subprocess and SIGKILLs it mid-run: after ``--kill_after`` seconds, or,
   with ``--kill_after_images K``, as soon as K edits are on disk,
3. phase B: runs it again, resuming by output, to the end,
4. writes one JSON: wall clocks, the final stats file (s/image, its
   percentiles, the card's peak and host RSS) and the resume evidence
   (phase B skipped what phase A finished).

By default the sweep runs the production-shape SD1.5 pipeline with seeded
random weights on the card (``--random_weights``); ``--tiny --device cpu``
runs the tiny pipeline on the CPU instead.

    python -m image_editing_framework_torch.tools.sweep_rehearsal --n 700 --batch_size 4 \\
        --out validation_torch/sweep_rehearsal.json
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

# the directory that holds the package: the sweep subprocesses run from it
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LAUNCHER = "image_editing_framework_torch.tools.launch_distributed_sweep"


def synth_pie(root: str, n: int, res: int = 512, categories=(0, 1, 2, 3, 4, 6, 7, 8, 9)) -> str:
    """A PIE-Bench-shaped dataset under ``root/ds`` of n smooth-noise JPEGs
    spread over the reference's categories (5 skipped, as in
    p2p/test.py:114), each with a one-word edit. numpy and Pillow only: the
    parent process never touches the card, which the sweep subprocesses
    need to themselves. Returns the dataset directory."""
    import numpy as np
    from PIL import Image

    ds = os.path.join(root, "ds")
    mapping = {}
    rng = np.random.RandomState(0)
    nouns = ["cat", "dog", "horse", "zebra", "car", "boat"]
    for i in range(n):
        cat = categories[i % len(categories)]
        rel = f"{cat}_synthetic/img_{i:04d}.jpg"
        os.makedirs(os.path.join(ds, "annotation_images", f"{cat}_synthetic"), exist_ok=True)
        small = rng.randint(0, 255, (max(res // 16, 1), max(res // 16, 1), 3), np.uint8)
        img = np.asarray(Image.fromarray(small).resize((res, res), Image.BICUBIC))
        Image.fromarray(img).save(os.path.join(ds, "annotation_images", rel))
        src, tgt = nouns[i % 6], nouns[(i + 1) % 6]
        mapping[str(i)] = {"image_path": rel, "original_prompt": f"a [{src}] in the field",
                           "editing_prompt": f"a [{tgt}] in the field"}
    with open(os.path.join(ds, "mapping_file.json"), "w") as f:
        json.dump(mapping, f)
    return ds


def sweep_command(ds: str, exp: str, n: int, batch: int, method: str, pipeline: Sequence[str],
                  extra: Sequence[str] = ()) -> List[str]:
    """The launcher's command line for one sweep process; ``pipeline`` names
    the pipeline (``--random_weights`` or ``--tiny --device cpu ...``)."""
    return [sys.executable, "-m", LAUNCHER, "--method", method, "--dataset_path", ds, "--exp_path", exp,
            "--batch_size", str(batch), "--max_items", str(n), *pipeline, *extra]


def launch(cmd: Sequence[str], stdout=subprocess.PIPE) -> subprocess.Popen:
    """One sweep process from the package's directory; its output to
    ``stdout`` (a pipe the caller must read, or ``subprocess.DEVNULL``)."""
    return subprocess.Popen(list(cmd), cwd=PACKAGE_ROOT, stdout=stdout, stderr=subprocess.STDOUT, text=True)


def pipeline_flags(args) -> List[str]:
    """The pipeline and resolution flags the rehearsals pass to every sweep
    process."""
    flags = ["--tiny", "--device", args.device] if args.tiny else ["--random_weights", "--device", args.device]
    flags += ["--resolution", str(args.resolution)]
    if args.num_steps is not None:
        flags += ["--num_steps", str(args.num_steps)]
    return flags


def add_pipeline_args(ap: argparse.ArgumentParser, resolution: int = 512) -> None:
    ap.add_argument("--tiny", action="store_true", help="the tiny pipeline (f32) instead of production shapes")
    ap.add_argument("--device", type=str, default="cuda", help="'cuda' or 'cpu' (with --tiny)")
    ap.add_argument("--resolution", type=int, default=resolution)
    ap.add_argument("--num_steps", type=int, default=None, help="the sweep's steps (default: its 50)")


def count_done(exp: str) -> int:
    """Images whose ``edit.png`` is on disk under ``exp/<category>/<key>/``."""
    total = 0
    if not os.path.isdir(exp):
        return 0
    for cat in os.listdir(exp):
        d = os.path.join(exp, cat)
        if not os.path.isdir(d):
            continue
        for key in os.listdir(d):
            if os.path.exists(os.path.join(d, key, "edit.png")):
                total += 1
    return total


def kill_mid_run(proc: subprocess.Popen, exp: str, seconds: float, images: int) -> bool:
    """SIGKILL ``proc`` after ``seconds``, or once ``images`` edits are on
    disk when ``images`` > 0. Returns False when it ended first."""
    deadline = time.monotonic() + seconds
    while proc.poll() is None:
        if (images > 0 and count_done(exp) >= images) or (images <= 0 and time.monotonic() >= deadline):
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            return True
        time.sleep(0.02)
    return False


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser("sweep dress rehearsal")
    ap.add_argument("--n", type=int, default=700)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--method", type=str, default="p2p")
    ap.add_argument("--kill_after", type=float, default=300.0,
                    help="seconds into phase A before SIGKILL (0 = skip phase A)")
    ap.add_argument("--kill_after_images", type=int, default=0,
                    help="SIGKILL phase A once this many edits are on disk instead (0 = by --kill_after)")
    ap.add_argument("--root", type=str, default=os.path.join(tempfile.gettempdir(), "ief_torch_rehearsal"))
    ap.add_argument("--out", type=str, default="validation_torch/sweep_rehearsal.json")
    add_pipeline_args(ap)
    args = ap.parse_args(argv)

    root = os.path.abspath(args.root)
    os.makedirs(root, exist_ok=True)
    ds = os.path.join(root, "ds")
    if not os.path.exists(os.path.join(ds, "mapping_file.json")):
        print(f"synthesizing {args.n}-image PIE clone under {ds} ...")
        synth_pie(root, args.n, res=args.resolution)
    exp = os.path.join(root, "exp")
    cmd = sweep_command(ds, exp, args.n, args.batch_size, args.method, pipeline_flags(args))
    kill = args.kill_after > 0 or args.kill_after_images > 0

    t0 = time.time()
    result = {"n": args.n, "batch_size": args.batch_size, "method": args.method}
    if kill:
        print("phase A: sweep subprocess, SIGKILLed mid-run ...")
        # its output is not read: a pipe nobody drains would stall it
        if not kill_mid_run(launch(cmd, subprocess.DEVNULL), exp, args.kill_after, args.kill_after_images):
            print("phase A finished before the kill window — shrink --kill_after")
        result["phase_a_wall_s"] = round(time.time() - t0, 1)
        result["phase_a_images_done"] = count_done(exp)
        print(f"phase A killed: {result['phase_a_images_done']} images on disk")

    print("phase B: resume to completion ...")
    t1 = time.time()
    proc = launch(cmd)
    out, _ = proc.communicate()
    sys.stdout.write(out[-2000:])
    if proc.returncode != 0:
        print(f"phase B FAILED rc={proc.returncode}")
        return 1
    result["phase_b_wall_s"] = round(time.time() - t1, 1)
    result["total_wall_s"] = round(time.time() - t0, 1)
    result["final_images_done"] = count_done(exp)

    with open(os.path.join(exp, f"sweep_stats_{args.method}_0.json")) as f:
        stats = json.load(f)
    result["phase_b_stats"] = stats
    resumed = stats.get("images_skipped", 0)
    result["resume_verified"] = (kill and resumed >= result.get("phase_a_images_done", 0) - args.batch_size
                                 and result["final_images_done"] == args.n)
    # end-to-end throughput over the whole rehearsal (the kill and both
    # loads included): what an operator sees
    result["effective_s_per_image"] = round(result["total_wall_s"] / args.n, 3)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())

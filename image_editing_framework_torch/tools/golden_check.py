"""Golden-output regression check.

Counterpart of the JAX package's ``tools/golden_check.py``, with its flags
and exit codes: re-runs ONE method (default p2p) of a validation report on
the current code and card and diffs its ``*_sha256`` golden hashes.

    python -m image_editing_framework_torch.tools.golden_check \\
        [--report validation_torch/1.5/report.json] [--method p2p] [--out DIR]

Exit 0: the hashes match; 1: a regression (the differing keys are printed);
2: the report cannot be replayed here. The anchor is a report this package's
runway wrote (``tools/validate_real_weights.py --random_weights``, or
``eval/validate.py``); the report is replayed with the pipeline it names:

* ``random_weights`` provenance: ``pipelines.random_pipeline(sd_version,
  num_steps, bf16, seed)``, as in JAX;
* a report written from loaded checkpoints: exit 2, as in JAX, unless
  ``--path`` names the checkpoint to load again (``registry.load_pipeline``);
* a report whose ``backend`` is ``tpu`` (the JAX package's goldens, such as
  the committed ``validation/*/report.json``): exit 2 with the reason. This
  package is not held to the TPU's hashes: its kernels, its PNG encoder and
  its seeded draws differ, so only a report of its own is an anchor.

The prompts are not in a report: ``--source_prompt`` / ``--target_prompt``
default to the runway's defaults. ``--device`` picks the card (default) or
``cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Optional, Sequence

DEFAULT_REPORT = "validation_torch/1.5/report.json"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser("golden-output regression check")
    ap.add_argument("--report", default=DEFAULT_REPORT)
    ap.add_argument("--method", default="p2p")
    ap.add_argument("--out", default=None, help="rerun output dir (tmp default)")
    ap.add_argument("--path", default=None, help="the checkpoint a loaded-checkpoint report was written from")
    ap.add_argument("--source_prompt", default="a gray horse in the field")
    ap.add_argument("--target_prompt", default="a whie horse in the field")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with open(args.report) as f:
        report = json.load(f)
    if args.method not in report["methods"]:
        print(f"method {args.method} not in report; have {sorted(report['methods'])}")
        return 2
    if report.get("backend") == "tpu":
        print("report was produced on a TPU by the JAX package: its hashes are that package's goldens, which this "
              "package is not held to (other kernels, PNG encoder and seeded draws); replay a report written by "
              "this package's runway instead (tools/validate_real_weights.py --random_weights)")
        return 2

    import torch

    from image_editing_framework_torch.eval.validate import synth_source_image, validate_pipeline

    version = report.get("sd_version") or os.path.basename(os.path.dirname(os.path.abspath(args.report)))
    if "random_weights" in report.get("provenance", ""):
        from image_editing_framework_torch import pipelines

        pipe = pipelines.random_pipeline(version, report["num_steps"], dtype=torch.bfloat16, seed=report["seed"],
                                         device=args.device)
    elif args.path is not None:
        from image_editing_framework_torch.models.registry import load_pipeline

        pipe = load_pipeline(version, report["num_steps"], dtype=torch.bfloat16, path=args.path, device=args.device)
    else:
        print("report was produced from loaded checkpoints; rerun with --path CHECKPOINT (or "
              "tools/validate_real_weights.py with the same --path) instead")
        return 2

    if report.get("decode_tile_latent") is not None:
        pipe.decode_tile_latent = report["decode_tile_latent"]
    source_image = None
    if "real_edit_sha256" in report["methods"][args.method]:
        source_image = synth_source_image(report["seed"], report["resolution"])

    out = args.out or tempfile.mkdtemp(prefix="ief_golden_check_")
    fresh = validate_pipeline(
        pipe, out, methods=(args.method,), source_image=source_image, source_prompt=args.source_prompt,
        target_prompt=args.target_prompt, seed=report["seed"], resolution=report["resolution"],
        inversion_type=report["inversion_type"], provenance=report.get("provenance"), sd_version=version,
    )

    old = report["methods"][args.method]
    new = fresh["methods"][args.method]
    hash_keys = [k for k in old if k.endswith("_sha256") and k in new]
    diffs = [k for k in hash_keys if old[k] != new[k]]
    for k in hash_keys:
        mark = "MATCH" if old[k] == new[k] else "DIFF "
        print(f"{mark} {args.method}.{k}: {old[k][:16]} vs {new[k][:16]}")
    if diffs:
        print(f"GOLDEN REGRESSION: {len(diffs)}/{len(hash_keys)} hashes changed ({', '.join(diffs)})")
        return 1
    print(f"golden check OK: {len(hash_keys)} hashes match ({report['provenance']}, backend={fresh.get('backend')})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

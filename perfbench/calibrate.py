"""Readings for the check's limits: the program's numbers and the float8
control's at the same states, one short window (one group) per seed, all
seeds in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 1 2 3 [--seconds 0] [--out file.jsonl]

Prints one JSON line per seed: the seed, the program's numbers, the
control's, the run's set-up, window and check seconds, and the device peak.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench.run import configure

    configure()
    from perfbench import harness

    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run(ROOT, args.workload, seed, args.seconds, False, t_start=t0, control=True)
        line = {"seed": seed, "program": r["readings"], "control": r["control"],
                "setup_s": r["metrics"]["setup_s"]["value"], "window_s": r["measured_s"], "groups": r["groups"],
                "images_per_s": r["metrics"]["images_per_s"]["value"], "check_s": r["check_s"],
                "peak_gib": r["metrics"]["device_peak_gib"]["value"], "run_s": time.perf_counter() - t0,
                "kind": r["device"]["kind"], "detail": r["check_detail"]}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

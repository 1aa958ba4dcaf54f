"""Set a cell's check limits from calibration readings.

    python3 perfbench/limits.py --workload <name> --readings cal.jsonl [...] [--runs run.out ...]

``--readings`` are ``calibrate.py``'s lines: each seed's numbers of the
program and of the float8 control at the same states; ``--runs`` add
program numbers alone: ``run.py``'s result lines (their ``readings``) or
calibration lines of the same numbers (their ``program``). For each number the lower reading is the largest the program
gave over all seeds, the upper the smallest the control gave. A number the
program matched exactly on every seed gets the limit 0; one whose upper
reading is three times its lower or more gets a limit 60% of the way from
the lower to the upper on a log scale (more room above the lower, where
fresh seeds read higher); one without is left out of the comparison and
kept with its readings under ``not_compared``. Writes
``perfbench/checks/<name>.json``.
"""

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def limits(program, control):
    """``program`` and ``control``: lists of {number: reading}, one a seed."""
    out = {"limits": {}, "lower": {}, "upper": {}, "not_compared": {}, "program_seeds": len(program),
           "control_seeds": len(control)}
    for name in sorted({k for c in control for k in c}):
        lower = max(p[name] for p in program if name in p)
        upper = min(c[name] for c in control if name in c)
        out["lower"][name], out["upper"][name] = lower, upper
        if lower == 0.0 and upper > 0.0:
            out["limits"][name] = 0.0
        elif upper >= 3 * lower:
            out["limits"][name] = float(f"{math.exp(0.4 * math.log(lower) + 0.6 * math.log(upper)):.3g}")
        else:
            out["not_compared"][name] = {"lower": lower, "upper": upper}
    return out


def _lines(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip().startswith("{")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--readings", nargs="+", required=True)
    ap.add_argument("--runs", nargs="*", default=[])
    args = ap.parse_args(argv)
    cal = [ln for path in args.readings for ln in _lines(path)]
    runs = []
    for path in args.runs:
        for line in _lines(path):
            if "program" in line:
                runs.append(line["program"])
            elif "readings" in line:
                runs.append(line["readings"])
    out = limits([ln["program"] for ln in cal] + runs, [ln["control"] for ln in cal])
    path = os.path.join(ROOT, "perfbench", "checks", args.workload + ".json")
    with open(path, "w") as f:
        f.write(json.dumps(out, indent=1) + "\n")
    for name in sorted(out["lower"]):
        lim = out["limits"].get(name, "not compared")
        n = sum(name in p for p in [ln["program"] for ln in cal] + runs)
        print(f"{name}: lower {out['lower'][name]:.4g} upper {out['upper'][name]:.4g} limit {lim} ({n} seeds)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

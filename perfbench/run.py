"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``check``: each compared number
beside its limit); the same numbers end standard error. Without a CUDA
device, with JAX or the JAX package loaded, or on any failure, it prints
no result and exits with a code other than 0.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configure() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths; no
    JAX behind a library's back; one thread for each numerical library; the
    checkout importable."""
    cache = os.path.join(ROOT, ".perfbench_cache")
    os.environ["IEF_TORCH_BUILD_DIR"] = os.path.join(cache, "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    # few threads: the sweep's own pools and the launching thread share the host
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    configure()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness

    try:
        result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_PROCESS)
    except harness.Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"perfbench: the run loaded {', '.join(loaded)}; the port must not", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict, out=None, err=None) -> None:
    """The compared numbers with their limits as the last lines of standard
    error, then the result as the last line of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, row in result["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=err)
    print(f"correct {result['correct']}", file=err)
    print(json.dumps(result), file=out, flush=True)


if __name__ == "__main__":
    sys.exit(main())

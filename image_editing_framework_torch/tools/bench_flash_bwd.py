"""Time the flash backward on the card, per shape of null-text inversion.

    python3 image_editing_framework_torch/tools/bench_flash_bwd.py [--root DIR] [--label NAME]

For each site shape the NTI gradient flows through (SD1.5 512² and SDXL
1024², batch 1, bf16; q, k, v and dO as the head-split views the UNet and
autograd pass): ``flash_bwd_dq``, ``flash_bwd_dkv`` and the whole
``flash_attention_bwd`` (di, dq, dkv), each in device ms from replays of a
CUDA graph of 20 calls (``*_device_ms``, the kernels alone) and in ms from
CUDA events over back-to-back calls (``*_ms``: where the host takes longer to
enqueue a call than the card to run it, this is the host's rate); SDPA's
backward on the same inputs as device ms, the sum of its kernels' times
under torch.profiler (``sdpa_bwd_device_ms``: a yardstick, never called by
the port); the bound (the larger of operations over the bf16 peak and bytes
over the memory rate) and the share of peak (bound / device ms). Then, per
model, the sums over one inner iteration's sites. ``--root`` imports the
package from another checkout, so that two trees can be compared in one run
on one card (parent, change, change, parent). One JSON line per shape and
per model, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

# (model, tokens, head dim, heads, sites): the self-attention sites one NTI
# inner iteration's gradient flows through, at batch 1
SHAPES = [("sd", 4096, 40, 8, 4), ("sd", 1024, 80, 8, 5), ("sd", 256, 160, 8, 5), ("sd", 64, 160, 8, 1),
          ("xl", 4096, 64, 10, 9), ("xl", 1024, 64, 20, 60)]
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
HBM = 3.35e12  # bytes/s


def work(h: int, n: int, d: int, kernel: str) -> tuple:
    """(FLOPs, bytes) each function must do at batch 1, bf16, Nq = Nk = n:
    ``dq`` three products (S, dP, dS·K), q/k/v/dO/lse/di read and dq written;
    ``dkv`` four (S, dP, Pᵀ·dO, dSᵀ·Q), dk/dv written; ``all`` the whole
    backward: five products, q/k/v/o/dO read and dq/dk/dv written."""
    stats = 2 * 4 * h * n
    if kernel == "dq":
        return 6.0 * h * n * n * d, 5 * n * h * d * 2 + stats
    if kernel == "dkv":
        return 8.0 * h * n * n * d, 6 * n * h * d * 2 + stats
    return 10.0 * h * n * n * d, 8 * n * h * d * 2


def bound_ms(flops: float, nbytes: float) -> float:
    return 1e3 * max(flops / PEAK_BF16, nbytes / HBM)


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--root", default=here, help="checkout to import the package from (default: this one)")
    parser.add_argument("--label", default="", help="name printed with every line")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from image_editing_framework_torch.ops import flash_attention as fa
    from image_editing_framework_torch.ops.attention import split_heads
    from image_editing_framework_torch.tools.bench_flash_fwd import busy_ms, cuda_ms, graph_ms

    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_bwd: the timings need a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, sums = [], {}
    for model, n, d, h, sites in SHAPES:
        q, k, v, do = (split_heads(torch.randn(1, n, h * d, device="cuda", dtype=torch.bfloat16, generator=gen), h)
                       for _ in range(4))
        o, lse = fa.flash_attention(q, k, v, return_lse=True)
        di, scale = fa._bwd_di(o, do), 1.0 / math.sqrt(d)
        calls = {
            "dq": lambda: fa.flash_bwd_dq(q, k, v, None, do, lse, di, scale),
            "dkv": lambda: fa.flash_bwd_dkv(q, k, v, None, do, lse, di, scale),
            "all": lambda: fa.flash_attention_bwd(q, k, v, None, o, do, lse),
        }
        row = dict(label=args.label, source=fa.__file__, model=model, shape=[1, h, n, n, d], sites=sites,
                   do_strides=list(do.stride()))
        for name, fn in calls.items():
            flops, nbytes = work(h, n, d, name)
            row[f"{name}_device_ms"] = graph_ms(fn)
            row[f"{name}_ms"] = cuda_ms(fn)
            row[f"{name}_bound_ms"] = bound_ms(flops, nbytes)
            row[f"{name}_share_of_peak"] = row[f"{name}_bound_ms"] / row[f"{name}_device_ms"]
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = sdpa(qg, kg, vg)
        row["sdpa_bwd_device_ms"] = busy_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True))
        rows.append(row)
        print(json.dumps(row), flush=True)
        part = sums.setdefault(model, {})
        for key in ("dq_device_ms", "dkv_device_ms", "all_device_ms", "all_ms", "sdpa_bwd_device_ms",
                    "dq_bound_ms", "dkv_bound_ms", "all_bound_ms"):
            part[key] = part.get(key, 0.0) + sites * row[key]
    for model, part in sums.items():
        line = dict(label=args.label, model=model, per="one NTI inner iteration (batch 1)", **part)
        rows.append(line)
        print(json.dumps(line), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    return rows


if __name__ == "__main__":
    main()

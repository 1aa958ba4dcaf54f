"""Time the NHWC GroupNorm kernel on the card against its bound and PyTorch.

    python3 -m image_editing_framework_torch.tools.bench_group_norm

For each GroupNorm level of the main paths (SD1.5, SD2.1 and SDXL UNets at
their sweeps' edit batch, 32 groups; the VAE at 512², batch 8), bf16 with the
SiLU fused in: the device ms of the forward kernels (``fwd_ms``) and of the
backward kernels giving dx alone, as pix2pix-zero's gradient asks
(``bwd_ms``), from replays of a CUDA graph; the bound, one read of x and one
write of y at 3.35 TB/s (``bound_ms``), and the forward's share of it
(``fwd_roofline``, %); PyTorch's ``F.group_norm`` then ``F.silu`` on the
contiguous NCHW activation, as the UNet ran them before (``library_ms``:
the plain version, the same calls), on a channels-last one (``library_cl_ms``:
PyTorch's CUDA GroupNorm copies it contiguous first), and its backward
(``library_bwd_ms``: forward and backward in one graph, less the forward);
the host µs one call takes to return (``enqueue_us``, ``library_enqueue_us``);
the device µs of each of the port's kernels in a call (``kernels_us``, from
torch.profiler). One JSON line per level, then the card's name and power
limit.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

# (name, N, C, H, W)
LEVELS = [("sd15.64", 16, 320, 64, 64), ("sd15.32", 16, 640, 32, 32), ("sd15.16", 16, 1280, 16, 16),
          ("sd15.8", 16, 1280, 8, 8), ("sd21.96", 16, 320, 96, 96), ("sd21.48", 16, 640, 48, 48),
          ("sd21.24", 16, 1280, 24, 24), ("sd21.12", 16, 1280, 12, 12), ("sdxl.128", 8, 320, 128, 128),
          ("sdxl.64", 8, 640, 64, 64), ("sdxl.32", 8, 1280, 32, 32), ("vae.512", 8, 128, 512, 512),
          ("vae.256", 8, 256, 256, 256), ("vae.128", 8, 512, 128, 128), ("vae.64", 8, 512, 64, 64)]
GROUPS = 32


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """ms per call of fn() from replays of a CUDA graph of ``calls`` calls:
    the device's time, without the host's per-launch cost."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def enqueue_us(fn, reps: int = 200, rounds: int = 5) -> float:
    """Host µs per call of fn() over ``reps`` unsynchronised calls, the
    least of ``rounds`` rounds."""
    import torch

    for _ in range(3):
        fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, time.perf_counter() - start)
        torch.cuda.synchronize()
    return 1e6 * best / reps


def kernels_us(fn, reps: int = 20) -> dict:
    """Device µs per call of fn() of each ``gn_*`` kernel it launches, from
    torch.profiler (empty where the profiler records no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        m = re.search(r"(gn_[a-z_]+)<", e.name)
        if m and e.device_type == torch.autograd.DeviceType.CUDA:
            out[m.group(1)] = out.get(m.group(1), 0.0) + e.device_time_total / reps
    return out


def level(name, n, c, h, w) -> dict:
    import torch
    import torch.nn.functional as F

    from image_editing_framework_torch.ops import group_norm as gn

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, c, h, w, device="cuda", generator=gen).to(torch.bfloat16)
    weight = (1 + 0.1 * torch.randn(c, device="cuda", generator=gen)).to(torch.bfloat16)
    bias = (0.1 * torch.randn(c, device="cuda", generator=gen)).to(torch.bfloat16)
    cl = x.contiguous(memory_format=torch.channels_last)
    dy = torch.randn_like(cl)
    _, mean, rstd = gn._forward(cl, weight, bias, GROUPS, 1e-5, True)
    forward = lambda: gn.group_norm_nhwc(cl, weight, bias, GROUPS, 1e-5, True)  # noqa: E731
    library = lambda t: F.silu(F.group_norm(t, GROUPS, weight, bias, 1e-5))  # noqa: E731
    xr = x.detach().requires_grad_()

    def library_both():
        return torch.autograd.grad(library(xr), xr, dy.contiguous())

    row = dict(level=name, shape=[n, c, h, w], fwd_ms=graph_ms(forward),
               bwd_ms=graph_ms(lambda: gn.group_norm_nhwc_bwd(cl, dy, weight, bias, mean, rstd, GROUPS, True,
                                                               params=False)),
               bound_ms=2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3,
               library_ms=graph_ms(lambda: library(x)), library_cl_ms=graph_ms(lambda: library(cl)),
               enqueue_us=enqueue_us(forward), library_enqueue_us=enqueue_us(lambda: library(x)))
    row["library_bwd_ms"] = graph_ms(library_both) - row["library_ms"]
    row["kernels_us"] = kernels_us(forward)
    row["kernels_us"].update(kernels_us(lambda: gn.group_norm_nhwc_bwd(cl, dy, weight, bias, mean, rstd, GROUPS, True,
                                                                       params=False)))
    row["fwd_roofline"] = 100.0 * row["bound_ms"] / row["fwd_ms"]
    return row


def main() -> list:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_group_norm: the timings need a CUDA card")
    rows = []
    for spec in LEVELS:
        rows.append(level(*spec))
        print(json.dumps(rows[-1]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    return rows


if __name__ == "__main__":
    sys.exit(0 if main() else 1)

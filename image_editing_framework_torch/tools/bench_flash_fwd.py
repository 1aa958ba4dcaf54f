"""Time the flash forward on the card: kernel ms and the wrapper's enqueue.

    python3 image_editing_framework_torch/tools/bench_flash_fwd.py [--root DIR] [--label NAME] [--e2e]

For each shape of the main paths (SDXL 1024² and SD1.5 512² self-attention
sites, bf16, the head-split views the UNet passes): the ms of one call
from CUDA events over back-to-back calls (``ms``, as ``chip_smoke.py``
times it: where the host takes longer to enqueue a call than the card to
run it, this is the host's rate) and over replays of a CUDA graph of 20
calls (``device_ms``: the kernel alone), SDPA's ``device_ms`` on the same
inputs (a yardstick, never called by the port), and the host µs one call
of ``flash_attention`` takes to return (``enqueue_us``: argument checks,
tensor maps, the launch), timed over calls that are not synchronised, the
least of five rounds.
``--e2e`` adds, on the SDXL base pipeline at 1024² (random weights, seed
0): one UNet forward at CFG batch 4 and at batch 1 (ms from CUDA events,
device busy ms from torch.profiler) and one 50-step P2P edit with decode
(host seconds), and one SD1.5 UNet forward at CFG batch 4. ``--root``
imports the package from another checkout, so that two trees can be
compared in one run on one card (parent, change, change, parent). One JSON
line per measurement, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# (batch, heads, tokens, head dim)
SHAPES = [(4, 10, 4096, 64), (4, 20, 1024, 64), (1, 10, 4096, 64), (1, 20, 1024, 64),
          (4, 8, 4096, 40), (4, 8, 1024, 80), (4, 8, 256, 160), (4, 8, 64, 160)]


def cuda_ms(fn, reps: int = 50) -> float:
    """Mean ms of fn() over ``reps`` back-to-back calls, CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def busy_ms(fn, reps: int = 5, tries: int = 3) -> float:
    """Device busy ms per call of fn(): the sum of kernel times under
    torch.profiler. A profile that recorded no device time (seen once among
    many profiles in one process) is taken again, up to ``tries`` times,
    then raises: fn() always launches kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / reps / 1e3
        if busy > 0:
            return busy
    raise RuntimeError(f"torch.profiler recorded no device time in {tries} profiles")


def end_to_end(label: str) -> list:
    """UNet forwards and one P2P edit on SDXL 1024², a UNet forward on SD1.5
    512²; bf16, random weights (seed 0)."""
    import numpy as np
    import torch

    from image_editing_framework_torch.core.config import P2PConfig, SamplerConfig
    from image_editing_framework_torch.methods import common
    from image_editing_framework_torch.methods.p2p import p2p_edit
    from image_editing_framework_torch.pipelines import random_pipeline

    prompts = ["a photo of a cat sitting on the grass", "a photo of a dog sitting on the grass"]
    rows = []
    for version, side in (("xl", 1024), ("1.5", 512)):
        pipe = random_pipeline(version, num_steps=50, dtype=torch.bfloat16, seed=0, device="cuda")
        ctx, added = common.prepare_conditioning(pipe, prompts, side, side)
        added1 = None if added is None else {k: v[2:3] for k, v in added.items()}
        lat4 = torch.randn(4, side // 8, side // 8, 4, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator(device="cuda").manual_seed(0))
        batches = [(4, lat4, ctx, added)] + ([(1, lat4[:1], ctx[2:3], added1)] if version == "xl" else [])
        for batch, lat, c, add in batches:
            forward = lambda: pipe.unet_apply(lat, 501, c, None, add)  # noqa: E731
            row = dict(label=label, model=version, batch=batch, unet_forward_ms=cuda_ms(forward, reps=10),
                       unet_busy_ms=busy_ms(forward))
            rows.append(row)
            print(json.dumps(row), flush=True)
        if version == "xl":
            cfg = P2PConfig(edit_type="replace", blend_words=(("cat",), ("dog",)))
            sampler = SamplerConfig(num_inference_steps=50, height=side, width=side)
            last = lat4[:1].clone()
            torch.cuda.synchronize()
            start = time.perf_counter()
            images = p2p_edit(pipe, prompts, last, cfg, sampler)
            torch.cuda.synchronize()
            row = dict(label=label, model=version, edit_and_decode_s=time.perf_counter() - start,
                       image_std=float(np.asarray(images).std()))
            rows.append(row)
            print(json.dumps(row), flush=True)
        del pipe
        torch.cuda.empty_cache()
    return rows


def enqueue_us(fn, reps: int = 200, rounds: int = 5) -> float:
    """Host µs per call of fn() over ``reps`` calls that are not
    synchronised (the queue is drained before and after), the least of
    ``rounds`` rounds: other work on a shared host only adds time."""
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


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--root", default=here, help="checkout to import the package from (default: this one)")
    parser.add_argument("--label", default="", help="name printed with every line")
    parser.add_argument("--e2e", action="store_true", help="also time UNet forwards and an SDXL P2P edit")
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from image_editing_framework_torch.ops import flash_attention as fa
    from image_editing_framework_torch.ops.attention import split_heads

    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_fwd: the timings need a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for b, h, n, d in SHAPES:
        q, k, v = (split_heads(torch.randn(b, n, h * d, device="cuda", dtype=torch.bfloat16, generator=gen), h)
                   for _ in range(3))
        forward = lambda: fa.flash_attention(q, k, v)  # noqa: E731
        row = dict(label=args.label, source=fa.__file__, shape=[b, h, n, n, d], ms=cuda_ms(forward),
                   device_ms=graph_ms(forward), enqueue_us=enqueue_us(forward),
                   library_device_ms=graph_ms(lambda: sdpa(q, k, v)))
        row["tflops"] = 4.0 * b * h * n * n * d / row["device_ms"] / 1e9
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.e2e:
        rows += end_to_end(args.label)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    return rows


if __name__ == "__main__":
    main()

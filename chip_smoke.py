"""Chip smoke test of the PyTorch port on one NVIDIA card (H100).

Run from the repository root:  python3 chip_smoke.py

Phases, one line of output each (any failure exits non-zero):
  1. device: card name and power limit, torch/CUDA versions, kernel build
     (every CUDA source of the port, one nvcc each, all started together);
  2. kernels: each kernel against its plain PyTorch version on the card at
     its path's shapes, as the head-split views the UNet passes (bf16 and
     f32), and at edge cases (padded Nk, Nq off the tile, NEG_INF bias
     segments, fully masked rows, lse), within ``parity_atol`` (forward)
     and ``grad_parity_atol`` (backward); at the path's shapes also the
     kernel's, plain version's and library call's times, the bound, and the
     readings of planted faults (emulated in plain PyTorch) that the bf16
     limit must reject;
  3. tiny: the tiny pipeline's invert + P2P edit, and its null-text
     inversion + edit, on the card against the same pipeline on the CPU (the
     kernels' plain versions);
  4. main path: SD1.5 at full width (random weights from a seed), 512²,
     bf16 — image2latent, 50-step DDIM inversion, 50-step P2P replace edit
     with LocalBlend at CFG batch 4, decode — with the launch counts of
     every kernel read around it (forward only);
  5. nti path: the same model and edit through null-text inversion
     (``cli.invert(..., "null-text")``, 50 steps of up to 10 Adam
     iterations, each a UNet forward and backward), the edit taking the
     per-step embeddings; launch counts of every kernel read around it;
  6. profile: one UNet forward at the edit's and the inversion's batch under
     torch.profiler: device busy time, idle share, launches, top kernels;
then each phase's seconds, the kernels JSON line, the card line, and the
result line last.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

STEPS = 50
PATH_SHAPES = [(4096, 40, 5), (1024, 80, 5), (256, 160, 5), (64, 160, 1)]  # (tokens, head dim, sites)
# the self-attention sites NTI's gradient flows through (the first site of
# down block 0 sees no embedding): (tokens, head dim, sites)
GRAD_SHAPES = [(4096, 40, 4), (1024, 80, 5), (256, 160, 5), (64, 160, 1)]
GRAD_SITES = sum(sites for _, _, sites in GRAD_SHAPES)
SOURCES = ("flash_fwd", "flash_bwd")
HEADS = 8
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12  # CUDA-core f32 FLOP/s
HBM = 3.35e12  # bytes/s
KEY_TILE = 64  # keys per tile of the bf16 kernels (csrc/flash_fwd.cu kBK, csrc/flash_bwd.cu kTile)
PROFILE_REPS = 10


def emit(tag, **fields):
    print(json.dumps({"phase": tag, **fields}), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, min_ms=50.0):
    """Mean ms of fn() over a run of launches timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = max(3, min(200, int(min_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attn_work(b, h, nq, nk, d, dtype):
    """(FLOPs, bytes) attention must do: two matmuls; q, k, v read once and
    o written once."""
    flops = 4.0 * b * h * nq * nk * d
    nbytes = (2 * b * h * nq * d + 2 * b * h * nk * d) * torch.tensor([], dtype=dtype).element_size()
    return flops, nbytes


def bwd_work(b, h, nq, nk, d, dtype, kernel):
    """(FLOPs, bytes) each backward function must do. ``dq``: S, dP and dS·K
    (three products), q/k/v/dO/lse/di read and dq written; ``dkv``: S, dP,
    Pᵀ·dO and dSᵀ·Q (four), dk/dv written; ``all``, the whole backward:
    five products (S, dP, dV, dQ, dK), q/k/v/o/dO read and dq/dk/dv
    written."""
    es = torch.tensor([], dtype=dtype).element_size()
    stats = 2 * 4 * b * h * nq  # lse and di, f32
    if kernel == "dq":
        return 6.0 * b * h * nq * nk * d, (3 * nq + 2 * nk) * b * h * d * es + stats
    if kernel == "dkv":
        return 8.0 * b * h * nq * nk * d, (2 * nq + 4 * nk) * b * h * d * es + stats
    return 10.0 * b * h * nq * nk * d, (4 * nq + 4 * nk) * b * h * d * es


def bound_ms(flops, nbytes, dtype):
    """Least time on the card: the larger of operations over peak and bytes
    over the memory rate."""
    t_ops = flops / (PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
    t_bytes = nbytes / HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_device():
    from image_editing_framework_torch.ops import _cuda

    def build(name):
        t0 = time.perf_counter()
        _cuda.build(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        each = dict(zip(SOURCES, pool.map(build, SOURCES)))
    emit("device", card=card_line(), torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), build_s=round(time.perf_counter() - t0, 3),
         build_s_each={k: round(v, 3) for k, v in each.items()})


def fault_readings(q, k, v, ref):
    """max|O - ref| of three broken kernels, emulated in plain PyTorch on
    the same bf16 inputs: one key tile skipped, the accumulator not rescaled
    when the running max grows, P left unrounded before P·V."""
    from image_editing_framework_torch.ops import flash_attention as fa

    nk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    bias = torch.zeros(q.shape[0], nk, device=q.device)
    bias[:, nk - KEY_TILE:] = float("-inf")
    skipped = fa.flash_attention_reference(q, k, v, bias)
    m = torch.full_like(s[..., :1], float("-inf"))
    l = acc = 0.0
    for j in range(0, nk, KEY_TILE):
        tile = s[..., j:j + KEY_TILE]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        p = torch.exp(tile - m_new)
        l = l * torch.exp(m - m_new) + p.sum(-1, keepdim=True)
        acc = acc + torch.matmul(p.to(v.dtype).float(), v[:, :, j:j + KEY_TILE].float())  # no acc·alpha
        m = m_new
    p = torch.exp(s - s.amax(-1, keepdim=True))
    unrounded = torch.matmul(p, v.float()) / p.sum(-1, keepdim=True)
    del s, p
    return {name: (out.to(q.dtype).float() - ref.float()).abs().max().item()
            for name, out in (("skipped_key_tile", skipped), ("no_acc_rescale", acc / l),
                              ("p_unrounded", unrounded))}


def phase_kernels(gen):
    """Kernel vs plain version; times at the path's shapes. Returns the
    worst errors and the 16-site sums of one CFG-batch UNet forward."""
    from image_editing_framework_torch.ops import flash_attention as fa
    from image_editing_framework_torch.ops.attention import split_heads

    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0, "bytes": 0.0}

    def check(dtype, b, h, nq, nk, d, bias=None, lse=False, timed=False, sites=0):
        """Path shapes (timed) come as the UNet gives them: head-split views
        of (B, N, H·D) projections; the edge cases as contiguous tensors."""
        def make(n):
            if timed:
                return split_heads(torch.randn(b, n, h * d, device="cuda", dtype=dtype, generator=gen), h)
            return torch.randn(b, h, n, d, device="cuda", dtype=dtype, generator=gen)

        q, k, v = make(nq), make(nk), make(nk)
        out = fa.flash_attention(q, k, v, bias, return_lse=lse)
        ref = fa.flash_attention_reference(q, k, v, bias, return_lse=lse)
        torch.cuda.synchronize()
        if lse:
            (out, out_lse), (ref, ref_lse) = out, ref
            finite = torch.isfinite(ref_lse)
            lse_err = (out_lse[finite] - ref_lse[finite]).abs().max().item() if finite.any() else 0.0
            if not torch.equal(torch.isfinite(out_lse), finite) or lse_err > 1e-3:
                raise AssertionError(f"lse mismatch {lse_err}")
        err, tol = (out.float() - ref.float()).abs().max().item(), fa.parity_atol(ref)
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"flash kernel disagrees with its plain version: {err} > {tol}")
        worst[dtype] = max(worst[dtype], err)
        row = dict(dtype=str(dtype).split(".")[1], shape=[b, h, nq, nk, d], strides=list(q.stride()),
                   bias=bias is not None, lse=lse, max_abs_err=err, tol=tol)
        if timed and dtype == torch.bfloat16:
            row["faults"] = faults = fault_readings(q, k, v, ref)
            must_fail = ["skipped_key_tile"] + (["no_acc_rescale"] if nk > KEY_TILE else [])
            passed = [name for name in must_fail if not faults[name] > tol]
            if passed:
                raise AssertionError(f"the bf16 limit {tol} does not reject the planted faults {passed}: {faults}")
        if timed:
            flops, nbytes = attn_work(b, h, nq, nk, d, dtype)
            bound, by = bound_ms(flops, nbytes, dtype)
            row.update(
                ms=cuda_ms(lambda: fa.flash_attention(q, k, v)),
                plain_ms=cuda_ms(lambda: fa.flash_attention_reference(q, k, v)),
                library_ms=cuda_ms(lambda: sdpa(q, k, v)),
                bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
            )
            if dtype == torch.bfloat16 and b == 4:
                for key in sums:
                    sums[key] += sites * row[key]
        emit("kernel", name="flash_fwd", **row)

    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 4):
            for n, d, sites in PATH_SHAPES:
                check(dtype, b, HEADS, n, n, d, timed=True, sites=sites)
        for nk in (77, 1000):  # keys not a multiple of the kernel's tile
            check(dtype, 2, HEADS, 256, nk, 40, lse=True)
        bias = torch.zeros(2, 1000, device="cuda")
        bias[:, 200:600] = fa.NEG_INF  # a masked segment
        bias[1] = fa.NEG_INF  # a fully NEG_INF-masked row: equal weights
        check(dtype, 2, HEADS, 300, 1000, 80, bias=bias, lse=True)
        bias = torch.zeros(2, 512, device="cuda")
        bias[0] = float("-inf")  # every logit -inf: the row returns 0
        check(dtype, 2, HEADS, 64, 512, 160, bias=bias, lse=True)
    sums["bound_ms"], sums["bound_by"] = bound_ms(sums["flops"], sums["bytes"], torch.bfloat16)
    return worst, sums


def bwd_fault_readings(q, k, v, do, o, lse, ref):
    """max|grad - ref| per output of three broken backward kernels, emulated
    in plain PyTorch on the same bf16 inputs: di left out (as if O were 0),
    one 64-key tile skipped in dQ (its keys' P set to 0), one 64-query tile
    skipped in dK/dV (its queries' P set to 0). Each fault names the outputs
    it reaches."""
    from image_editing_framework_torch.ops import flash_attention as fa

    nq, nk = q.shape[2], k.shape[2]
    key_bias = torch.zeros(q.shape[0], nk, device=q.device)
    key_bias[:, nk - KEY_TILE:] = float("-inf")
    lse_skip = lse.clone()
    lse_skip[:, :, max(0, nq - KEY_TILE):] = float("-inf")
    faults = {
        "no_di": (fa.flash_attention_bwd_reference(q, k, v, None, torch.zeros_like(o), do, lse), ("dq", "dk")),
        "skipped_key_tile_dq": (fa.flash_attention_bwd_reference(q, k, v, key_bias, o, do, lse), ("dq",)),
        "skipped_query_tile_dkv": (fa.flash_attention_bwd_reference(q, k, v, None, o, do, lse_skip), ("dk", "dv")),
    }
    names = ("dq", "dk", "dv")
    return {name: {out: (grads[names.index(out)].float() - ref[names.index(out)].float()).abs().max().item()
                   for out in reaches}
            for name, (grads, reaches) in faults.items()}


def phase_bwd_kernels(gen):
    """Both backward kernels against their plain version; times at NTI's
    shapes. Returns the worst errors and, per kernel, the sums over the 15
    sites of one inner iteration (one UNet backward at batch 1)."""
    from image_editing_framework_torch.ops import flash_attention as fa
    from image_editing_framework_torch.ops.attention import split_heads

    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst = {dtype: {"dq": 0.0, "dkv": 0.0} for dtype in (torch.bfloat16, torch.float32)}
    keys = ("ms", "plain_ms", "library_ms", "flops", "bytes")
    sums = {kernel: dict.fromkeys(keys, 0.0) for kernel in ("dq", "dkv", "all")}

    def check(dtype, b, h, nq, nk, d, bias=None, timed=False, sites=0, zero_batch=None):
        """Path shapes (timed) come as the UNet and autograd give them:
        head-split views of (B, N, H·D) tensors, dO included; the edge cases
        as contiguous tensors."""
        def make(n):
            if timed:
                return split_heads(torch.randn(b, n, h * d, device="cuda", dtype=dtype, generator=gen), h)
            return torch.randn(b, h, n, d, device="cuda", dtype=dtype, generator=gen)

        q, k, v, do = make(nq), make(nk), make(nk), make(nq)
        o, lse = fa.flash_attention(q, k, v, bias, return_lse=True)
        copies = fa.flash_attention_bwd.copies
        got = fa.flash_attention_bwd(q, k, v, bias, o, do, lse)
        ref = fa.flash_attention_bwd_reference(q, k, v, bias, o, do, lse)
        torch.cuda.synchronize()
        if fa.flash_attention_bwd.copies != copies:
            raise AssertionError(f"dO with strides {do.stride()} was copied")
        errs, tols = {}, {}
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            errs[name], tols[name] = (a.float() - r.float()).abs().max().item(), fa.grad_parity_atol(r)
            if not math.isfinite(errs[name]) or errs[name] > tols[name]:
                raise AssertionError(f"flash backward {name} disagrees with its plain version: "
                                     f"{errs[name]} > {tols[name]}")
            if zero_batch is not None and not torch.all(a[zero_batch] == 0):
                raise AssertionError(f"{name} of a row whose every logit is -inf is not 0")
        worst[dtype]["dq"] = max(worst[dtype]["dq"], errs["dq"])
        worst[dtype]["dkv"] = max(worst[dtype]["dkv"], errs["dk"], errs["dv"])
        row = dict(dtype=str(dtype).split(".")[1], shape=[b, h, nq, nk, d], strides=list(do.stride()),
                   bias=bias is not None, max_abs_err=errs, tol=tols)
        if timed and dtype == torch.bfloat16:
            row["faults"] = faults = bwd_fault_readings(q, k, v, do, o, lse, ref)
            passed = [name for name, reads in faults.items() if not any(e > tols[out] for out, e in reads.items())]
            if passed:
                raise AssertionError(f"the bf16 limits {tols} do not reject the planted faults {passed}: {faults}")
        if timed:
            scale = 1.0 / math.sqrt(d)
            di = fa._bwd_di(o, do)
            qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
            out = sdpa(qg, kg, vg)
            library_ms = cuda_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True))
            plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, None, o, do, lse))
            timing = {
                "dq": cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, None, do, lse, di, scale)),
                "dkv": cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, None, do, lse, di, scale)),
                "all": cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, None, o, do, lse)),
            }
            for kernel, ms in timing.items():
                flops, nbytes = bwd_work(b, h, nq, nk, d, dtype, kernel)
                bound, by = bound_ms(flops, nbytes, dtype)
                row[kernel] = dict(ms=ms, bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)
                if dtype == torch.bfloat16:
                    for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                                     ("flops", flops), ("bytes", nbytes)):
                        sums[kernel][key] += sites * val
            row.update(plain_ms=plain_ms, library_ms=library_ms)
        emit("kernel", name="flash_bwd", **row)

    for dtype in (torch.bfloat16, torch.float32):
        for n, d, sites in GRAD_SHAPES:
            check(dtype, 1, HEADS, n, n, d, timed=True, sites=sites)
        for nk in (77, 1000):  # Nq and Nk off the 64-row tile
            check(dtype, 2, HEADS, 130, nk, 40)
        bias = torch.zeros(2, 1000, device="cuda")
        bias[:, 200:600] = fa.NEG_INF  # a masked segment
        bias[1] = fa.NEG_INF  # a fully NEG_INF-masked row
        check(dtype, 2, HEADS, 300, 1000, 80, bias=bias)
        bias = torch.zeros(2, 512, device="cuda")
        bias[0] = float("-inf")  # every logit -inf: zero gradients
        check(dtype, 2, HEADS, 64, 512, 160, bias=bias, zero_batch=0)
    for kernel in sums:
        sums[kernel]["bound_ms"], sums[kernel]["bound_by"] = bound_ms(
            sums[kernel]["flops"], sums[kernel]["bytes"], torch.bfloat16)
    return worst, sums


def phase_tiny():
    """Tiny pipeline invert + P2P edit, and null-text inversion (4 steps, 2
    inner iterations) + the edit with its embeddings, on the card (f32
    kernels, head dims 16 and 32) against the same weights on the CPU (plain
    versions)."""
    from image_editing_framework_torch.core.config import NTIConfig, P2PConfig, SamplerConfig
    from image_editing_framework_torch.inversion.ddim import ddim_invert
    from image_editing_framework_torch.inversion.nti import null_text_inversion
    from image_editing_framework_torch.methods.base import denoise
    from image_editing_framework_torch.methods.p2p import p2p_setup
    from image_editing_framework_torch.models.weights import load_weights
    from image_editing_framework_torch.pipelines import tiny_pipeline

    torch.backends.cudnn.allow_tf32 = False
    prompts = ["a cat sitting on the grass", "a dog sitting on the grass"]
    cfg, sampler = P2PConfig(blend_words=(("cat",), ("dog",))), SamplerConfig(height=32, width=32)
    image = (np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)
    results, nti_results = [], []
    cpu = tiny_pipeline(num_steps=4, device="cpu")
    gpu = tiny_pipeline(num_steps=4, device="cuda")
    for name in ("unet", "vae", "text_encoder"):
        state = {k: v.numpy() for k, v in getattr(cpu, name).state_dict().items()}
        load_weights(getattr(gpu, name), state)
    for pipe in (cpu, gpu):
        last, traj, context, _ = ddim_invert(pipe, pipe.image2latent(image), prompts[0])
        lat0, ctx, ctrl, blend = p2p_setup(pipe, prompts, last, cfg, sampler)
        results.append(denoise(pipe, lat0, ctx, ctrl, blend=blend).cpu())
        uncond_seq = null_text_inversion(pipe, traj, context, NTIConfig(num_inner_steps=2))
        final = denoise(pipe, lat0, ctx, ctrl, blend=blend, uncond_seq=uncond_seq)
        nti_results.append((uncond_seq.cpu(), final.cpu()))
    torch.backends.cudnn.allow_tf32 = True
    err = (results[0] - results[1]).abs().max().item()
    # embeddings: a tenth of one Adam step (lr 1e-2), as the CPU parity tests
    emb_err = (nti_results[0][0] - nti_results[1][0]).abs().max().item()
    nti_err = (nti_results[0][1] - nti_results[1][1]).abs().max().item()
    if not (err < 1e-3 and nti_err < 1e-3 and emb_err < 1e-3):
        raise AssertionError(f"tiny pipeline on the card disagrees with the CPU: edit {err}, "
                             f"NTI embeddings {emb_err}, NTI edit {nti_err}")
    emit("tiny", max_abs_err=err, nti_embedding_max_abs_err=emb_err, nti_edit_max_abs_err=nti_err, tol=1e-3)


def timed(fn):
    """(fn(), host seconds around it, from one synchronize to the next)."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def launch_counts():
    """(forward, dQ, dK/dV) kernel launches since the counts were set to 0."""
    from image_editing_framework_torch.ops import flash_attention as fa

    return fa.flash_attention.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches


def reset_launch_counts():
    from image_editing_framework_torch.ops import flash_attention as fa

    fa.flash_attention.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0


def phase_main_path():
    """SD1.5 512² bf16 real-image P2P edit through the user entry points."""
    from image_editing_framework_torch.core.config import P2PConfig, SamplerConfig
    from image_editing_framework_torch.inversion.ddim import ddim_invert
    from image_editing_framework_torch.methods.p2p import p2p_edit
    from image_editing_framework_torch.pipelines import random_pipeline

    t0 = time.perf_counter()
    pipe = random_pipeline("1.5", num_steps=STEPS, dtype=torch.bfloat16, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    image = (np.random.RandomState(0).rand(512, 512, 3) * 255).astype(np.uint8)
    prompts = ["a photo of a cat sitting on the grass", "a photo of a dog sitting on the grass"]
    cfg = P2PConfig(edit_type="replace", blend_words=(("cat",), ("dog",)))
    sampler = SamplerConfig(num_inference_steps=STEPS)

    # one UNet forward at the edit's CFG batch (for the kernel's share of
    # it) and at the inversion's batch 1
    ctx = pipe.encode_prompts(prompts)[0]
    lat4 = torch.randn(4, 64, 64, 4, device="cuda", dtype=torch.bfloat16)
    unet_ms = cuda_ms(lambda: pipe.unet_apply(lat4, 501, ctx), min_ms=500.0)
    unet_b1_ms = cuda_ms(lambda: pipe.unet_apply(lat4[:1], 501, ctx[2:3]), min_ms=500.0)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    latent, encode_s = timed(lambda: pipe.image2latent(image))
    (last, traj, _, _), invert_s = timed(lambda: ddim_invert(pipe, latent, prompts[0]))
    images, edit_s = timed(lambda: p2p_edit(pipe, prompts, last, cfg, sampler))
    counts = launch_counts()
    _, decode_s = timed(lambda: pipe.latent2image(last.expand(2, -1, -1, -1)))

    expected = (16 * (STEPS + STEPS), 0, 0)
    if counts != expected:
        raise AssertionError(f"(forward, dQ, dK/dV) kernels launched {counts} times on the main path, "
                             f"expected {expected}")
    if images.shape != (2, 512, 512, 3) or images.dtype != np.uint8:
        raise AssertionError(f"edit output {images.shape} {images.dtype}")
    if not (torch.isfinite(traj.float()).all() and torch.isfinite(last.float()).all()):
        raise AssertionError("inversion produced non-finite latents")
    if images.std() == 0:
        raise AssertionError("edit output is constant")
    emit("main_path", model="SD1.5 (random weights, seed 0)", resolution=512, dtype="bfloat16", steps=STEPS,
         setup_s=setup_s, encode_s=encode_s, invert_s=invert_s, edit_and_decode_s=edit_s, decode_s=decode_s,
         unet_forward_cfg4_ms=unet_ms, unet_forward_b1_ms=unet_b1_ms, flash_launches=counts[0],
         bwd_launches=counts[1:], peak_gib=torch.cuda.max_memory_allocated() / 2**30,
         image_mean=float(images.mean()), card=card_line())
    return counts[0], unet_ms, (pipe, lat4, ctx)


def phase_nti_path(pipe):
    """SD1.5 512² bf16 real-image P2P edit through null-text inversion, the
    reference's default: ``cli.invert(..., "null-text")`` (DDIM inversion,
    then 50 steps of up to 10 Adam iterations on the unconditional
    embedding, default NTIConfig) and ``p2p_edit(uncond_seq=...)``."""
    from image_editing_framework_torch import cli
    from image_editing_framework_torch.core.config import P2PConfig, SamplerConfig
    from image_editing_framework_torch.inversion import nti
    from image_editing_framework_torch.methods.p2p import p2p_edit

    image = (np.random.RandomState(1).rand(512, 512, 3) * 255).astype(np.uint8)
    prompts = ["a photo of a cat sitting on the grass", "a photo of a dog sitting on the grass"]
    cfg = P2PConfig(edit_type="replace", blend_words=(("cat",), ("dog",)))
    sampler = SamplerConfig(num_inference_steps=STEPS)

    # the NTI call's own seconds and launch counts, read around it
    marks = {}
    inner = cli.null_text_inversion

    def nti_read(*args, **kw):
        marks["before"] = launch_counts()
        out, marks["nti_s"] = timed(lambda: inner(*args, **kw))
        marks["after"] = launch_counts()
        return out

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    nti.null_text_inversion.inner_iterations = 0
    cli.null_text_inversion = nti_read
    try:
        (last, traj, uncond_seq), invert_s = timed(lambda: cli.invert(pipe, image, prompts[0], "null-text", "p2p"))
    finally:
        cli.null_text_inversion = inner
    images, edit_s = timed(lambda: p2p_edit(pipe, prompts, last, cfg, sampler, uncond_seq=uncond_seq))
    counts = launch_counts()
    j = nti.null_text_inversion.inner_iterations

    nti_counts = tuple(a - b for a, b in zip(marks["after"], marks["before"]))
    if not STEPS <= j <= 10 * STEPS:
        raise AssertionError(f"{j} inner iterations over {STEPS} steps")
    if nti_counts != (16 * (2 * STEPS + j), GRAD_SITES * j, GRAD_SITES * j):
        raise AssertionError(f"NTI launched (forward, dQ, dK/dV) {nti_counts} times; J = {j}")
    if counts != (16 * (4 * STEPS + j), GRAD_SITES * j, GRAD_SITES * j):
        raise AssertionError(f"the NTI path launched (forward, dQ, dK/dV) {counts} times; J = {j}")
    if uncond_seq.shape != (STEPS, 77, 768) or not torch.isfinite(uncond_seq).all():
        raise AssertionError(f"NTI embeddings {tuple(uncond_seq.shape)} not finite or misshapen")
    if images.shape != (2, 512, 512, 3) or images.dtype != np.uint8 or images.std() == 0:
        raise AssertionError(f"edit output {images.shape} {images.dtype} constant or misshapen")
    emit("nti_path", model="SD1.5 (random weights, seed 0)", resolution=512, dtype="bfloat16", steps=STEPS,
         invert_s=invert_s - marks["nti_s"], nti_s=marks["nti_s"], edit_and_decode_s=edit_s,
         image_s=invert_s + edit_s, nti_share=marks["nti_s"] / (invert_s + edit_s), inner_iterations=j,
         nti_launches=nti_counts, launches=counts, uncond_moved=float((uncond_seq[-1] - uncond_seq[0]).abs().max()),
         peak_gib=torch.cuda.max_memory_allocated() / 2**30, image_mean=float(images.mean()), card=card_line())
    return counts


def phase_profile(pipe, lat4, ctx):
    """Device busy time of one UNet forward under torch.profiler (the sum of
    kernel durations on the one stream), against its unprofiled time."""
    from torch.profiler import ProfilerActivity, profile

    for batch, lat, c in ((4, lat4, ctx), (1, lat4[:1], ctx[2:3])):
        forward = lambda: pipe.unet_apply(lat, 501, c)  # noqa: E731
        wall_ms = cuda_ms(forward, min_ms=500.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_REPS):
                forward()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / PROFILE_REPS / 1e3
        if busy_ms == 0:
            raise AssertionError("the profiler recorded no device time")
        flash_ms = sum(e.self_device_time_total for e in kernels if "flash_fwd" in e.key) / PROFILE_REPS / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        emit("profile", batch=batch, wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
             launches_per_forward=sum(e.count for e in kernels) / PROFILE_REPS,
             flash_share_of_busy=flash_ms / busy_ms,
             top=[[e.key[:60], e.self_device_time_total / PROFILE_REPS / 1e3] for e in top])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    seconds = {}

    def run(name, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    run("device", phase_device)
    worst, sums = run("kernels", phase_kernels, gen)
    bwd_worst, bwd_sums = run("bwd_kernels", phase_bwd_kernels, gen)
    run("tiny", phase_tiny)
    launches, unet_ms, profile_args = run("main_path", phase_main_path)
    _, dq_launches, dkv_launches = run("nti_path", phase_nti_path, profile_args[0])
    run("profile", phase_profile, *profile_args)
    emit("seconds", **seconds)
    emit("share", flash_ms_per_cfg4_forward=sums["ms"], unet_forward_cfg4_ms=unet_ms,
         flash_share=sums["ms"] / unet_ms,
         bwd_ms_per_inner_iteration=bwd_sums["all"]["ms"], bwd_bound_ms_per_inner_iteration=bwd_sums["all"]["bound_ms"],
         bwd_bound_by=bwd_sums["all"]["bound_by"], sdpa_bwd_ms_per_inner_iteration=bwd_sums["all"]["library_ms"])
    work = "the 15 self-attention sites an SD1.5 512² NTI gradient flows through, batch 1, bf16 (one inner iteration)"
    bwd = [{
        "name": f"flash_bwd_{kernel}", "route": "cuda", "source": "image_editing_framework_torch/csrc/flash_bwd.cu",
        "replaces": f"image_editing_framework_tpu/ops/flash_attention.py:{line}",
        "also_replaces": f"image_editing_framework_tpu/ops/flash_attention.py:{line_t}",
        "launches": n, "max_abs_err": bwd_worst[torch.bfloat16][kernel],
        "max_abs_err_f32": bwd_worst[torch.float32][kernel],
        "ms": bwd_sums[kernel]["ms"], "plain_ms": bwd_sums[kernel]["plain_ms"],
        "bound_ms": bwd_sums[kernel]["bound_ms"], "bound_by": bwd_sums[kernel]["bound_by"],
        "library_ms": bwd_sums[kernel]["library_ms"], "work": work,
        "plain_and_library": "the whole backward (dq, dk, dv): the plain version and SDPA's backward",
    } for kernel, line, line_t, n in (("dq", 387, 540, dq_launches), ("dkv", 430, 593, dkv_launches))]
    kernel = {
        "name": "flash_fwd", "route": "cuda", "source": "image_editing_framework_torch/csrc/flash_fwd.cu",
        "replaces": "image_editing_framework_tpu/ops/flash_attention.py:76",
        "also_replaces": "image_editing_framework_tpu/ops/flash_attention.py:205",
        "launches": launches, "max_abs_err": worst[torch.bfloat16], "max_abs_err_f32": worst[torch.float32],
        "ms": sums["ms"], "plain_ms": sums["plain_ms"], "bound_ms": sums["bound_ms"], "bound_by": sums["bound_by"],
        "library_ms": sums["library_ms"],
        "work": "the 16 self-attention sites of one SD1.5 512² UNet forward at CFG batch 4, bf16",
    }
    print(json.dumps({"kernels": [kernel] + bwd}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

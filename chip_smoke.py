"""Chip smoke test of the PyTorch port on one NVIDIA card (H100).

Run from the repository root:  python3 chip_smoke.py

Phases, one line of output each (any failure exits non-zero):
  1. device: card name and power limit, torch/CUDA versions, kernel build
     (every CUDA source of the port, one nvcc each, all started together),
     then one line per forward, backward and probe instantiation with its
     registers, shared memory and spills from the build's ``-Xptxas -v``
     report (a bf16 instantiation that spills, or a count of them other than
     the source's, fails the phase);
  2. kernels: each kernel against its plain PyTorch version on the card at
     its paths' shapes (SD1.5's and SDXL's), as the head-split views the
     UNet passes (bf16 and f32), and at edge cases (padded Nk, Nq off the tile, NEG_INF bias
     segments, fully masked rows, lse), and at MasaCtrl's biased shapes
     (``BIAS_SHAPES``: the union plan's two K/V segments, the mask
     variants' fg/bg keys) with the bias the path builds, within
     ``parity_atol`` (forward) and ``grad_parity_atol`` (backward); at the
     path's shapes also the
     kernel's, plain version's and library call's times (the backward's
     also on the device: CUDA-graph replays, SDPA's under the profiler), the bound, and the
     readings of planted faults (emulated in plain PyTorch, at the tile of
     the kernel they check; at the biased shapes also the bias ignored)
     that the bf16 limit must reject; SDPA with the same float mask as the
     biased shapes' library time; the forward
     wrapper's host µs per call at a batch-1 SDXL site; the backward at
     NTI's batch-1 shapes and at pix2pix-zero's CFG batch 2 at every site;
     probe: the tile-shape probe kernel against its plain version for
     every layout and head dim, every block's value, then its timed table
     through the tool's entry point;
  3. tiny: the tiny pipeline's invert + P2P edit, and its null-text
     inversion + edit, on the card against the same pipeline on the CPU (the
     kernels' plain versions); the same for the tiny SDXL pipeline, its NTI
     with and without the checkpointed UNet; on both, MasaCtrl (mutual,
     union, mask, auto mask, direction), PnP and pix2pix-zero, whose guided
     steps never synchronise;
  4. main path: SD1.5 at full width (random weights from a seed), 512²,
     bf16 — image2latent, 50-step DDIM inversion, 50-step P2P replace edit
     with LocalBlend at CFG batch 4, decode — with the launch counts of
     every kernel read around it (forward only);
     checkpoint path: the reference's entry points on a checkpoint: the
     main path's weights written as an HF snapshot (fp16, with a synthetic
     49408-entry CLIP BPE vocab) and as an LDM single file, named through
     ``sd_mapping.sd_maps`` ("1.5", "ghostv2") and loaded by
     ``cli.load_pipe`` (timed per component; the two loads bitwise equal),
     then ``shims`` p2p ``edit_real`` (DDIM) on a 512² PNG and p2p
     ``edit_syn``, exact launch counts, the PNGs read back;
     sweep path: the PIE-Bench sweep (``shims`` p2p ``test``) from that
     snapshot over a mini PIE of 512² JPEGs (three items in the default
     categories, one outside): with ``--save_inversions``, again (resume),
     and from the cache (``--inversion_path``), exact launch counts, the
     PNGs, event log and stats read back, the cache's edits held to the
     first run's;
  5. nti path: the same model and edit through null-text inversion
     (``cli.invert(..., "null-text")``, 50 steps of up to 10 Adam
     iterations, each a UNet forward and backward), the edit taking the
     per-step embeddings; launch counts of every kernel read around it;
  6. profile: one UNet forward at the edit's and the inversion's batch under
     torch.profiler: device busy time, idle share, launches, top kernels;
  7. masactrl path: the same model through ``cli.invert(..., "ddim",
     "masactrl")`` and ``cli.run_method("masactrl", ...)`` (mutual), then
     edits alone with the union plan, a fixed mask and the auto mask, and a
     mutual edit with the NTI path's embeddings; pnp path:
     ``cli.run_method("pnp", ...)`` on the same inversion; exact launch
     counts of each run;
  8. p2z path: pix2pix-zero on the same model through ``cli.invert(...,
     "ddim", "p2z")`` and ``cli.run_method("p2z", ...)`` (50 guided steps,
     each a UNet forward and backward to the input latent at CFG batch 2,
     and a forward on the updated latent), then the edit alone on the NTI
     path's embeddings; exact launch counts of each run, seconds of each
     pass, and one guided step under torch.profiler;
  9. xl main path, xl checkpoint path, xl nti path, xl profile, xl masactrl
     path, xl pnp path, xl p2z path: the same on SDXL at full width, 1024²,
     bf16; the checkpoint path writes the SDXL base as a snapshot and a
     single file and the refiner's UNet as a snapshot, loads "xl-base",
     "animagineXL" and "xl-refiner" (bitwise, shared modules, one refiner
     img2img) and runs the p2p shim's ``edit_real`` at 1024² (the NTI path
     with ``XL_INNER_STEPS`` inner iterations per step and the checkpointed
     UNet; p2z with the references recomputed from pass 1's trajectory and
     the checkpointed UNet, the XL defaults), decode full-frame and tiled;
  10. refiner: img2img through the SDXL refiner at 1024², strength 0.3;
then each phase's seconds, the kernels JSON line, the card line, and the
result line last.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

STEPS = 50
# self-attention sites of one UNet forward, per model: (tokens, head dim, heads, sites)
PATH_SHAPES = {
    "sd": [(4096, 40, 8, 5), (1024, 80, 8, 5), (256, 160, 8, 5), (64, 160, 8, 1)],  # SD1.5 at 512²
    "xl": [(4096, 64, 10, 10), (1024, 64, 20, 60)],  # SDXL at 1024²
}
# the sites NTI's gradient flows through (the first site sees no embedding)
GRAD_SHAPES = {
    "sd": [(4096, 40, 8, 4), (1024, 80, 8, 5), (256, 160, 8, 5), (64, 160, 8, 1)],
    "xl": [(4096, 64, 10, 9), (1024, 64, 20, 60)],
}
# MasaCtrl's biased forward calls per CFG-4 UNet forward at its gated sites
# (SD1.5 layers 10-15, SDXL 54-69): (variant, tokens, keys, head dim, heads,
# calls). The union plan gives each gated site two K/V segments, the first
# (the source's) masked by NEG_INF on the source rows and, at ungated steps,
# on the target rows; the mask and auto variants make two calls per gated
# site (fg and bg keys of the source).
BIAS_SHAPES = {
    "sd": [("union", 1024, 2048, 80, 8, 3), ("union", 4096, 8192, 40, 8, 3),
           ("mask", 1024, 1024, 80, 8, 6), ("mask", 4096, 4096, 40, 8, 6)],
    "xl": [("union", 1024, 2048, 64, 20, 10), ("union", 4096, 8192, 64, 10, 6),
           ("mask", 1024, 1024, 64, 20, 20), ("mask", 4096, 4096, 64, 10, 12)],
}
# pix2pix-zero's guided step differentiates its loss with respect to the
# UNet's input latent at CFG batch 2: the gradient flows through every site
# of PATH_SHAPES, the first included
P2Z_BATCH = 2
SITES = {model: sum(shape[3] for shape in shapes) for model, shapes in PATH_SHAPES.items()}
GRAD_SITES = {model: sum(shape[3] for shape in shapes) for model, shapes in GRAD_SHAPES.items()}
SOURCES = ("flash_fwd", "flash_bwd", "mma_probe")
HEADS = 8  # of the edge cases
# NTI inner iterations per step on the XL path (the default is 10); 1 since
# the p2z paths joined the script, to keep it within half its time limit
XL_INNER_STEPS = 1
PROBE_RTOL = 1e-6  # probe kernel vs plain version, relative to the sum of the terms' magnitudes
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12  # CUDA-core f32 FLOP/s
HBM = 3.35e12  # bytes/s
FWD_KEY_TILE = 128  # keys per tile of the bf16 forward up to d = 80 (csrc/flash_fwd.cu kBK)
FWD_KEY_TILE_WIDE = 64  # ... at d = 160 (csrc/flash_fwd.cu kBKWide)
BWD_DQ_KEY_TILE = 128  # keys per streamed tile of the bf16 dQ kernel up to d = 80 (csrc/flash_bwd.cu kDqBK)
BWD_DQ_KEY_TILE_WIDE = 64  # ... at d = 160 (kDqBKWide)
BWD_DKV_QUERY_TILE = 64  # queries per streamed tile of the bf16 dK/dV kernel up to d = 80 (kDkvBQ)
BWD_DKV_QUERY_TILE_WIDE = 32  # ... at d = 160 (kDkvBQWide)
PROFILE_REPS = 4
XL_DISK_GIB = 20  # the SDXL base snapshot and single file (6.9 GB each) and the refiner's UNet (4.5 GB)


def fwd_key_tile(d):
    """Keys per tile of the bf16 forward at head dim d (csrc/flash_fwd.cu
    Tile<DP>::BK)."""
    return FWD_KEY_TILE if d <= 80 else FWD_KEY_TILE_WIDE


def bwd_dq_key_tile(d):
    """Keys per tile of the bf16 dQ kernel at head dim d (csrc/flash_bwd.cu
    DqTile<DP>::BK)."""
    return BWD_DQ_KEY_TILE if d <= 80 else BWD_DQ_KEY_TILE_WIDE


def bwd_dkv_query_tile(d):
    """Queries per tile of the bf16 dK/dV kernel at head dim d
    (csrc/flash_bwd.cu DkvTile<DP>::BQ)."""
    return BWD_DKV_QUERY_TILE if d <= 80 else BWD_DKV_QUERY_TILE_WIDE


EMITTED = {}  # tag -> the fields of its last line


def emit(tag, **fields):
    EMITTED[tag] = fields
    print(json.dumps({"phase": tag, **fields}), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, min_ms=50.0, warmup=3):
    """Mean ms of fn() over a run of launches timed with CUDA events."""
    for _ in range(warmup):
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


def ptxas_entries(report):
    """Registers, stack and spills of every kernel in an ``-Xptxas -v``
    report, keyed by its mangled name."""
    entries, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entries[name] = {}
        elif name and "bytes stack frame" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            entries[name].update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif name and "Used" in line and "registers" in line:
            entries[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return entries


def forward_instances():
    """Each instantiation of the forward kernels: padded head dim, bias,
    lse, registers, spills and (bf16) dynamic shared memory, from the build's
    ``-Xptxas -v`` report; ptxas warnings besides."""
    import ctypes

    from image_editing_framework_torch.ops import _cuda

    report = _cuda.ptxas_report("flash_fwd")
    smem = _cuda.load("flash_fwd").flash_fwd_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    rows = []
    for name, info in ptxas_entries(report).items():
        m = re.search(r"flash_fwd_(bf16|f32)ILi(\d+)ELb([01])ELb([01])E", name)
        if m:
            kind, dp = m.group(1), int(m.group(2))
            rows.append(dict(kernel=f"flash_fwd_{kind}", dp=dp, bias=m.group(3) == "1", lse=m.group(4) == "1",
                             smem_bytes=smem(dp) if kind == "bf16" else None, **info))
    warnings = [line.strip() for line in report.splitlines() if "warning" in line.lower()]
    return rows, warnings


def backward_instances():
    """Each instantiation of the backward kernels (dQ and dK/dV, bf16 and
    f32): padded head dim, bias, registers, spills and (bf16) dynamic shared
    memory, from the build's ``-Xptxas -v`` report; ptxas warnings besides.
    The bf16 kernels' registers are those at launch: their consumer
    warpgroup raises its own to 232 (setmaxnreg) where two blocks share an
    SM."""
    import ctypes

    from image_editing_framework_torch.ops import _cuda

    report = _cuda.ptxas_report("flash_bwd")
    smem = _cuda.load("flash_bwd").flash_bwd_smem_bytes
    smem.argtypes, smem.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    rows = []
    for name, info in ptxas_entries(report).items():
        m = re.search(r"bwd_(dq|dkv)_(bf16|f32)ILi(\d+)ELb([01])E", name)
        if m:
            which, kind, dp = m.group(1), m.group(2), int(m.group(3))
            rows.append(dict(kernel=f"flash_bwd_{which}_{kind}", dp=dp, bias=m.group(4) == "1",
                             smem_bytes=smem(dp, int(which == "dkv")) if kind == "bf16" else None, **info))
    warnings = [line.strip() for line in report.splitlines() if "warning" in line.lower()]
    return rows, warnings


# the probe kernel's instantiations: the S plan's two (K-major, MN-major) and
# the PV plan's B K-major or MN-major at each of its 5 wgmma widths
PROBE_INSTANCES = 12


def probe_instances(report):
    """Each instantiation of the probe kernel in its build's ``-Xptxas -v``
    report: plan, A / B MN-major, wgmma width, registers and spills;
    ptxas warnings besides."""
    rows = []
    for name, info in ptxas_entries(report).items():
        m = re.search(r"mma_probe_kernelILi([01])ELi([01])ELi([01])ELi(\d+)E", name)
        if m:
            rows.append(dict(kernel="mma_probe", plan=("s", "pv")[int(m.group(1))], ta=int(m.group(2)),
                             tb=int(m.group(3)), np=int(m.group(4)), **info))
    warnings = [line.strip() for line in report.splitlines() if "warning" in line.lower()]
    return rows, warnings


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
    found = {}
    # bf16 instantiations: the forward's 6 head dims x bias x lse; the
    # backward's 5 (d = 40 runs the 64-column kernels) x bias x (dQ, dK/dV);
    # the probe's 12 (all bf16)
    for source, read, count in (("flash_fwd", forward_instances, 24), ("flash_bwd", backward_instances, 20),
                                ("mma_probe", lambda: probe_instances(_cuda.ptxas_report("mma_probe")),
                                 PROBE_INSTANCES)):
        rows, warnings = read()
        bf16 = [r for r in rows if r["kernel"].endswith("_bf16") or r["kernel"] == "mma_probe"]
        for row in rows:
            emit("ptxas", **row)
        emit("ptxas_warnings", source=source, warnings=warnings)
        spilled = [r for r in bf16 if r.get("spill_stores") or r.get("spill_loads")]
        if len(bf16) != count or spilled:
            raise AssertionError(f"{len(bf16)} bf16 {source} instantiations ({count} expected); spills in {spilled}")
        found[source] = bf16
    return found


def fault_readings(q, k, v, ref, bias=None):
    """max|O - ref| of three broken kernels, emulated in plain PyTorch on
    the same bf16 inputs and bias, with the forward's key tile at this head
    dim: the last key tile skipped, the accumulator not rescaled when the
    running max grows, P left unrounded before P·V; with a bias, a fourth
    that ignores it."""
    from image_editing_framework_torch.ops import flash_attention as fa

    nk, tile_keys = k.shape[2], fwd_key_tile(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if bias is not None:
        s += bias[:, None, None, :]
    skip = torch.zeros(q.shape[0], nk, device=q.device) if bias is None else bias.clone()
    skip[:, (nk - 1) // tile_keys * tile_keys:] = float("-inf")
    outs = {"skipped_key_tile": fa.flash_attention_reference(q, k, v, skip)}
    m = torch.full_like(s[..., :1], float("-inf"))
    l = acc = 0.0
    for j in range(0, nk, tile_keys):
        tile = s[..., j:j + tile_keys]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        p = torch.exp(tile - m_new)
        l = l * torch.exp(m - m_new) + p.sum(-1, keepdim=True)
        acc = acc + torch.matmul(p.to(v.dtype).float(), v[:, :, j:j + tile_keys].float())  # no acc·alpha
        m = m_new
    outs["no_acc_rescale"] = acc / l
    del acc, l, m, tile, p
    p = torch.exp(s - s.amax(-1, keepdim=True))
    del s
    outs["p_unrounded"] = torch.matmul(p, v.float()) / p.sum(-1, keepdim=True)
    del p
    if bias is not None:
        outs["bias_ignored"] = fa.flash_attention_reference(q, k, v)
    return {name: (out.to(q.dtype).float() - ref.float()).abs().max().item() for name, out in outs.items()}


def bias_operands(variant, b, h, n, d, gen, device="cuda"):
    """(q, k, v, bias) as MasaCtrl's gated sites hand them to the kernel,
    bf16, from head-split views of (B, N, H·D) projections: ``union``, the
    union plan's gathers and segment bias (``plan_operands``) at an ungated
    step, where the targets' first segment (the source's keys) is masked;
    at a gated step only the sources' first segment is, and it repeats
    their own keys, so there the bias leaves the result as it is. ``mask``,
    the queries against the gathered source K/V with the fg bias of a
    random (asymmetric) mask (``key_bias``). Both mask whole key tiles
    before the open ones."""
    from image_editing_framework_torch.ops import controls as ctl
    from image_editing_framework_torch.ops.attention import AttnSite, plan_operands, split_heads

    q, k, v = (split_heads(torch.randn(b, n, h * d, device=device, dtype=torch.bfloat16, generator=gen), h)
               for _ in range(3))
    if variant == "union":
        step = ctl.MasaCtrlStep(step_gate=torch.tensor(False, device=device), layers=(0,), union=True)
        return plan_operands(q, k, v, step.self_plan(AttnSite(0, "up", n, False), b))
    half_src = (torch.arange(b, device=device) // 2) * 2
    fg = torch.rand(n, device=device, generator=gen) > 0.5
    return q, k[half_src], v[half_src], ctl.key_bias(fg, b)


def hold_forward(out, ref, out_lse=None, ref_lse=None):
    """The flash forward's output (and lse) against its plain version's:
    O within ``parity_atol``, lse within 1e-3 on the rows where the plain
    lse is finite and infinite on the others. Returns (O error, its limit,
    lse error)."""
    from image_editing_framework_torch.ops import flash_attention as fa

    if out.is_cuda:
        torch.cuda.synchronize()
    lse_err = None
    if ref_lse is not None:
        finite = torch.isfinite(ref_lse)
        lse_err = (out_lse[finite] - ref_lse[finite]).abs().max().item() if finite.any() else 0.0
        if not torch.equal(torch.isfinite(out_lse), finite) or lse_err > 1e-3:
            raise AssertionError(f"lse mismatch {lse_err}")
    err, tol = (out.float() - ref.float()).abs().max().item(), fa.parity_atol(ref)
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"flash kernel disagrees with its plain version: {err} > {tol}")
    return err, tol, lse_err


def phase_kernels(gen):
    """Kernel vs plain version; times at the paths' shapes. Returns the
    worst errors, per model the sums over the sites of one CFG-batch UNet
    forward (16 for SD1.5, 70 for SDXL), the same for MasaCtrl's biased
    calls per variant (BIAS_SHAPES) with the whole forward's flash ms under
    each, and the wrapper's host µs per call at a batch-1 SDXL site."""
    from image_editing_framework_torch.ops import flash_attention as fa
    from image_editing_framework_torch.ops.attention import split_heads
    from image_editing_framework_torch.tools.bench_flash_fwd import enqueue_us

    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    sums = {model: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "flops": 0.0, "bytes": 0.0}
            for model in PATH_SHAPES}
    bias_sums = {model: {variant: dict.fromkeys(sums[model], 0.0) for variant in ("union", "mask")}
                 for model in BIAS_SHAPES}
    site_ms = {}  # (model, tokens) -> ms of one unbiased bf16 call at CFG batch 4

    def check(dtype, b, h, nq, nk, d, bias=None, lse=False, timed=False, sites=0, model=None):
        """Path shapes (``model`` given) come as the UNet gives them:
        head-split views of (B, N, H·D) projections; the edge cases as
        contiguous tensors."""
        def make(n):
            if model:
                return split_heads(torch.randn(b, n, h * d, device="cuda", dtype=dtype, generator=gen), h)
            return torch.randn(b, h, n, d, device="cuda", dtype=dtype, generator=gen)

        q, k, v = make(nq), make(nk), make(nk)
        out = fa.flash_attention(q, k, v, bias, return_lse=lse)
        ref = fa.flash_attention_reference(q, k, v, bias, return_lse=lse)
        if lse:
            (out, out_lse), (ref, ref_lse) = out, ref
        err, tol, _ = hold_forward(out, ref, *((out_lse, ref_lse) if lse else ()))
        worst[dtype] = max(worst[dtype], err)
        row = dict(dtype=str(dtype).split(".")[1], shape=[b, h, nq, nk, d], strides=list(q.stride()),
                   bias=bias is not None, lse=lse, max_abs_err=err, tol=tol)
        if model:
            row["model"] = model
        if timed and dtype == torch.bfloat16:
            row["faults"] = faults = fault_readings(q, k, v, ref)
            must_fail = ["skipped_key_tile"] + (["no_acc_rescale"] if nk > fwd_key_tile(d) else [])
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
                site_ms[model, nq] = row["ms"]
                for key in sums[model]:
                    sums[model][key] += sites * row[key]
        emit("kernel", name="flash_fwd", **row)

    def check_biased(model, variant, n, nk, d, h, calls):
        """A MasaCtrl shape: the biased kernel against its plain version,
        the planted faults (bias ignored among them), and the kernel's,
        plain version's and SDPA's (same float mask) times. The bound counts
        the keys the bias leaves open, the work this call's data needs."""
        q, k, v, bias = bias_operands(variant, 4, h, n, d, gen)
        assert k.shape[2] == nk and bias.is_contiguous() and bias.dtype == torch.float32
        out = fa.flash_attention(q, k, v, bias)
        ref = fa.flash_attention_reference(q, k, v, bias)
        torch.cuda.synchronize()
        err, tol = (out.float() - ref.float()).abs().max().item(), fa.parity_atol(ref)
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"biased flash kernel ({variant}) disagrees with its plain version: {err} > {tol}")
        worst[torch.bfloat16] = max(worst[torch.bfloat16], err)
        faults = fault_readings(q, k, v, ref, bias)
        must_fail = ["skipped_key_tile", "no_acc_rescale"] + (["bias_ignored"] if variant == "union" else [])
        passed = [name for name in must_fail if not faults[name] > tol]
        if passed:
            raise AssertionError(f"the bf16 limit {tol} does not reject the planted faults {passed}: {faults}")
        open_keys = (bias > fa.NEG_INF / 2).sum().item()  # summed over the batch
        flops = 4.0 * h * n * d * open_keys
        nbytes = 2 * (2 * 4 * h * n * d + 2 * h * d * open_keys) + 4 * bias.numel()
        bound, by = bound_ms(flops, nbytes, torch.bfloat16)
        mask = bias.to(q.dtype)[:, None, None, :]
        row = dict(model=model, variant=variant, dtype="bfloat16", shape=[4, h, n, nk, d], strides=list(q.stride()),
                   bias=True, open_key_share=open_keys / bias.numel(), max_abs_err=err, tol=tol, faults=faults,
                   ms=cuda_ms(lambda: fa.flash_attention(q, k, v, bias)),
                   plain_ms=cuda_ms(lambda: fa.flash_attention_reference(q, k, v, bias)),
                   library_ms=cuda_ms(lambda: sdpa(q, k, v, attn_mask=mask)),
                   bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes, calls_per_forward=calls)
        for key in bias_sums[model][variant]:
            bias_sums[model][variant][key] += calls * row[key]
        emit("kernel", name="flash_fwd", **row)

    for dtype in (torch.bfloat16, torch.float32):
        for b in (1, 4):
            for model, shapes in PATH_SHAPES.items():
                for n, d, h, sites in shapes:
                    # SDXL's f32 shapes are checked and not timed: f32 is off its path
                    check(dtype, b, h, n, n, d, timed=model == "sd" or dtype == torch.bfloat16, sites=sites,
                          model=model)
        for nk in (77, 1000):  # keys not a multiple of the kernel's tile
            check(dtype, 2, HEADS, 256, nk, 40, lse=True)
        check(dtype, 2, HEADS, 200, 100, 64, lse=True)  # Nq off the 128-query block, Nk below one key tile
        bias = torch.zeros(2, 1000, device="cuda")
        bias[:, 200:600] = fa.NEG_INF  # a masked segment
        bias[1] = fa.NEG_INF  # a fully NEG_INF-masked row: equal weights
        check(dtype, 2, HEADS, 300, 1000, 80, bias=bias, lse=True)
        bias = torch.zeros(2, 512, device="cuda")
        bias[0] = float("-inf")  # every logit -inf: the row returns 0
        check(dtype, 2, HEADS, 64, 512, 160, bias=bias, lse=True)
    for model, shapes in BIAS_SHAPES.items():
        for shape in shapes:
            check_biased(model, *shape)
    for part in list(sums.values()) + [p for per in bias_sums.values() for p in per.values()]:
        part["bound_ms"], part["bound_by"] = bound_ms(part["flops"], part["bytes"], torch.bfloat16)
    for model, shapes in BIAS_SHAPES.items():
        # the whole forward's flash ms: union replaces the gated sites' calls,
        # mask adds two to each
        gated = sum(site_ms[model, n] * calls for variant, n, _, _, _, calls in shapes if variant == "union")
        bias_sums[model]["union"]["forward_ms"] = sums[model]["ms"] - gated + bias_sums[model]["union"]["ms"]
        bias_sums[model]["mask"]["forward_ms"] = sums[model]["ms"] + bias_sums[model]["mask"]["ms"]
    # host time per call (checks, tensor maps, launch) at a batch-1 SDXL site
    q, k, v = (split_heads(torch.randn(1, 1024, 20 * 64, device="cuda", dtype=torch.bfloat16, generator=gen), 20)
               for _ in range(3))
    enqueue = enqueue_us(lambda: fa.flash_attention(q, k, v))
    emit("enqueue", kernel="flash_fwd", shape=[1, 20, 1024, 1024, 64], us_per_call=enqueue)
    return worst, sums, bias_sums, enqueue


def bwd_fault_readings(q, k, v, do, o, lse, ref):
    """max|grad - ref| per output of three broken backward kernels, emulated
    in plain PyTorch on the same bf16 inputs: di left out (as if O were 0),
    dQ's last key tile skipped (its keys' P set to 0; the tile of
    ``bwd_dq_key_tile``), dK/dV's last query tile skipped (its queries' P
    set to 0; the tile of ``bwd_dkv_query_tile``). Each fault names the
    outputs it reaches."""
    from image_editing_framework_torch.ops import flash_attention as fa

    nq, nk, d = q.shape[2], k.shape[2], q.shape[-1]
    key_tile, query_tile = bwd_dq_key_tile(d), bwd_dkv_query_tile(d)
    key_bias = torch.zeros(q.shape[0], nk, device=q.device)
    key_bias[:, (nk - 1) // key_tile * key_tile:] = float("-inf")
    lse_skip = lse.clone()
    lse_skip[:, :, (nq - 1) // query_tile * query_tile:] = float("-inf")
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
    and pix2pix-zero's shapes. Returns the worst errors and, per model and
    kernel, the sums over the sites of one NTI inner iteration (one UNet
    backward at batch 1: 15 sites for SD1.5, 69 for SDXL) and of one p2z
    guided step (at CFG batch 2: all 16 / 70 sites)."""
    from image_editing_framework_torch.ops import flash_attention as fa
    from image_editing_framework_torch.ops.attention import split_heads
    from image_editing_framework_torch.tools.bench_flash_fwd import busy_ms, graph_ms

    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst = {dtype: {"dq": 0.0, "dkv": 0.0} for dtype in (torch.bfloat16, torch.float32)}
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "flops", "bytes")
    sums, p2z_sums = ({model: {kernel: dict.fromkeys(keys, 0.0) for kernel in ("dq", "dkv", "all")}
                       for model in GRAD_SHAPES} for _ in range(2))

    def check(dtype, b, h, nq, nk, d, bias=None, timed=False, sites=0, zero_batch=None, model=None, into=sums):
        """Path shapes (``model`` given) come as the UNet and autograd give
        them: head-split views of (B, N, H·D) tensors, dO included; the edge
        cases as contiguous tensors."""
        def make(n):
            if model:
                return split_heads(torch.randn(b, n, h * d, device="cuda", dtype=dtype, generator=gen), h)
            return torch.randn(b, h, n, d, device="cuda", dtype=dtype, generator=gen)

        q, k, v, do = make(nq), make(nk), make(nk), make(nq)
        # the forward's lse instantiation at the gradient's shapes, held on
        # its own: the plain backward reads the plain forward's o and lse,
        # so a wrong kernel o or lse cannot cancel between the two sides
        o, lse = fa.flash_attention(q, k, v, bias, return_lse=True)
        ref_o, ref_lse = fa.flash_attention_reference(q, k, v, bias, return_lse=True)
        fwd_err, fwd_tol, lse_err = hold_forward(o, ref_o, lse, ref_lse)
        copies = fa.flash_attention_bwd.copies
        got = fa.flash_attention_bwd(q, k, v, bias, o, do, lse)
        ref = fa.flash_attention_bwd_reference(q, k, v, bias, ref_o, do, ref_lse)
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
                   bias=bias is not None, max_abs_err=errs, tol=tols,
                   forward=dict(max_abs_err=fwd_err, tol=fwd_tol, lse_max_abs_err=lse_err))
        if model:
            row["model"] = model
        if timed and dtype == torch.bfloat16:
            row["faults"] = faults = bwd_fault_readings(q, k, v, do, ref_o, ref_lse, ref)
            passed = [name for name, reads in faults.items() if not any(e > tols[out] for out, e in reads.items())]
            if passed:
                raise AssertionError(f"the bf16 limits {tols} do not reject the planted faults {passed}: {faults}")
        if timed:
            scale = 1.0 / math.sqrt(d)
            di = fa._bwd_di(o, do)
            qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
            out = sdpa(qg, kg, vg)
            library = lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)  # noqa: E731
            library_ms, library_device_ms = cuda_ms(library), busy_ms(library)
            plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, None, o, do, lse))
            calls = {
                "dq": lambda: fa.flash_bwd_dq(q, k, v, None, do, lse, di, scale),
                "dkv": lambda: fa.flash_bwd_dkv(q, k, v, None, do, lse, di, scale),
                "all": lambda: fa.flash_attention_bwd(q, k, v, None, o, do, lse),
            }
            for kernel, fn in calls.items():
                ms, device_ms = cuda_ms(fn), graph_ms(fn)
                flops, nbytes = bwd_work(b, h, nq, nk, d, dtype, kernel)
                bound, by = bound_ms(flops, nbytes, dtype)
                row[kernel] = dict(ms=ms, device_ms=device_ms, bound_ms=bound, bound_by=by, flops=flops,
                                   bytes=nbytes)
                if dtype == torch.bfloat16:
                    for key, val in (("ms", ms), ("device_ms", device_ms), ("plain_ms", plain_ms),
                                     ("library_ms", library_ms), ("library_device_ms", library_device_ms),
                                     ("flops", flops), ("bytes", nbytes)):
                        into[model][kernel][key] += sites * val
            row.update(plain_ms=plain_ms, library_ms=library_ms, library_device_ms=library_device_ms)
        emit("kernel", name="flash_bwd", **row)

    for dtype in (torch.bfloat16, torch.float32):
        for model, shapes in GRAD_SHAPES.items():
            for n, d, h, sites in shapes:
                check(dtype, 1, h, n, n, d, timed=model == "sd" or dtype == torch.bfloat16, sites=sites, model=model)
        for model, shapes in PATH_SHAPES.items():  # f32 is off p2z's path: checked, not timed
            for n, d, h, sites in shapes:
                check(dtype, P2Z_BATCH, h, n, n, d, timed=dtype == torch.bfloat16, sites=sites, model=model,
                      into=p2z_sums)
        for nk in (77, 1000):  # Nq and Nk off the 64-row blocks and both kernels' streamed tiles
            check(dtype, 2, HEADS, 130, nk, 40)
        bias = torch.zeros(2, 1000, device="cuda")
        bias[:, 200:600] = fa.NEG_INF  # a masked segment
        bias[1] = fa.NEG_INF  # a fully NEG_INF-masked row
        check(dtype, 2, HEADS, 300, 1000, 80, bias=bias)
        bias = torch.zeros(2, 512, device="cuda")
        bias[0] = float("-inf")  # every logit -inf: zero gradients
        check(dtype, 2, HEADS, 64, 512, 160, bias=bias, zero_batch=0)
    for part in list(sums.values()) + list(p2z_sums.values()):
        for kernel in part:
            part[kernel]["bound_ms"], part[kernel]["bound_by"] = bound_ms(
                part[kernel]["flops"], part[kernel]["bytes"], torch.bfloat16)
    return worst, sums, p2z_sums


def phase_probe():
    """The tile-shape probe kernel against its plain version for every
    layout and head dim (3 iterations, one block per SM, every block's value
    read), then the timed table through the tool's entry point, with the
    launch count read around it."""
    from image_editing_framework_torch.tools import bench_attn_layouts as bench

    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.RandomState(0)
    worst_abs = worst_ratio = plain_ms = 0.0
    for d in bench.HEAD_DIMS:
        for name, (a, b, contract) in bench.operands(d, rng, "cuda").items():
            out = bench.probe(a, b, contract, 3, blocks)
            ref = bench.probe_reference(a, b, contract, 3)
            torch.cuda.synchronize()
            (ca,), (cb,) = contract
            s = torch.matmul((a if ca == 1 else a.T).double(), (b if cb == 1 else b.T).double().T)
            exact, abs_sum = 3 * s.sum().item(), 3 * s.abs().sum().item()
            limit = PROBE_RTOL * abs_sum
            # an 8 x 8 piece of the product left out of every iteration: the median piece's sum
            tile = 3 * s.reshape(s.shape[0] // 8, 8, s.shape[1] // 8, 8).sum(dim=(1, 3)).abs().median().item()
            err = (out - ref).abs().max().item()
            if not (out == out[0]).all():
                raise AssertionError(f"probe {name} d={d}: the blocks disagree with each other")
            if not err <= limit:
                raise AssertionError(f"probe {name} d={d} disagrees with its plain version: {err} > {limit}")
            if not tile > limit:
                raise AssertionError(f"probe {name} d={d}: the limit {limit} would pass a dropped piece ({tile})")
            worst_abs, worst_ratio = max(worst_abs, err), max(worst_ratio, err / limit)
            one_ms = cuda_ms(lambda: bench.probe_reference(a, b, contract, 1))
            plain_ms += one_ms
            emit("kernel", name="mma_probe", layout=name, d=d, shape=[list(a.shape), list(b.shape)], blocks=blocks,
                 max_abs_err=err, tol=limit, kernel_vs_f64=abs(out[0].item() - exact),
                 plain_vs_f64=abs(ref[0].item() - exact), dropped_piece_over_tol=tile / limit, plain_ms_per_iter=one_ms,
                 plan=bench.plan_for(a, b, contract))
    bench.probe.launches = 0
    table = bench.main()
    launches = bench.probe.launches
    rows = [r for per_d in table.values() for r in per_d.values()]
    if launches == 0 or len(rows) != 12:
        raise AssertionError(f"the probe's entry point launched its kernel {launches} times over {len(rows)} layouts")
    bad = {k: r["linearity"] for per_d in table.values() for k, r in per_d.items() if not 0.8 < r["linearity"] < 1.25}
    if bad:
        raise AssertionError(f"the probe's time is not linear in iters: {bad}")
    emit("probe", blocks=blocks, launches=launches, table=table, card=card_line(),
         unit="us_per_iter: one 512x512 product per SM on all SMs at once; tflops: the whole card")
    return {"launches": launches, "max_abs_err": worst_abs, "max_err_over_limit": worst_ratio,
            "ms": sum(r["us_per_iter"] for r in rows) / 1e3, "plain_ms": plain_ms,
            "bound_ms": sum(r["bound_us_per_iter"] for r in rows) / 1e3}


def tiny_edits(pipe, model_type):
    """The tiny pipeline's MasaCtrl edits (mutual, union, a fixed asymmetric
    mask, the auto mask, mutual with ``direction_scale``) and its PnP edit
    from one seeded start latent: {name: final latents on the CPU}, and the
    auto masks' smallest distance from their threshold."""
    from image_editing_framework_torch.core.config import MasaCtrlConfig, SamplerConfig
    from image_editing_framework_torch.methods.masactrl import masactrl_edit
    from image_editing_framework_torch.methods.pnp import pnp_edit
    from image_editing_framework_torch.ops import controls as ctl

    prompts = ["a cat sitting on the grass", "a dog sitting on the grass"]
    sampler = SamplerConfig(height=32, width=32)
    rng = np.random.RandomState(3)
    latent = torch.from_numpy(rng.randn(1, 16, 16, 4).astype(np.float32)).to(pipe.device)
    mask_s, mask_t = ((rng.rand(32, 32) > 0.5).astype(np.float32) for _ in range(2))
    cfg = MasaCtrlConfig(start_step=1, start_layer=2 if model_type == "sd" else 4)
    finals, gaps = {}, []
    decode, masks_from = pipe.latent2image, ctl.MasaCtrlAutoStep.masks_from

    def recording_masks(step, running):
        out = masks_from(step, running)
        gaps.append(min((m - step.thres).abs().min().item() for m in out))
        return out

    def recording_decode(lat, **kw):
        finals[name] = lat.cpu()
        return decode(lat, **kw)

    pipe.latent2image = recording_decode
    ctl.MasaCtrlAutoStep.masks_from = recording_masks
    try:
        for name, kw in (("mutual", {}), ("union", dict(cfg=dataclasses.replace(cfg, mode="union"))),
                         ("mask", dict(mask_s=mask_s, mask_t=mask_t)),
                         ("auto", dict(auto_mask=True, cur_token_idx=(1, 5))), ("direction", dict(direction_scale=2.0))):
            masactrl_edit(pipe, prompts, latent, kw.pop("cfg", cfg), sampler, **kw)
        name = "pnp"
        pnp_edit(pipe, prompts, latent, sampler=sampler)
    finally:
        del pipe.latent2image
        ctl.MasaCtrlAutoStep.masks_from = masks_from
    return finals, min(gaps, default=None)


def tiny_p2z(pipe, model_type):
    """The tiny pipeline's pix2pix-zero edit from one seeded start latent:
    SD with the references recorded in pass 1, XL with them recomputed and
    the checkpointed UNet forced on (the XL defaults at 1024²), both with
    per-step NTI embeddings. Returns the final latents (reconstruction,
    edit) on the CPU."""
    from image_editing_framework_torch.core.config import P2ZConfig, SamplerConfig
    from image_editing_framework_torch.methods.p2z import p2z_edit

    prompts = ["a cat sitting on the grass", "a dog sitting on the grass"]
    rng = np.random.RandomState(5)
    latent = torch.from_numpy(rng.randn(1, 16, 16, 4).astype(np.float32)).to(pipe.device)
    width = pipe.unet.config.cross_attention_dim
    uncond = torch.from_numpy((rng.randn(4, 77, width) * 0.5).astype(np.float32)).to(pipe.device)
    cfg = P2ZConfig(recompute_refs=True, remat_grad=True) if model_type == "xl" else P2ZConfig()
    finals, decode = [], pipe.latent2image

    def recording_decode(lat, **kw):
        finals.append(lat.cpu())
        return decode(lat, **kw)

    pipe.latent2image = recording_decode
    try:
        p2z_edit(pipe, prompts, latent, cfg, SamplerConfig(height=32, width=32), uncond_seq=uncond)
    finally:
        del pipe.latent2image
    return finals


def p2z_sync_free(pipe, model_type):
    """pix2pix-zero's pass 2 (4 guided steps) on the tiny pipeline on the
    card under ``torch.cuda.set_sync_debug_mode("error")``: the gradient,
    the SGD step, the noise forward and the DDIM step never make the host
    wait for the card (a synchronising call raises). SD with recorded
    references, XL with recomputed ones and the checkpointed UNet."""
    from image_editing_framework_torch.methods import common, p2z
    from image_editing_framework_torch.methods.base import denoise
    from image_editing_framework_torch.ops.controls import P2ZControl

    prompts = ["a cat sitting on the grass", "a dog sitting on the grass"]
    xl = model_type == "xl"
    latent = torch.randn(1, 16, 16, 4, device="cuda")
    uncond = torch.randn(4, 77, pipe.unet.config.cross_attention_dim, device="cuda")
    ctx_src, added_src = common.prepare_conditioning(pipe, prompts[:1], 32, 32)
    ctx, added = common.prepare_conditioning(pipe, prompts[1:], 32, 32)
    _, refs, traj = denoise(pipe, latent, ctx_src, P2ZControl(), uncond_seq=uncond, added_cond=added_src,
                            collect_records=True, collect_trajectory=True)
    unet = common.grad_unet(pipe, 16, force=xl)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, losses = p2z._guided_scan(unet, pipe.scheduler, latent, ctx, None if xl else refs, 7.5, 0.1, added, uncond,
                                     traj if xl else None, ctx_src if xl else None, added_src if xl else None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    if not (torch.isfinite(losses).all() and (losses > 0).all()):
        raise AssertionError(f"tiny {model_type} p2z losses {losses}")
    return True


def controls_sync_free():
    """Every MasaCtrl variant's and PnP's step at a gated site on the card,
    at a gated and an ungated step, under ``torch.cuda.set_sync_debug_mode
    ("error")``: no gate, index, mask or bias makes the host wait for the
    card (a synchronising call raises)."""
    from image_editing_framework_torch.core.config import MasaCtrlConfig, PnPConfig
    from image_editing_framework_torch.ops import controls as ctl
    from image_editing_framework_torch.ops.attention import AttnSite, self_attention

    n, h, d = 256, 8, 40
    q, k, v = (torch.randn(4, h, n, d, device="cuda", dtype=torch.bfloat16) for _ in range(3))
    site, cross = AttnSite(12, "up", n, False), AttnSite(4, "down", 256, True)
    mask = (torch.rand(64, 64, device="cuda") > 0.5).float()
    probs = torch.rand(4, h, 256, 77, device="cuda").softmax(-1)
    feat = torch.randn(4, 64, 32, 32, device="cuda", dtype=torch.bfloat16)
    controls = {
        "mutual": ctl.build_masactrl_control(STEPS, 16, MasaCtrlConfig(), device="cuda"),
        "union": ctl.build_masactrl_control(STEPS, 16, MasaCtrlConfig(mode="union"), device="cuda"),
        "mask": ctl.build_masactrl_control(STEPS, 16, MasaCtrlConfig(), mask_s=mask, mask_t=mask.flip(0),
                                           device="cuda"),
        "auto": ctl.build_masactrl_control(STEPS, 16, MasaCtrlConfig(), auto_mask=True, device="cuda"),
    }
    pnp = ctl.build_pnp_control(STEPS, PnPConfig(), (12,), ("up1_res1",), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in (0, 10):
            for name, control in controls.items():
                step = control.at_step(i)
                running = {cross.key: step.record(cross, probs)} if name == "auto" else None
                if step.self_override(site, q, k, v, running) is None:
                    self_attention(q, k, v, step.self_plan(site, 4))
            step = pnp.at_step(i)
            self_attention(q, k, v, step.self_plan(site, 4))
            step.resnet_hook("up1_res1", feat)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return True


def phase_tiny():
    """Tiny pipelines on the card (f32 kernels, head dims 16 and 32) against
    the same weights on the CPU (plain versions). SD: invert + P2P edit with
    LocalBlend, and null-text inversion (4 steps, 2 inner iterations) + the
    edit with its embeddings. SDXL: invert + P2P edit, and XL null-text
    inversion with and without the checkpointed UNet. Both: MasaCtrl
    (mutual, union, mask, auto mask, direction) and PnP (``tiny_edits``);
    their steps never synchronise (``controls_sync_free``)."""
    from image_editing_framework_torch.core.config import NTIConfig, P2PConfig, SamplerConfig
    from image_editing_framework_torch.inversion.ddim import ddim_invert
    from image_editing_framework_torch.inversion.nti import null_text_inversion
    from image_editing_framework_torch.methods.base import denoise
    from image_editing_framework_torch.methods.p2p import p2p_setup
    from image_editing_framework_torch.models.weights import load_weights
    from image_editing_framework_torch.pipelines import tiny_pipeline

    torch.backends.cudnn.allow_tf32 = False
    prompts = ["a cat sitting on the grass", "a dog sitting on the grass"]
    sampler = SamplerConfig(height=32, width=32)
    image = (np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)
    for model_type, cfg in (("sd", P2PConfig(blend_words=(("cat",), ("dog",)))), ("xl", P2PConfig())):
        cpu = tiny_pipeline(num_steps=4, model_type=model_type, device="cpu")
        gpu = tiny_pipeline(num_steps=4, model_type=model_type, device="cuda")
        for name in ("unet", "vae", "text_encoder") + (("text_encoder_2",) if model_type == "xl" else ()):
            state = {k: v.numpy() for k, v in getattr(cpu, name).state_dict().items()}
            load_weights(getattr(gpu, name), state)
        results = []
        for pipe in (cpu, gpu):
            last, traj, context, added1 = ddim_invert(pipe, pipe.image2latent(image), prompts[0])
            lat0, ctx, ctrl, blend, added = p2p_setup(pipe, prompts, last, cfg, sampler)
            edit = denoise(pipe, lat0, ctx, ctrl, blend=blend, added_cond=added)
            if model_type == "xl":
                # XL's NTI starts on both devices from the CPU's inversion, so
                # that the embeddings compare the NTI programs alone
                if pipe is cpu:
                    nti_in = (traj, context, added1)
                traj, context = (x.to(pipe.device) for x in nti_in[:2])
                added1 = {k: v.to(pipe.device) for k, v in nti_in[2].items()}
            seqs = [null_text_inversion(pipe, traj, context, NTIConfig(num_inner_steps=2, remat=remat),
                                        added_cond=added1)
                    for remat in ((False, True) if model_type == "xl" else (False,))]
            final = denoise(pipe, lat0, ctx, ctrl, blend=blend, uncond_seq=seqs[0], added_cond=added)
            results.append([x.cpu() for x in (edit, final, *seqs)])
        errs = [(a - b).abs().max().item() for a, b in zip(*results)]
        # embeddings: a tenth of one Adam step at lr 1e-2, as the CPU parity tests
        if not all(e < 1e-3 for e in errs):
            raise AssertionError(f"tiny {model_type} pipeline on the card disagrees with the CPU: edit, NTI edit, "
                                 f"NTI embeddings (plain, checkpointed) {errs}")
        # MasaCtrl and PnP; the auto masks threshold the maps, which must
        # keep clear of it (the tiny SD net has 256-token sites; XL none)
        (cpu_edits, gap), (gpu_edits, _) = (tiny_edits(pipe, model_type) for pipe in (cpu, gpu))
        # pix2pix-zero: its reconstruction (pass 1) and its edit (pass 2)
        (cpu_edits["p2z_rec"], cpu_edits["p2z"]), (gpu_edits["p2z_rec"], gpu_edits["p2z"]) = (
            tiny_p2z(pipe, model_type) for pipe in (cpu, gpu))
        p2z_sync = p2z_sync_free(gpu, model_type)
        edit_errs = {k: (cpu_edits[k] - gpu_edits[k]).abs().max().item() for k in cpu_edits}
        target_errs = {k: (cpu_edits[k][-1] - gpu_edits[k][-1]).abs().max().item() for k in cpu_edits}
        margin_ok = gap > 1e-4 if model_type == "sd" else gap is None
        if len(edit_errs) != 8 or not all(e < 1e-3 for e in edit_errs.values()) or not margin_ok:
            raise AssertionError(f"tiny {model_type} MasaCtrl/PnP/p2z on the card disagree with the CPU: "
                                 f"{edit_errs}, auto-mask margin {gap}")
        fields = dict(max_abs_err=errs[0], nti_edit_max_abs_err=errs[1], nti_embedding_max_abs_err=errs[2], tol=1e-3,
                      masactrl_pnp_max_abs_err=edit_errs, masactrl_pnp_target_max_abs_err=target_errs,
                      auto_mask_margin=gap, p2z_max_abs_err=edit_errs["p2z"], p2z_sync_free=p2z_sync)
        if model_type == "xl":
            fields.update(nti_embedding_remat_max_abs_err=errs[3],
                          remat_bitwise_on_card=bool(torch.equal(results[1][2], results[1][3])))
        emit("tiny" if model_type == "sd" else "xl_tiny", **fields)
    torch.backends.cudnn.allow_tf32 = True
    emit("controls_sync_free", masactrl_and_pnp_steps=controls_sync_free())


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


# per model: (sd_version, name, image side, context width)
MODELS = {"sd": ("1.5", "SD1.5", 512, 768), "xl": ("xl", "SDXL base", 1024, 2048)}
PROMPTS = ["a photo of a cat sitting on the grass", "a photo of a dog sitting on the grass"]


def phase_main_path(model):
    """Real-image P2P edit through the user entry points, bf16: SD1.5 at
    512² or SDXL at 1024² (whose decode is also made in tiles and compared
    with the full frame)."""
    from image_editing_framework_torch.core.config import P2PConfig, SamplerConfig
    from image_editing_framework_torch.inversion.ddim import ddim_invert
    from image_editing_framework_torch.methods import common
    from image_editing_framework_torch.methods.p2p import p2p_edit
    from image_editing_framework_torch.pipelines import random_pipeline

    version, name, side, _ = MODELS[model]
    t0 = time.perf_counter()
    pipe = random_pipeline(version, num_steps=STEPS, dtype=torch.bfloat16, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    image = (np.random.RandomState(0).rand(side, side, 3) * 255).astype(np.uint8)
    cfg = P2PConfig(edit_type="replace", blend_words=(("cat",), ("dog",)))
    sampler = SamplerConfig(num_inference_steps=STEPS, height=side, width=side)

    # one UNet forward at the edit's CFG batch (for the kernel's share of
    # it) and at the inversion's batch 1
    ctx, added = common.prepare_conditioning(pipe, PROMPTS, side, side)
    added1 = None if added is None else {k: v[2:3] for k, v in added.items()}
    lat4 = torch.randn(4, side // 8, side // 8, 4, device="cuda", dtype=torch.bfloat16)
    unet_ms = cuda_ms(lambda: pipe.unet_apply(lat4, 501, ctx, None, added), min_ms=500.0)
    unet_b1_ms = cuda_ms(lambda: pipe.unet_apply(lat4[:1], 501, ctx[2:3], None, added1), min_ms=500.0)

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    latent, encode_s = timed(lambda: pipe.image2latent(image))
    (last, traj, _, _), invert_s = timed(lambda: ddim_invert(pipe, latent, PROMPTS[0]))
    images, edit_s = timed(lambda: p2p_edit(pipe, PROMPTS, last, cfg, sampler))
    counts = launch_counts()
    full, decode_s = timed(lambda: pipe.latent2image(last.expand(2, -1, -1, -1)))
    extra = {}
    if model == "xl":
        tiled, extra["decode_tiled_s"] = timed(lambda: pipe.latent2image(last.expand(2, -1, -1, -1), tile_latent=64))
        diff = np.abs(tiled.astype(np.int32) - full.astype(np.int32))
        extra.update(decode_tiled_median_abs_diff=float(np.median(diff)), decode_tiled_max_abs_diff=int(diff.max()))
        # With random weights the decoder's mid-block attention and GroupNorm
        # statistics make a tile's pixels depend on the whole tile, so the
        # tiled image is reported beside the full frame and not held to it
        # (the CPU tests hold decode_tiled to the JAX function). A tile that
        # covers the latent must give the full frame's bits.
        one_tile = pipe.latent2image(last.expand(2, -1, -1, -1), tile_latent=side // 8)
        if tiled.shape != full.shape or tiled.std() == 0 or not np.array_equal(one_tile, full):
            raise AssertionError(f"tiled decode {tiled.shape}: constant, misshapen, or one tile differs from the "
                                 f"full frame: {extra}")

    sites = SITES[model]
    expected = (sites * (STEPS + STEPS), 0, 0)
    if counts != expected:
        raise AssertionError(f"(forward, dQ, dK/dV) kernels launched {counts} times on the {model} main path, "
                             f"expected {expected}")
    if images.shape != (2, side, side, 3) or images.dtype != np.uint8:
        raise AssertionError(f"edit output {images.shape} {images.dtype}")
    if not (torch.isfinite(traj.float()).all() and torch.isfinite(last.float()).all()):
        raise AssertionError("inversion produced non-finite latents")
    if images.std() == 0:
        raise AssertionError("edit output is constant")
    emit("main_path" if model == "sd" else "xl_main_path", model=f"{name} (random weights, seed 0)", resolution=side,
         dtype="bfloat16", steps=STEPS, unet_params=sum(p.numel() for p in pipe.unet.parameters()),
         setup_s=setup_s, encode_s=encode_s, invert_s=invert_s, edit_and_decode_s=edit_s, decode_s=decode_s,
         image_s=encode_s + invert_s + edit_s, unet_forward_cfg4_ms=unet_ms, unet_forward_b1_ms=unet_b1_ms,
         flash_launches=counts[0], flash_launches_per_forward=sites, bwd_launches=counts[1:],
         peak_gib=torch.cuda.max_memory_allocated() / 2**30, image_mean=float(images.mean()), card=card_line(),
         **extra)
    return counts[0], unet_ms, (pipe, lat4, ctx, added)


# ---------------------------------------------------------------- checkpoints
# A checkpoint in the reference's two layouts, written by the phase itself
# (no weights or vocab files exist to read): the HF snapshot directory and
# the LDM single file, from the same random weights, fp16 as published.

SAFETENSORS_DTYPES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
                      torch.int64: "I64", torch.int32: "I32", torch.int16: "I16", torch.int8: "I8",
                      torch.uint8: "U8", torch.bool: "BOOL"}
CKPT_PROMPTS = ["a cat sitting on the grass", "a dog sitting on the grass"]
# the sweep phase's mini PIE: (image path under annotation_images, source
# prompt, target prompt, with PIE's [edit] brackets). Three items in the
# default categories (0 and 1), one pair of equal word counts (P2P replace)
# and two of unequal ones (refine); the category-5 item the default
# categories skip.
SWEEP_PIE = [("0_random_140/000000000000.jpg", "a [cat] sitting on the grass", "a [dog] sitting on the grass"),
             ("0_random_140/000000000001.jpg", "a cat sitting on the grass", "a [white] cat sitting on the grass"),
             ("1_change_object_80/100000000000.jpg", "a [dog] sitting on the grass",
              "a [small] [cat] sitting on the grass"),
             ("5_change_attribute_pose_40/500000000000.jpg", "a cat [sitting] on the grass",
              "a cat [standing] on the grass")]
# every word of both, whole tokens of the checkpoints' synthetic vocab
CKPT_WORDS = " ".join(CKPT_PROMPTS + [p.replace("[", "").replace("]", "") for *_, s, t in SWEEP_PIE
                                      for p in (s, t)]).split()
CLIP_VOCAB_SIZE = 49408  # <|startoftext|> 49406, <|endoftext|> 49407, as in CLIP's vocab.json


def write_safetensors(tensors, path, dtype=None):
    """Write {key: tensor} as a ``.safetensors`` file (the format's 8-byte
    header length, JSON header padded to 8 bytes, raw little-endian data),
    each floating tensor cast to ``dtype`` when given, one tensor at a time
    through host memory. Returns the bytes of tensor data."""
    def out_dtype(t):
        return dtype if dtype is not None and t.is_floating_point() else t.dtype

    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for key, t in tensors.items():
        nbytes = t.numel() * out_dtype(t).itemsize
        header[key] = {"dtype": SAFETENSORS_DTYPES[out_dtype(t)], "shape": list(t.shape),
                       "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little") + blob)
        for t in tensors.values():
            data = t.detach().to(out_dtype(t)).cpu().contiguous().reshape(-1)
            f.write(memoryview(data.view(torch.uint8).numpy()))
    return offset


def to_ldm_unet(d, cfg):
    """Inverse of the port's ``convert_ldm_unet``: diffusers UNet keys ->
    ``model.diffusion_model.*`` (the model is ``tests/test_convert_ldm.py``'s
    ``to_ldm_unet``)."""
    from image_editing_framework_torch.models import convert_ldm

    table = convert_ldm.unet_rename_table(cfg)
    prefixes = sorted(table, key=len, reverse=True)
    out = {}
    for k, v in d.items():
        dk = next((p for p in prefixes if k.startswith(p + ".")), None)
        if dk is None:
            raise KeyError(k)
        rest = k[len(dk) + 1:]
        if "resnets" in dk:
            for a, b in convert_ldm._RES_SUB.items():
                if rest.startswith(b):
                    rest = a + rest[len(b):]
                    break
        if dk.endswith("downsamplers.0") and rest.startswith("conv."):
            rest = rest[len("conv."):]
        out[f"model.diffusion_model.{table[dk]}.{rest}"] = v
    return out


def to_ldm_vae(d, cfg):
    """Inverse of the port's ``convert_ldm_vae``: diffusers VAE keys ->
    ``first_stage_model.*``, the mid-block attention's linears as 1x1 convs
    (the model is ``tests/test_convert_ldm.py``'s ``to_ldm_vae``)."""
    n = len(cfg.block_out_channels)
    out = {}
    for k, v in d.items():
        parts = k.split(".")
        if parts[0] in ("quant_conv", "post_quant_conv"):
            out[f"first_stage_model.{k}"] = v
            continue
        tower, rest = parts[0], parts[1:]
        pre = f"first_stage_model.{tower}"
        if rest[0] in ("conv_in", "conv_out"):
            out[f"{pre}.{'.'.join(rest)}"] = v
        elif rest[0] == "conv_norm_out":
            out[f"{pre}.norm_out.{rest[1]}"] = v
        elif rest[0] in ("down_blocks", "up_blocks"):
            level = rest[1] if rest[0] == "down_blocks" else str(n - 1 - int(rest[1]))
            side = "down" if rest[0] == "down_blocks" else "up"
            if rest[2] == "resnets":
                sub = ".".join(rest[4:]).replace("conv_shortcut", "nin_shortcut")
                out[f"{pre}.{side}.{level}.block.{rest[3]}.{sub}"] = v
            else:  # downsamplers / upsamplers
                out[f"{pre}.{side}.{level}.{side}sample.{'.'.join(rest[4:])}"] = v
        elif rest[0] == "mid_block" and rest[1] == "resnets":
            out[f"{pre}.mid.block_{int(rest[2]) + 1}.{'.'.join(rest[3:])}"] = v
        elif rest[0] == "mid_block":  # attentions.0
            name = {"group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v"}.get(rest[3], "proj_out")
            out[f"{pre}.mid.attn_1.{name}.{rest[-1]}"] = v[:, :, None, None] if v.dim() == 2 else v
        else:
            raise KeyError(k)
    return out


def to_ldm_single_file(pipe):
    """An SD1.x pipeline's weights under the LDM single-file keys: UNet,
    VAE, and the CLIP-L tower as ``cond_stage_model.transformer.*`` with
    its ``position_ids``."""
    text = dict(pipe.text_encoder.state_dict(), **clip_position_ids())
    return {**to_ldm_unet(pipe.unet.state_dict(), pipe.unet.config),
            **to_ldm_vae(pipe.vae.state_dict(), pipe.vae.config),
            **{f"cond_stage_model.transformer.{k}": v for k, v in text.items()}}


def to_open_clip(state, prefix):
    """Inverse of the port's ``convert_open_clip_text``: transformers CLIP
    keys -> OpenCLIP's (q/k/v fused into ``in_proj``, ``text_projection`` as
    x @ W), for torch tensors or numpy arrays. Each layer's fused tensors are
    made from that layer's alone."""
    out = {f"{prefix}token_embedding.weight": state["text_model.embeddings.token_embedding.weight"],
           f"{prefix}positional_embedding": state["text_model.embeddings.position_embedding.weight"],
           f"{prefix}ln_final.weight": state["text_model.final_layer_norm.weight"],
           f"{prefix}ln_final.bias": state["text_model.final_layer_norm.bias"]}
    if "text_projection.weight" in state:
        out[f"{prefix}text_projection"] = state["text_projection.weight"].T
    cat = torch.cat if isinstance(state["text_model.final_layer_norm.weight"], torch.Tensor) else np.concatenate
    i = 0
    while f"text_model.encoder.layers.{i}.layer_norm1.weight" in state:
        src, dst = f"text_model.encoder.layers.{i}", f"{prefix}transformer.resblocks.{i}"
        for a, b in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2")):
            for leaf in ("weight", "bias"):
                out[f"{dst}.{a}.{leaf}"] = state[f"{src}.{b}.{leaf}"]
        for leaf in ("weight", "bias"):
            out[f"{dst}.attn.in_proj_{leaf}"] = cat([state[f"{src}.self_attn.{n}.{leaf}"]
                                                     for n in ("q_proj", "k_proj", "v_proj")])
            out[f"{dst}.attn.out_proj.{leaf}"] = state[f"{src}.self_attn.out_proj.{leaf}"]
            out[f"{dst}.mlp.c_fc.{leaf}"] = state[f"{src}.mlp.fc1.{leaf}"]
            out[f"{dst}.mlp.c_proj.{leaf}"] = state[f"{src}.mlp.fc2.{leaf}"]
        i += 1
    return out


def to_ldm_single_file_xl(pipe):
    """An SDXL base pipeline's weights under the LDM single-file keys: UNet,
    VAE, the CLIP-L tower as ``conditioner.embedders.0.transformer.*`` with
    its ``position_ids``, and bigG in OpenCLIP's layout as
    ``conditioner.embedders.1.model.*``."""
    text = dict(pipe.text_encoder.state_dict(), **clip_position_ids())
    return {**to_ldm_unet(pipe.unet.state_dict(), pipe.unet.config),
            **to_ldm_vae(pipe.vae.state_dict(), pipe.vae.config),
            **{f"conditioner.embedders.0.transformer.{k}": v for k, v in text.items()},
            **to_open_clip(pipe.text_encoder_2.state_dict(), "conditioner.embedders.1.model.")}


def clip_position_ids():
    """The extra key real CLIP checkpoints carry (transformers' buffer)."""
    return {"text_model.embeddings.position_ids": torch.arange(77, dtype=torch.int64)[None]}


def synthetic_clip_vocab(words, size=CLIP_VOCAB_SIZE):
    """(vocab, merges) laid out as CLIP's: the 256 byte symbols, the same
    with ``</w>``, one merge chain per word of ``words`` (left to right,
    making ``word</w>`` one token), filler up to ``size`` - 2, then
    ``<|startoftext|>`` and ``<|endoftext|>``."""
    from image_editing_framework_torch.models.tokenizer import _bytes_to_unicode

    symbols = list(_bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(symbols + [s + "</w>" for s in symbols])}
    merges = {}  # in rank order, each pair once
    for word in dict.fromkeys(w for w in words if len(w) > 1):
        piece = word[0]
        for i, ch in enumerate(word[1:], 1):
            ch = ch + "</w>" if i == len(word) - 1 else ch
            merges.setdefault((piece, ch), None)
            piece += ch
            vocab.setdefault(piece, len(vocab))
    for i in range(len(vocab), size - 2):
        vocab[f"<|filler{i}|>"] = i
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = size - 2, size - 1
    return vocab, list(merges)


def write_tokenizer(directory, vocab, merges):
    import os

    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(directory, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


def write_snapshot(directory, parts, vocab, merges, tokenizers=("tokenizer",)):
    """An HF snapshot directory: each (subdirectory, module, file name) of
    ``parts`` as fp16 safetensors (a text encoder with its
    ``position_ids``), the synthetic BPE vocab in each of ``tokenizers``.
    Returns the bytes of tensor data."""
    import os

    nbytes = 0
    for sub, module, name in parts:
        os.makedirs(os.path.join(directory, sub))
        extra = clip_position_ids() if sub.startswith("text_encoder") else {}
        nbytes += write_safetensors(dict(module.state_dict(), **extra),
                                    os.path.join(directory, sub, name + ".safetensors"), torch.float16)
    for sub in tokenizers:
        write_tokenizer(os.path.join(directory, sub), vocab, merges)
    return nbytes


def write_single_file(state, directory, vocab, merges):
    """One LDM single file ``directory/model.safetensors`` (fp16) with the
    tokenizer beside it. Returns (path, bytes of tensor data)."""
    import os

    os.makedirs(directory)
    path = os.path.join(directory, "model.safetensors")
    nbytes = write_safetensors(state, path, torch.float16)
    write_tokenizer(os.path.join(directory, "tokenizer"), vocab, merges)
    return path, nbytes


def write_sd_checkpoints(pipe, root, words):
    """Write ``pipe`` (SD1.x) as an HF snapshot directory ``root/sd`` (fp16
    weights under the ``.fp16`` names, the text encoder with its
    ``position_ids``, a synthetic BPE vocab that makes ``words`` whole) and
    as one LDM single file ``root/single/model.safetensors`` (fp16, the
    tokenizer beside it). Returns (snapshot dir, single file, data bytes of
    each)."""
    import os

    snapshot = os.path.join(root, "sd")
    vocab, merges = synthetic_clip_vocab(words)
    nbytes = write_snapshot(snapshot, (("unet", pipe.unet, "diffusion_pytorch_model.fp16"),
                                       ("vae", pipe.vae, "diffusion_pytorch_model.fp16"),
                                       ("text_encoder", pipe.text_encoder, "model")), vocab, merges)
    path, single_bytes = write_single_file(to_ldm_single_file(pipe), os.path.join(root, "single"), vocab, merges)
    return snapshot, path, nbytes, single_bytes


def write_xl_checkpoints(pipe, refiner_unet, root, words):
    """Write ``pipe`` (SDXL base) as an HF snapshot directory ``root/xl``
    (fp16: UNet, VAE, CLIP-L and bigG with its projection; ``tokenizer/``
    and ``tokenizer_2/``), as one LDM single file
    ``root/xl_single/model.safetensors`` with the tokenizer beside it, and
    ``refiner_unet`` as the refiner's snapshot ``root/xl_refiner`` (its UNet:
    the base's VAE and bigG serve it). Returns {name: (path, data bytes)}."""
    import os

    vocab, merges = synthetic_clip_vocab(words)
    snapshot, refiner = os.path.join(root, "xl"), os.path.join(root, "xl_refiner")
    nbytes = write_snapshot(snapshot, (("unet", pipe.unet, "diffusion_pytorch_model.fp16"),
                                       ("vae", pipe.vae, "diffusion_pytorch_model.fp16"),
                                       ("text_encoder", pipe.text_encoder, "model.fp16"),
                                       ("text_encoder_2", pipe.text_encoder_2, "model.fp16")),
                            vocab, merges, ("tokenizer", "tokenizer_2"))
    single = write_single_file(to_ldm_single_file_xl(pipe), os.path.join(root, "xl_single"), vocab, merges)
    refiner_bytes = write_snapshot(refiner, (("unet", refiner_unet, "diffusion_pytorch_model.fp16"),), vocab, merges,
                                   ())
    return {"snapshot": (snapshot, nbytes), "single_file": single, "refiner": (refiner, refiner_bytes)}


def rss_gib():
    """(current, peak) resident set of this process, GiB."""
    import resource

    with open("/proc/self/statm") as f:
        current = int(f.read().split()[1]) * resource.getpagesize()
    return current / 2**30, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def timed_loads(fn):
    """(fn(), [(module, checkpoint bytes, seconds), ...] of every
    ``load_params`` the registry made in it, total seconds)."""
    from image_editing_framework_torch.models import registry

    loads, real = [], registry.load_params

    def load_params(module, ckpt, dtype=None, device=None, strict=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(module, ckpt, dtype, device, strict)
        torch.cuda.synchronize()
        nbytes = sum(ckpt[k].numel() * ckpt[k].element_size() for k in out.state_dict())
        loads.append((type(module).__name__, nbytes, time.perf_counter() - t0))
        return out

    registry.load_params = load_params
    try:
        out, seconds = timed(fn)
    finally:
        registry.load_params = real
    return out, loads, seconds


def scratch_base(need_gib, tag):
    """A directory with ``need_gib`` GiB free for checkpoints: ``$TMPDIR``,
    else the checkout's ignored ``_local/``; fails where neither has it."""
    import os
    import shutil

    need = need_gib * 2**30
    base = tempfile.gettempdir()
    if shutil.disk_usage(base).free < need:  # the checkout's ignored scratch directory instead
        base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_local")
        os.makedirs(base, exist_ok=True)
    usage = shutil.disk_usage(base)
    emit(tag, directory=base, total_gib=usage.total / 2**30, free_gib=usage.free / 2**30, need_gib=need_gib)
    if usage.free < need:
        raise AssertionError(f"{usage.free / 2**30:.1f} GiB free in {base}: the checkpoints need {need_gib}")
    return base


def per_component(entries):
    """``timed_loads``' loads as {module, GB, s, GB/s}."""
    return [dict(module=m, gb=b / 1e9, s=s, gb_per_s=b / 1e9 / s) for m, b, s in entries]


def measured_load(fn):
    """(fn(), its figures): seconds, GB and GB/s of its ``load_params``
    calls in all and per component, host RSS before, after and at the
    process's peak, and the card's peak above what was allocated before."""
    rss_before = rss_gib()[0]
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out, loads, seconds = timed_loads(fn)
    rss_after, rss_peak = rss_gib()
    nbytes = sum(b for _, b, _ in loads)
    return out, dict(s=seconds, gb=nbytes / 1e9, gb_per_s=nbytes / 1e9 / seconds, components=per_component(loads),
                     host_rss_before_gib=rss_before, host_rss_after_gib=rss_after, host_peak_rss_gib=rss_peak,
                     device_load_peak_gib=(torch.cuda.max_memory_allocated() - before) / 2**30)


def unequal_tensors(name, a, b, w):
    """Keys of module ``name`` whose tensors differ between two loads ``a``
    and ``b`` or from the written weights ``w`` through fp16 (the
    checkpoints' dtype) in the loads' dtype; fails where the keys differ."""
    a, b, w = (m.state_dict() for m in (a, b, w))
    if a.keys() != b.keys() or a.keys() != w.keys():
        raise AssertionError(f"{name}: the loads' keys differ from the module's")
    return [f"{name}.{k}" for k in a if not (torch.equal(a[k], b[k]) and torch.equal(
        a[k], w[k].to(torch.float16).to(a[k].dtype)))]


def phase_checkpoint_path(pipe, tmp):
    """The reference's own entry points on a checkpoint, SD1.5 at full
    width, bf16: ``pipe``'s weights (``random_pipeline("1.5", seed=0)``)
    written into ``tmp`` as an HF snapshot and as an LDM single file, named
    through ``sd_mapping.sd_maps`` ("1.5" and "ghostv2"), loaded by
    ``cli.load_pipe`` (timed per component; the two loads bitwise equal, and
    equal to the weights through fp16), then ``shims`` p2p ``edit_real``
    (DDIM inversion) on a 512² PNG the phase writes and p2p ``edit_syn``,
    each with its exact flash-forward launches, PNGs read back. Returns the
    launches and the snapshot directory (the sweep phase reads it)."""
    import os
    import shutil

    from image_editing_framework_torch import cli, sd_mapping, shims
    from image_editing_framework_torch.utils.images import decode_png, encode_png

    words, side = CKPT_WORDS, MODELS["sd"][2]
    saved, cwd = dict(sd_mapping.sd_maps), os.getcwd()
    try:
        t0 = time.perf_counter()
        snapshot, single, snapshot_bytes, single_bytes = write_sd_checkpoints(pipe, tmp, words)
        write_s = time.perf_counter() - t0
        sd_mapping.sd_maps["1.5"], sd_mapping.sd_maps["ghostv2"] = snapshot, single
        loaded, load = measured_load(lambda: cli.load_pipe("1.5"))
        ghost, ghost_load = measured_load(lambda: cli.load_pipe("ghostv2"))
        unequal = [k for name in ("unet", "vae", "text_encoder")
                   for k in unequal_tensors(name, getattr(loaded, name), getattr(ghost, name), getattr(pipe, name))]
        if unequal:
            raise AssertionError(f"{len(unequal)} tensors differ between the snapshot load, the single-file "
                                 f"load and the weights through fp16: {unequal[:5]}")
        vocab, _ = synthetic_clip_vocab(words)
        want_ids = [[vocab["<|startoftext|>"]] + [vocab[w + "</w>"] for w in p.split()] + [vocab["<|endoftext|>"]]
                    for p in CKPT_PROMPTS]
        del loaded, ghost
        torch.cuda.empty_cache()

        work = os.path.join(tmp, "work")
        os.makedirs(work)
        os.chdir(work)
        source = (np.random.RandomState(3).rand(side, side, 3) * 255).astype(np.uint8)
        with open("source_image.png", "wb") as f:
            f.write(encode_png(source))
        runs = {}
        for entry, flags, forwards in (
                ("edit_real", ["--inversion_type", "ddim", "--source_image", "source_image.png"], 2 * STEPS),
                ("edit_syn", [], STEPS)):
            shutil.rmtree("exp", ignore_errors=True)
            pipes, real_load_pipe = [], cli.load_pipe
            cli.load_pipe = lambda *a, **k: pipes.append(real_load_pipe(*a, **k)) or pipes[-1]
            try:
                reset_launch_counts()
                _, loads_in_run, run_s = timed_loads(lambda: shims.main(
                    ["p2p", entry, "--sd_version", "1.5", "--source_prompt", CKPT_PROMPTS[0],
                     "--target_prompt", CKPT_PROMPTS[1], *flags]))
                counts = launch_counts()
            finally:
                cli.load_pipe = real_load_pipe
            expected = (SITES["sd"] * forwards, 0, 0)
            if counts != expected:
                raise AssertionError(f"p2p {entry} launched (forward, dQ, dK/dV) {counts} times, "
                                     f"expected {expected}")
            ids = [pipes[0].tokenizer.encode(p) for p in CKPT_PROMPTS]
            if ids != want_ids:
                raise AssertionError(f"token ids {ids}, the synthetic vocab defines {want_ids}")
            names = ("source", "inversion", "edit") if entry == "edit_real" else ("source", "edit")
            images = {}
            for name in names:
                with open(os.path.join("exp", name + ".png"), "rb") as f:
                    images[name] = decode_png(f.read())
                img = images[name]
                if img is None or img.shape != (side, side, 3) or img.dtype != np.uint8 or img.std() == 0:
                    raise AssertionError(f"exp/{name}.png of p2p {entry}: {None if img is None else img.shape}, "
                                         f"constant or misshapen")
            if entry == "edit_real" and not np.array_equal(images["source"], source):
                raise AssertionError("exp/source.png differs from the source image")
            run_load_s = sum(seconds for _, _, seconds in loads_in_run)
            runs[entry] = dict(seconds=run_s, load_s=run_load_s, image_s=run_s - run_load_s,
                               flash_launches=counts[0],
                               image_means={k: float(v.mean()) for k, v in images.items()})
            del pipes
            torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
        sd_mapping.sd_maps.clear()
        sd_mapping.sd_maps.update(saved)

    emit("checkpoint_path", model="SD1.5 (random weights, seed 0, written fp16, loaded bf16)", resolution=side,
         dtype="bfloat16", steps=STEPS, write_s=write_s, snapshot_gb=snapshot_bytes / 1e9,
         single_file_gb=single_bytes / 1e9, load_s=load["s"], load_gb=load["gb"], load_gb_per_s=load["gb_per_s"],
         load_components=load["components"], host_rss_before_gib=load["host_rss_before_gib"],
         host_rss_after_gib=load["host_rss_after_gib"], host_peak_rss_gib=load["host_peak_rss_gib"],
         device_load_peak_gib=load["device_load_peak_gib"], single_file_load_s=ghost_load["s"],
         single_file_components=ghost_load["components"], loads_bitwise_equal=True,
         edit_real=runs["edit_real"], edit_syn=runs["edit_syn"],
         main_path_image_s=EMITTED["main_path"]["image_s"], token_ids=want_ids, card=card_line())
    return runs["edit_real"]["flash_launches"] + runs["edit_syn"]["flash_launches"], snapshot


def write_mini_pie(root, side, seed=0):
    """A PIE-Bench directory of ``SWEEP_PIE``'s items: ``mapping_file.json``
    and ``side``² seeded JPEGs (Pillow) under ``annotation_images``. Each
    image is smooth noise (a seeded 8 x 8 grid resized up), so that it has
    the large flat regions of a photo and survives JPEG."""
    import os

    from PIL import Image

    rng = np.random.RandomState(seed)
    mapping = {}
    for rel, source, target in SWEEP_PIE:
        path = os.path.join(root, "annotation_images", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        grid = Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8))
        grid.resize((side, side), Image.BICUBIC).save(path, quality=90)
        mapping[os.path.splitext(os.path.basename(rel))[0]] = {
            "image_path": rel, "original_prompt": source, "editing_prompt": target,
            "blended_words": "", "mask": ""}
    with open(os.path.join(root, "mapping_file.json"), "w") as f:
        json.dump(mapping, f, indent=1)
    return root


def sweep_launches(sites, items, steps, cached):
    """Flash-forward launches of a P2P sweep over ``items`` images: per
    image, ``steps`` UNet forwards of DDIM inversion (none where the
    inversion comes from the cache) and ``steps`` of the edit, one launch
    at each self-attention site of each."""
    return sites * items * steps * (1 if cached else 2)


# the keys of a sweep's stats file: every run; a run that edited images
SWEEP_STATS_KEYS = {"method", "inversion_type", "inversion_type_effective", "images_done", "images_skipped",
                    "wall_s", "mean_s_per_image", "steady_s_per_image", "device_peak_bytes", "host_peak_rss_mb"}
SWEEP_DONE_KEYS = SWEEP_STATS_KEYS | {"recon_mse_mean", "recon_psnr_mean", "recon_ssim_mean", "p50_s_per_image",
                                      "p95_s_per_image", "max_s_per_image"}


def phase_sweep_path(root, snapshot):
    """The reference's third entry point, the PIE-Bench sweep, on the SD1.5
    snapshot ``phase_checkpoint_path`` wrote into ``root``, bf16, 512²: a
    mini PIE (``SWEEP_PIE``, 512² JPEGs) and three runs of ``shims`` p2p
    ``test``: (a) with ``--save_inversions``, (b) the same command again
    (resume: every image skipped), (c) from (a)'s cache
    (``--inversion_path``) into another ``--exp_path``. Each run's exact
    flash-forward launches; its PNGs read back (512² uint8, not constant);
    its event log strict JSON with finite reconstruction metrics; its stats
    file's keys; (c)'s images against (a)'s (the cache gives back the same
    bf16 latent, so within one level); seconds per image beside
    ``main_path``'s."""
    import os

    from image_editing_framework_torch import sd_mapping, shims
    from image_editing_framework_torch.data.pie import DEFAULT_CATEGORIES, PIE
    from image_editing_framework_torch.utils.images import decode_png

    side = MODELS["sd"][2]
    pie = write_mini_pie(os.path.join(root, "PIE"), side)
    work = [it.key for c in DEFAULT_CATEGORIES for it in PIE(pie, c).items]
    skipped_by_category = [it.key for it in PIE(pie).items if it.key not in work]
    if len(work) != 3 or len(skipped_by_category) != 1:
        raise AssertionError(f"mini PIE: {work} in the default categories, {skipped_by_category} outside")
    cache = os.path.join(root, "inversions")
    exp = {"a": os.path.join(root, "exp_a"), "c": os.path.join(root, "exp_c")}
    sites = SITES["sd"]
    plan = (("a", exp["a"], ["--save_inversions", cache], 3, sweep_launches(sites, 3, STEPS, False)),
            ("b", exp["a"], [], 0, 0),
            ("c", exp["c"], ["--inversion_path", cache], 3, sweep_launches(sites, 3, STEPS, True)))
    saved, runs, images = dict(sd_mapping.sd_maps), {}, {}
    try:
        sd_mapping.sd_maps["1.5"] = snapshot
        for label, out, flags, done, expected in plan:
            reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            _, loads, run_s = timed_loads(lambda: shims.main(
                ["p2p", "test", "--sd_version", "1.5", "--dataset_path", pie, "--exp_path", out, *flags]))
            counts = launch_counts()
            if counts != (expected, 0, 0):
                raise AssertionError(f"sweep run ({label}) launched (forward, dQ, dK/dV) {counts} times, expected "
                                     f"({expected}, 0, 0)")
            with open(os.path.join(out, "sweep_stats_p2p_0.json")) as f:
                stats = json.load(f)
            keys = SWEEP_DONE_KEYS if done else SWEEP_STATS_KEYS
            if set(stats) != keys or (stats["images_done"], stats["images_skipped"]) != (done, 3 - done):
                raise AssertionError(f"sweep run ({label}) stats {stats}: keys {sorted(set(stats) ^ keys)} differ, or "
                                     f"not {done} done and {3 - done} skipped")

            def reject(token):
                raise AssertionError(f"non-strict JSON token {token!r} in the event log")

            with open(os.path.join(out, "events_p2p_0.jsonl")) as f:
                events = [json.loads(line, parse_constant=reject) for line in f]
            if sorted(e["key"] for e in events) != sorted(work) or not all(
                    math.isfinite(e[f"recon_{m}"]) for e in events for m in ("mse", "psnr", "ssim")):
                raise AssertionError(f"sweep run ({label}) event log: {events}")
            if os.path.exists(os.path.join(out, skipped_by_category[0])):
                raise AssertionError(f"sweep run ({label}) edited {skipped_by_category[0]}, outside its categories")
            for key in work:
                for name in ("source", "inversion", "edit"):
                    with open(os.path.join(out, key, name + ".png"), "rb") as f:
                        img = images[label, key, name] = decode_png(f.read())
                    if img is None or img.shape != (side, side, 3) or img.dtype != np.uint8 or img.std() == 0:
                        raise AssertionError(f"sweep run ({label}) {key}/{name}.png: "
                                             f"{None if img is None else img.shape}, constant or misshapen")
            load_s = sum(seconds for _, _, seconds in loads)
            runs[label] = dict(seconds=run_s, load_s=load_s, flash_launches=counts[0],
                               event_lines=len(events), **stats)
    finally:
        sd_mapping.sd_maps.clear()
        sd_mapping.sd_maps.update(saved)
    levels = {name: max(int(np.abs(images["c", key, name].astype(np.int32)
                                   - images["a", key, name].astype(np.int32)).max()) for key in work)
              for name in ("source", "inversion", "edit")}
    if levels["source"] != 0 or max(levels.values()) > 1:
        raise AssertionError(f"the cache's images differ from the inversion's by {levels} levels")
    emit("sweep_path", model="SD1.5 (random weights, seed 0, from the fp16 snapshot, bf16)", resolution=side,
         dtype="bfloat16", steps=STEPS, items=work, runs=runs, cache_vs_inversion_max_levels=levels,
         mean_s_per_image={k: r["mean_s_per_image"] for k, r in runs.items()},
         p50_s_per_image={k: r.get("p50_s_per_image") for k, r in runs.items()},
         main_path_image_s=EMITTED["main_path"]["image_s"], card=card_line())
    return sum(r["flash_launches"] for r in runs.values()), {k: r["flash_launches"] for k, r in runs.items()}


def phase_xl_checkpoint_path(pipe):
    """SDXL base and refiner from checkpoints on the card, bf16: ``pipe``'s
    weights (``random_pipeline("xl", seed=0)``) written fp16 as an HF
    snapshot and as an LDM single file, and a seeded refiner UNet as the
    refiner's snapshot (about 18.4 GB on disk); ``cli.load_pipe`` of
    "xl-base" (the snapshot) and "animagineXL" (the single file), bitwise
    equal to each other and to the weights through fp16; then "xl-refiner"
    (the base a third time with the refiner attached), which must share the
    base's VAE, bigG tower and tokenizer, and one refiner img2img on it;
    then the p2p shim's ``edit_real`` with DDIM inversion at 1024², exact
    launches. Each pipe is freed before the next load."""
    import os

    from image_editing_framework_torch import cli, sd_mapping, shims
    from image_editing_framework_torch.methods.img2img import img2img
    from image_editing_framework_torch.models import configs
    from image_editing_framework_torch.models.unet import UNet2DCondition
    from image_editing_framework_torch.pipelines import _build
    from image_editing_framework_torch.utils.images import decode_png, encode_png

    refiner_unet = _build(UNet2DCondition, configs.SDXL_REFINER_UNET, pipe.device, torch.bfloat16, 0)
    saved, saved_refiner, cwd = dict(sd_mapping.sd_maps), sd_mapping.refiner_key, os.getcwd()
    loads = {}
    base = scratch_base(XL_DISK_GIB, "xl_checkpoint_disk")
    with tempfile.TemporaryDirectory(prefix="ief_xl_checkpoint_", dir=base) as tmp:
        try:
            t0 = time.perf_counter()
            written = write_xl_checkpoints(pipe, refiner_unet, tmp, CKPT_WORDS)
            write_s = time.perf_counter() - t0
            sd_mapping.sd_maps["xl-base"] = sd_mapping.sd_maps["xl-refiner"] = written["snapshot"][0]
            sd_mapping.sd_maps["animagineXL"] = written["single_file"][0]
            sd_mapping.refiner_key = written["refiner"][0]
            loaded, loads["xl-base"] = measured_load(lambda: cli.load_pipe("xl-base"))
            ghost, loads["animagineXL"] = measured_load(lambda: cli.load_pipe("animagineXL"))
            bad = [k for name in ("unet", "vae", "text_encoder", "text_encoder_2")
                   for k in unequal_tensors(name, getattr(loaded, name), getattr(ghost, name), getattr(pipe, name))]
            if bad:
                raise AssertionError(f"{len(bad)} tensors differ between the snapshot load, the single-file load and "
                                     f"the weights through fp16: {bad[:5]}")
            del loaded, ghost
            torch.cuda.empty_cache()

            both, loads["xl-refiner"] = measured_load(lambda: cli.load_pipe("xl-refiner"))
            refiner = both.refiner
            shared = {name: getattr(refiner, name) is getattr(both, attr) for name, attr in (
                ("vae", "vae"), ("text_encoder_2", "text_encoder_2"), ("tokenizer_2", "tokenizer_2"),
                ("scheduler", "scheduler"))}
            if not all(shared.values()) or not refiner.is_refiner:
                raise AssertionError(f"the refiner shares {shared} with the base")
            bad = unequal_tensors("refiner.unet", refiner.unet, refiner.unet, refiner_unet) + unequal_tensors(
                "unet", both.unet, both.unet, pipe.unet)
            if bad:
                raise AssertionError(f"{len(bad)} tensors of the xl-refiner load differ from the weights: {bad[:5]}")
            side = MODELS["xl"][2]
            image = (np.random.RandomState(2).rand(side, side, 3) * 255).astype(np.uint8)
            ref_sites = refiner.unet.config.num_transformer_blocks
            reset_launch_counts()
            refined, refine_s = timed(lambda: img2img(refiner, image, CKPT_PROMPTS[0], strength=0.3,
                                                      generator=torch.Generator(device=pipe.device).manual_seed(0)))
            refine_counts = launch_counts()
            forwards = STEPS - int(STEPS * (1.0 - 0.3))
            if refine_counts != (ref_sites * forwards, 0, 0):
                raise AssertionError(f"the loaded refiner launched (forward, dQ, dK/dV) {refine_counts} times, "
                                     f"expected {ref_sites} x {forwards} forward")
            if refined.shape != (1, side, side, 3) or refined.dtype != np.uint8 or refined.std() == 0:
                raise AssertionError(f"refiner output {refined.shape} {refined.dtype} constant or misshapen")
            del both, refiner, refiner_unet
            torch.cuda.empty_cache()

            work = os.path.join(tmp, "work")
            os.makedirs(work)
            os.chdir(work)
            source = (np.random.RandomState(3).rand(side, side, 3) * 255).astype(np.uint8)
            with open("source_image.png", "wb") as f:
                f.write(encode_png(source))
            reset_launch_counts()
            _, run_loads, run_s = timed_loads(lambda: shims.main(
                ["p2p", "edit_real", "--sd_version", "xl-base", "--inversion_type", "ddim", "--source_image",
                 "source_image.png", "--source_prompt", CKPT_PROMPTS[0], "--target_prompt", CKPT_PROMPTS[1]]))
            counts = launch_counts()
            expected = (SITES["xl"] * 2 * STEPS, 0, 0)
            if counts != expected:
                raise AssertionError(f"p2p edit_real on xl-base launched (forward, dQ, dK/dV) {counts} times, "
                                     f"expected {expected}")
            means = {}
            for name in ("source", "inversion", "edit"):
                with open(os.path.join("exp", name + ".png"), "rb") as f:
                    img = decode_png(f.read())
                if img is None or img.shape != (side, side, 3) or img.dtype != np.uint8 or img.std() == 0:
                    raise AssertionError(f"exp/{name}.png of the xl-base edit_real: "
                                         f"{None if img is None else img.shape}, constant or misshapen")
                if name == "source" and not np.array_equal(img, source):
                    raise AssertionError("exp/source.png differs from the source image")
                means[name] = float(img.mean())
            run_load_s = sum(seconds for _, _, seconds in run_loads)
        finally:
            os.chdir(cwd)
            sd_mapping.sd_maps.clear()
            sd_mapping.sd_maps.update(saved)
            sd_mapping.refiner_key = saved_refiner
    emit("xl_checkpoint_path", model="SDXL base and refiner (random weights, seed 0, written fp16, loaded bf16)",
         resolution=side, dtype="bfloat16", steps=STEPS, write_s=write_s,
         written_gb={name: nbytes / 1e9 for name, (_, nbytes) in written.items()},
         write_gb_per_s=sum(nbytes for _, nbytes in written.values()) / 1e9 / write_s, loads=loads,
         loads_bitwise_equal=True, refiner_shares=shared, refine_s=refine_s, refine_flash_launches=refine_counts[0],
         edit_real=dict(seconds=run_s, load_s=run_load_s, image_s=run_s - run_load_s, flash_launches=counts[0],
                        image_means=means),
         xl_main_path_image_s=EMITTED["xl_main_path"]["image_s"], card=card_line())
    return counts[0] + refine_counts[0]


def phase_nti_path(model, pipe):
    """The same edit through null-text inversion, the reference's default:
    ``cli.invert(..., "null-text", "p2p")`` (DDIM inversion, then 50 steps of
    Adam iterations on the unconditional embedding) and
    ``p2p_edit(uncond_seq=...)``. SD1.5 runs the default NTIConfig (up to 10
    inner iterations per step). SDXL runs its own schedule (each step from
    the original embedding, the negative pooled embeds on the unconditional
    branch, the checkpointed UNet by the auto rule at latent side 128) at
    full width with XL_INNER_STEPS inner iterations per step: with random
    weights the early stop never fires, and 500 iterations of a
    2.6B-parameter forward, recomputation and backward would take minutes."""
    from image_editing_framework_torch import cli
    from image_editing_framework_torch.core.config import NTIConfig, P2PConfig, SamplerConfig
    from image_editing_framework_torch.inversion import nti
    from image_editing_framework_torch.methods.p2p import p2p_edit

    _, name, side, width = MODELS[model]
    image = (np.random.RandomState(1).rand(side, side, 3) * 255).astype(np.uint8)
    cfg = P2PConfig(edit_type="replace", blend_words=(("cat",), ("dog",)))
    sampler = SamplerConfig(num_inference_steps=STEPS, height=side, width=side)
    inner_steps = XL_INNER_STEPS if model == "xl" else NTIConfig().num_inner_steps

    # the NTI call's own seconds and launch counts, read around it
    marks = {}
    inner, config_for = cli.null_text_inversion, cli.nti_config_for

    def nti_read(*args, **kw):
        marks["before"] = launch_counts()
        out, marks["nti_s"] = timed(lambda: inner(*args, **kw))
        marks["after"] = launch_counts()
        return out

    def short_config(method, pipe):
        c = config_for(method, pipe)
        marks["config"] = NTIConfig(inner_steps, c.epsilon, c.base_lr, c.lr_decay_span, c.remat)
        return marks["config"]

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    nti.null_text_inversion.inner_iterations = 0
    cli.null_text_inversion, cli.nti_config_for = nti_read, short_config
    try:
        (last, traj, uncond_seq), invert_s = timed(lambda: cli.invert(pipe, image, PROMPTS[0], "null-text", "p2p"))
    finally:
        cli.null_text_inversion, cli.nti_config_for = inner, config_for
    images, edit_s = timed(lambda: p2p_edit(pipe, PROMPTS, last, cfg, sampler, uncond_seq=uncond_seq))
    counts = launch_counts()
    j = nti.null_text_inversion.inner_iterations

    # Forward launches of NTI: per step one conditional and one final
    # unconditional forward, and per inner iteration one forward, or two
    # with the checkpointed UNet (every block's forward is run again in the
    # backward pass). The backward kernels run at every site but the first.
    sites, grad_sites = SITES[model], GRAD_SITES[model]
    per_iteration = 2 * sites if model == "xl" else sites
    nti_counts = tuple(a - b for a, b in zip(marks["after"], marks["before"]))
    if not STEPS <= j <= inner_steps * STEPS:
        raise AssertionError(f"{j} inner iterations over {STEPS} steps")
    if nti_counts != (sites * 2 * STEPS + per_iteration * j, grad_sites * j, grad_sites * j):
        raise AssertionError(f"NTI launched (forward, dQ, dK/dV) {nti_counts} times; J = {j}")
    if counts != (sites * 4 * STEPS + per_iteration * j, grad_sites * j, grad_sites * j):
        raise AssertionError(f"the NTI path launched (forward, dQ, dK/dV) {counts} times; J = {j}")
    if uncond_seq.shape != (STEPS, 77, width) or not torch.isfinite(uncond_seq).all():
        raise AssertionError(f"NTI embeddings {tuple(uncond_seq.shape)} not finite or misshapen")
    if images.shape != (2, side, side, 3) or images.dtype != np.uint8 or images.std() == 0:
        raise AssertionError(f"edit output {images.shape} {images.dtype} constant or misshapen")
    emit("nti_path" if model == "sd" else "xl_nti_path", model=f"{name} (random weights, seed 0)", resolution=side,
         dtype="bfloat16", steps=STEPS, num_inner_steps=inner_steps, base_lr=marks["config"].base_lr,
         lr_decay_span=marks["config"].lr_decay_span, checkpointed_unet=model == "xl",
         invert_s=invert_s - marks["nti_s"], nti_s=marks["nti_s"], edit_and_decode_s=edit_s,
         image_s=invert_s + edit_s, nti_share=marks["nti_s"] / (invert_s + edit_s), inner_iterations=j,
         nti_launches=nti_counts, launches=counts, uncond_moved=float((uncond_seq[-1] - uncond_seq[0]).abs().max()),
         peak_gib=torch.cuda.max_memory_allocated() / 2**30, image_mean=float(images.mean()), card=card_line())
    return counts, (last, uncond_seq)


def phase_profile(model, pipe, lat4, ctx, added):
    """Device busy time of one UNet forward under torch.profiler (the sum of
    kernel durations on the one stream), against its unprofiled time."""
    from torch.profiler import ProfilerActivity, profile

    added1 = None if added is None else {k: v[2:3] for k, v in added.items()}
    for batch, lat, c, add in ((4, lat4, ctx, added), (1, lat4[:1], ctx[2:3], added1)):
        forward = lambda: pipe.unet_apply(lat, 501, c, None, add)  # noqa: E731
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
        emit("profile" if model == "sd" else "xl_profile", batch=batch, wall_ms=wall_ms, device_busy_ms=busy_ms,
             idle_share=1.0 - busy_ms / wall_ms, launches_per_forward=sum(e.count for e in kernels) / PROFILE_REPS,
             flash_ms=flash_ms, flash_share_of_busy=flash_ms / busy_ms,
             top=[[e.key[:60], e.self_device_time_total / PROFILE_REPS / 1e3] for e in top])


# forward calls per gated site of the auto-mask variant: normal, mutual and,
# once a 256-token cross-attention map is recorded earlier in the forward
# (SD1.5 has such sites before its gated layers, SDXL at 1024² none), fg and bg
AUTO_CALLS = {"sd": 4, "xl": 2}


def phase_masactrl_path(model, pipe, nti):
    """MasaCtrl through the user entry points, bf16, 50 steps, 2 prompts:
    ``cli.invert(..., "ddim", "masactrl")`` and ``cli.run_method("masactrl",
    ...)`` with the default (mutual) configuration; on the same inversion,
    edits alone with the union plan, a fixed asymmetric fg mask and the auto
    mask; then a mutual edit with ``phase_nti_path``'s inversion and
    null-text embeddings. Exact forward launches per run, none backward."""
    from image_editing_framework_torch import cli
    from image_editing_framework_torch.core.config import SamplerConfig
    from image_editing_framework_torch.methods.masactrl import default_masactrl_config

    _, name, side, _ = MODELS[model]
    image = (np.random.RandomState(3).rand(side, side, 3) * 255).astype(np.uint8)
    sampler = SamplerConfig(num_inference_steps=STEPS, height=side, width=side)
    cfg = default_masactrl_config(pipe)
    sites = SITES[model]
    gated = sites - cfg.start_layer
    lat = side // 8
    mask_s, mask_t = np.zeros((lat, lat), np.float32), np.zeros((lat, lat), np.float32)
    mask_s[lat // 8:5 * lat // 8, lat // 16:lat // 2] = 1.0  # the object, off-centre
    mask_t[lat // 4:3 * lat // 4, 3 * lat // 8:7 * lat // 8] = 1.0  # ... where the target puts it

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    (last, traj, _), invert_s = timed(lambda: cli.invert(pipe, image, PROMPTS[0], "ddim", "masactrl"))
    inv_counts = launch_counts()
    runs = {}
    for label, start, kw, per_step in (
            ("mutual", last, {}, sites),
            ("union", last, dict(method_kwargs={"config": dataclasses.replace(cfg, mode="union")}), sites),
            ("mask", last, dict(method_kwargs={"mask_s": mask_s, "mask_t": mask_t}), sites + 2 * gated),
            ("auto", last, dict(method_kwargs={"auto_mask": True}), sites + (AUTO_CALLS[model] - 1) * gated),
            ("nti_mutual", nti[0], dict(uncond_seq=nti[1]), sites)):
        reset_launch_counts()
        images, edit_s = timed(lambda: cli.run_method("masactrl", pipe, PROMPTS, start, sampler, **kw))
        counts = launch_counts()
        if counts != (per_step * STEPS, 0, 0):
            raise AssertionError(f"MasaCtrl {label} on {model} launched (forward, dQ, dK/dV) {counts} times, "
                                 f"expected ({per_step * STEPS}, 0, 0)")
        if any(x.shape != (side, side, 3) or x.dtype != np.uint8 or x.std() == 0 for x in images):
            raise AssertionError(f"MasaCtrl {label} output constant or misshapen")
        runs[label] = dict(edit_and_decode_s=edit_s, flash_launches=counts[0], images=images)
    if inv_counts != (sites * STEPS, 0, 0) or not torch.isfinite(traj.float()).all():
        raise AssertionError(f"the MasaCtrl inversion launched {inv_counts} times or is not finite")
    # the masks change the target against mutual attention (the auto mask
    # only where it finds maps); union's may not show in uint8: both branches
    # start from one latent, so the target's own keys are close to the source's
    differs = {label: bool(not np.array_equal(runs[label]["images"][1], runs["mutual"]["images"][1]))
               for label in ("union", "mask", "auto")}
    if not (differs["mask"] and differs["auto"] == (AUTO_CALLS[model] == 4)):
        raise AssertionError(f"a masked MasaCtrl variant's target equals the mutual edit's: {differs}")
    emit("masactrl_path" if model == "sd" else "xl_masactrl_path", model=f"{name} (random weights, seed 0)",
         resolution=side, dtype="bfloat16", steps=STEPS, start_step=cfg.start_step, start_layer=cfg.start_layer,
         invert_s=invert_s, inversion_launches=inv_counts[0],
         runs={label: {k: v for k, v in run.items() if k != "images"} | {"image_mean": float(run["images"][1].mean())}
               | ({} if label == "nti_mutual" else {  # that one's inversion is the NTI path's
                   "image_s": invert_s + run["edit_and_decode_s"],
                   "image_launches": inv_counts[0] + run["flash_launches"]}) for label, run in runs.items()},
         differs_from_mutual=differs, bwd_launches=0, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
         card=card_line())
    by_run = {label: run["flash_launches"] for label, run in runs.items()}
    return inv_counts[0] + sum(by_run.values()), dict(inversion=inv_counts[0], **by_run), (last, invert_s, inv_counts[0])


def phase_pnp_path(model, pipe, inversion):
    """Plug-and-Play through ``cli.run_method("pnp", ...)`` on
    ``phase_masactrl_path``'s DDIM inversion, bf16, 50 steps: exact forward
    launches, none backward."""
    from image_editing_framework_torch import cli
    from image_editing_framework_torch.core.config import SamplerConfig

    _, name, side, _ = MODELS[model]
    last, invert_s, inv_launches = inversion
    sampler = SamplerConfig(num_inference_steps=STEPS, height=side, width=side)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    images, edit_s = timed(lambda: cli.run_method("pnp", pipe, PROMPTS, last, sampler))
    counts = launch_counts()
    expected = (SITES[model] * STEPS, 0, 0)
    if counts != expected:
        raise AssertionError(f"PnP on {model} launched (forward, dQ, dK/dV) {counts} times, expected {expected}")
    if any(x.shape != (side, side, 3) or x.dtype != np.uint8 or x.std() == 0 for x in images):
        raise AssertionError("PnP output constant or misshapen")
    emit("pnp_path" if model == "sd" else "xl_pnp_path", model=f"{name} (random weights, seed 0)", resolution=side,
         dtype="bfloat16", steps=STEPS, edit_and_decode_s=edit_s, image_s=invert_s + edit_s,
         flash_launches=counts[0], image_launches=inv_launches + counts[0], bwd_launches=0,
         peak_gib=torch.cuda.max_memory_allocated() / 2**30, image_mean=float(images[1].mean()), card=card_line())
    return counts[0]


# the guided step phase_p2z_path times alone
P2Z_PROBE_STEP = 25


def phase_p2z_path(model, pipe, nti):
    """pix2pix-zero through the user entry points, bf16, 50 steps, 2
    prompts: ``cli.invert(..., "ddim", "p2z")`` and ``cli.run_method("p2z",
    ...)`` with the default configuration (SD1.5: the references recorded
    in pass 1; SDXL: recomputed from pass 1's trajectory, the checkpointed
    UNet by the auto rule at latent side 128); then the edit alone on
    ``phase_nti_path``'s inversion and embeddings (their swap in both
    passes). Per run: seconds of pass 1, pass 2 and the decodes, exact
    launch counts, the loss of the first and last guided step. Then one
    guided step (step ``P2Z_PROBE_STEP`` from the inverted latent, SDXL's
    recomputed references included) timed alone and under torch.profiler,
    beside its gradient alone and a forward at CFG batch 2."""
    import functools

    from torch.profiler import ProfilerActivity, profile

    from image_editing_framework_torch import cli
    from image_editing_framework_torch.core.config import P2ZConfig, SamplerConfig
    from image_editing_framework_torch.methods import common, p2z
    from image_editing_framework_torch.methods.base import _step_context

    _, name, side, _ = MODELS[model]
    image = (np.random.RandomState(4).rand(side, side, 3) * 255).astype(np.uint8)
    sampler = SamplerConfig(num_inference_steps=STEPS, height=side, width=side)
    sites, xl = SITES[model], model == "xl"
    checkpointed = isinstance(common.grad_unet(pipe, side // 8), functools.partial)
    # pass 2 per step: the gradient's forward and the noise forward; with
    # recomputed references their forward, with the checkpointed UNet the
    # blocks' forward again in the backward pass
    per_step = sites * (2 + int(xl) + int(checkpointed))
    marks = {}
    denoise, guided, decode = p2z.denoise, p2z._guided_scan, pipe.latent2image

    def measured(key, fn, keep=lambda out: out):
        """``fn`` with its seconds (summed over calls), its launches and
        ``keep(output)`` kept under ``key``."""
        def call(*args, **kw):
            before = launch_counts()
            out, seconds = timed(lambda: fn(*args, **kw))
            marks[key + "_s"] = marks.get(key + "_s", 0.0) + seconds
            marks[key + "_launches"] = tuple(a - b for a, b in zip(launch_counts(), before))
            marks[key] = keep(out)
            return out
        return call

    runs = {}
    # pass 1's final latent only: its recorded references go before the decodes
    p2z.denoise, p2z._guided_scan = measured("pass1", denoise, keep=lambda out: out[0]), measured("pass2", guided)
    pipe.latent2image = measured("decode", decode, keep=lambda out: None)
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        (last, _, _), invert_s = timed(lambda: cli.invert(pipe, image, PROMPTS[0], "ddim", "p2z"))
        inv_counts = launch_counts()
        for label, start, uncond in (("ddim", last, None), ("nti", nti[0], nti[1])):
            marks.clear()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            images, edit_s = timed(lambda: cli.run_method("p2z", pipe, PROMPTS, start, sampler, uncond_seq=uncond))
            runs[label] = dict(marks, edit_s=edit_s, launches=launch_counts(), images=images,
                               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    finally:
        p2z.denoise, p2z._guided_scan = denoise, guided
        del pipe.latent2image

    if inv_counts != (sites * STEPS, 0, 0):
        raise AssertionError(f"the p2z inversion on {model} launched (forward, dQ, dK/dV) {inv_counts} times")
    expected = (sites * STEPS + per_step * STEPS, sites * STEPS, sites * STEPS)
    lines = {}
    for label, run in runs.items():
        (final, losses), final_src = run["pass2"], run["pass1"]
        if run["launches"] != expected or run["pass2_launches"] != (per_step * STEPS,) + expected[1:]:
            raise AssertionError(f"p2z {label} on {model} launched (forward, dQ, dK/dV) {run['launches']} times "
                                 f"(pass 2: {run['pass2_launches']}), expected {expected}")
        moved = (final.float() - final_src.float()).abs().max().item()
        if not (torch.isfinite(losses).all() and losses.shape == (STEPS,) and math.isfinite(moved) and moved > 0):
            raise AssertionError(f"p2z {label} on {model}: losses {losses}, edit moved {moved} from pass 1")
        if any(x.shape != (side, side, 3) or x.dtype != np.uint8 or x.std() == 0 for x in run["images"]):
            raise AssertionError(f"p2z {label} output constant or misshapen")
        lines[label] = dict(
            pass1_s=run["pass1_s"], pass2_s=run["pass2_s"], decode_s=run["decode_s"], edit_and_decode_s=run["edit_s"],
            guided_step_s=run["pass2_s"] / STEPS, launches=run["launches"], pass2_launches=run["pass2_launches"],
            loss_first=losses[0].item(), loss_last=losses[-1].item(), edit_moved_from_source=moved,
            image_means=[float(x.mean()) for x in run["images"]], peak_gib=run["peak_gib"])
    lines["ddim"].update(invert_s=invert_s, image_s=invert_s + runs["ddim"]["edit_s"],
                         image_launches=tuple(a + b for a, b in zip(inv_counts, runs["ddim"]["launches"])),
                         inversion_launches=inv_counts)
    tag = "p2z_path" if model == "sd" else "xl_p2z_path"
    for label, line in lines.items():
        emit(tag, run=label, model=f"{name} (random weights, seed 0)", resolution=side, dtype="bfloat16", steps=STEPS,
             recompute_refs=xl, checkpointed_unet=checkpointed, inversion="DDIM" if label == "ddim" else
             "phase_nti_path's NTI (edit only)", **line, card=card_line())

    # one guided step alone, built as p2z_edit builds it, from the inverted
    # latent: wall ms, device busy ms, idle share; its gradient alone; a
    # forward at CFG batch 2. SD1.5's references are made once (pass 1
    # records them), SDXL's inside the step (recomputed).
    unet, sched, i, lat = common.grad_unet(pipe, side // 8), pipe.scheduler, P2Z_PROBE_STEP, last
    ctx_src, added_src = common.prepare_conditioning(pipe, PROMPTS[:1], side, side)
    ctx, added = common.prepare_conditioning(pipe, PROMPTS[1:], side, side)
    ctx = _step_context(ctx, None, i)
    src_traj = lat.unsqueeze(0).expand(STEPS, *lat.shape)
    recorded = None if xl else p2z.source_records(unet, sched, i, src_traj, ctx_src, None, added_src)

    def references():
        return recorded or p2z.source_records(unet, sched, i, src_traj, ctx_src, None, added_src)

    t = int(sched.timesteps[i])
    step = lambda: p2z.guided_step(unet, sched, i, lat, ctx, references(), sampler.guidance_scale,  # noqa: E731
                                   P2ZConfig().guidance_amount, added)
    ref = references()
    x_in = torch.cat([lat, lat])
    gradient = lambda: p2z.guidance_gradient(unet, x_in, t, ctx, ref, added)  # noqa: E731
    forward = lambda: pipe.unet_apply(x_in, t, ctx, None, added)  # noqa: E731
    with torch.no_grad():
        step_ms, gradient_ms, forward_ms = (cuda_ms(fn, min_ms=500.0, warmup=1) for fn in (step, gradient, forward))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_REPS):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / PROFILE_REPS / 1e3
    if busy == 0:
        raise AssertionError("the profiler recorded no device time")

    def kernel_ms(tag):
        return sum(e.self_device_time_total for e in kernels if tag in e.key) / PROFILE_REPS / 1e3

    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    emit(tag + "_step", step=i, wall_ms=step_ms, device_busy_ms=busy, idle_share=1.0 - busy / step_ms,
         launches=sum(e.count for e in kernels) / PROFILE_REPS, gradient_wall_ms=gradient_ms,
         forward_cfg2_wall_ms=forward_ms, backward_share_est=(gradient_ms - forward_ms) / step_ms,
         flash_fwd_ms=kernel_ms("flash_fwd"), flash_bwd_dq_ms=kernel_ms("bwd_dq"), flash_bwd_dkv_ms=kernel_ms("bwd_dkv"),
         flash_bwd_share_of_busy=(kernel_ms("bwd_dq") + kernel_ms("bwd_dkv")) / busy,
         top=[[e.key[:60], e.self_device_time_total / PROFILE_REPS / 1e3] for e in top], card=card_line())
    return {label: run["launches"] for label, run in runs.items()}, inv_counts


def phase_refiner():
    """img2img through the SDXL refiner at full width, 1024², bf16: strength
    0.3 of a 50-step schedule (15 UNet forwards at CFG batch 2), noise from
    an explicit generator."""
    from image_editing_framework_torch.methods.img2img import img2img
    from image_editing_framework_torch.pipelines import random_pipeline

    t0 = time.perf_counter()
    pipe = random_pipeline("xl-refiner", num_steps=STEPS, dtype=torch.bfloat16, seed=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    image = (np.random.RandomState(2).rand(1024, 1024, 3) * 255).astype(np.uint8)
    sites = pipe.unet.config.num_transformer_blocks
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out, refine_s = timed(lambda: img2img(pipe, image, PROMPTS[0], strength=0.3,
                                          generator=torch.Generator(device="cuda").manual_seed(0)))
    counts = launch_counts()
    start = int(STEPS * (1.0 - 0.3))
    if counts != (sites * (STEPS - start), 0, 0):
        raise AssertionError(f"the refiner launched (forward, dQ, dK/dV) {counts} times, "
                             f"expected {sites} x {STEPS - start} forward")
    if out.shape != (1, 1024, 1024, 3) or out.dtype != np.uint8 or out.std() == 0:
        raise AssertionError(f"refiner output {out.shape} {out.dtype} constant or misshapen")
    emit("refiner", model="SDXL refiner (random weights, seed 0)", resolution=1024, dtype="bfloat16", strength=0.3,
         unet_params=sum(p.numel() for p in pipe.unet.parameters()), unet_forwards=STEPS - start, setup_s=setup_s,
         refine_and_decode_s=refine_s, flash_launches=counts[0], flash_launches_per_forward=sites,
         peak_gib=torch.cuda.max_memory_allocated() / 2**30, image_mean=float(out.mean()), card=card_line())
    return counts[0]


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

    instances = run("device", phase_device)
    worst, sums, bias_sums, enqueue = run("kernels", phase_kernels, gen)
    bwd_worst, bwd_sums, p2z_bwd_sums = run("bwd_kernels", phase_bwd_kernels, gen)
    probe = run("probe", phase_probe)
    run("tiny", phase_tiny)
    launches, unet_ms, bwd_launches, masa_runs, p2z_runs = {}, {}, {}, {}, {}
    for model, prefix in (("sd", ""), ("xl", "xl_")):
        launches[model], unet_ms[model], profile_args = run(prefix + "main_path", phase_main_path, model)
        if model == "sd":
            # the SD1.5 snapshot serves the checkpoint phase and the sweep
            with tempfile.TemporaryDirectory(prefix="ief_checkpoint_", dir=scratch_base(5, "checkpoint_disk")) as tmp:
                launches["checkpoint"], snapshot = run("checkpoint_path", phase_checkpoint_path, profile_args[0], tmp)
                launches["sweep"], sweep_runs = run("sweep_path", phase_sweep_path, tmp, snapshot)
        else:
            launches["xl_checkpoint"] = run("xl_checkpoint_path", phase_xl_checkpoint_path, profile_args[0])
        nti_counts, nti = run(prefix + "nti_path", phase_nti_path, model, profile_args[0])
        bwd_launches[model] = nti_counts[1:]
        run(prefix + "profile", phase_profile, model, *profile_args)
        launches[prefix + "masactrl"], masa_runs[model], inversion = run(
            prefix + "masactrl_path", phase_masactrl_path, model, profile_args[0], nti)
        launches[prefix + "pnp"] = run(prefix + "pnp_path", phase_pnp_path, model, profile_args[0], inversion)
        p2z_runs[model], p2z_inversion = run(prefix + "p2z_path", phase_p2z_path, model, profile_args[0], nti)
        launches[prefix + "p2z"] = p2z_inversion[0] + sum(counts[0] for counts in p2z_runs[model].values())
        del profile_args, nti, inversion  # the next model needs the card's memory
        torch.cuda.empty_cache()
    launches["refiner"] = run("refiner", phase_refiner)
    emit("seconds", **seconds)
    for model in MODELS:
        fwd, bwd = sums[model], bwd_sums[model]["all"]
        emit("share", model=model, flash_ms_per_cfg4_forward=fwd["ms"], unet_forward_cfg4_ms=unet_ms[model],
             flash_share=fwd["ms"] / unet_ms[model], flash_bound_ms_per_cfg4_forward=fwd["bound_ms"],
             sdpa_ms_per_cfg4_forward=fwd["library_ms"], bwd_ms_per_inner_iteration=bwd["ms"],
             bwd_bound_ms_per_inner_iteration=bwd["bound_ms"], bwd_bound_by=bwd["bound_by"],
             sdpa_bwd_ms_per_inner_iteration=bwd["library_ms"], bwd_device_ms_per_inner_iteration=bwd["device_ms"],
             sdpa_bwd_device_ms_per_inner_iteration=bwd["library_device_ms"],
             masactrl_union_flash_ms_per_cfg4_forward=bias_sums[model]["union"]["forward_ms"],
             masactrl_mask_flash_ms_per_cfg4_forward=bias_sums[model]["mask"]["forward_ms"],
             bwd_ms_per_p2z_guided_step=p2z_bwd_sums[model]["all"]["ms"],
             bwd_device_ms_per_p2z_guided_step=p2z_bwd_sums[model]["all"]["device_ms"],
             bwd_bound_ms_per_p2z_guided_step=p2z_bwd_sums[model]["all"]["bound_ms"],
             sdpa_bwd_device_ms_per_p2z_guided_step=p2z_bwd_sums[model]["all"]["library_device_ms"])

    def at(part, *more):
        return {key: part[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms") + more}

    device = ("device_ms", "library_device_ms")  # the backward's, from CUDA-graph replays and the profiler

    tpu = "image_editing_framework_tpu/ops/flash_attention.py"
    work = {"sd": "the 15 self-attention sites an SD1.5 512² NTI gradient flows through, batch 1, bf16 (one inner "
                  "iteration)",
            "xl": "the 69 sites an SDXL 1024² NTI gradient flows through, batch 1, bf16 (one inner iteration)"}
    p2z_work = {"sd": "all 16 self-attention sites of SD1.5 512², CFG batch 2, bf16 (one p2z guided step)",
                "xl": "all 70 sites of SDXL 1024², CFG batch 2, bf16 (one p2z guided step)"}
    bwd = [{
        "name": f"flash_bwd_{kernel}", "route": "cuda", "source": "image_editing_framework_torch/csrc/flash_bwd.cu",
        "replaces": f"{tpu}:{line}", "also_replaces": f"{tpu}:{line_t}",
        "launches": sum(counts[i] for counts in bwd_launches.values())
        + sum(counts[i + 1] for runs in p2z_runs.values() for counts in runs.values()),
        "launches_by_path": {"nti_path": bwd_launches["sd"][i], "xl_nti_path": bwd_launches["xl"][i],
                             "masactrl_path": 0, "xl_masactrl_path": 0, "pnp_path": 0, "xl_pnp_path": 0,
                             "p2z_path": sum(counts[i + 1] for counts in p2z_runs["sd"].values()),
                             "xl_p2z_path": sum(counts[i + 1] for counts in p2z_runs["xl"].values())},
        "max_abs_err": bwd_worst[torch.bfloat16][kernel], "max_abs_err_f32": bwd_worst[torch.float32][kernel],
        **at(bwd_sums["sd"][kernel], *device), "work": work["sd"],
        "at_xl": dict(at(bwd_sums["xl"][kernel], *device), work=work["xl"]),
        "at_p2z": {model: dict(at(p2z_bwd_sums[model][kernel], *device), work=p2z_work[model],
                               whole_backward=at(p2z_bwd_sums[model]["all"], *device))
                   for model in MODELS},
        "plain_and_library": "the whole backward (dq, dk, dv): the plain version and SDPA's backward",
        "design": design,
        "bf16_instances": [{key: r.get(key) for key in ("dp", "bias", "registers", "smem_bytes", "spill_stores",
                                                         "spill_loads")}
                           for r in instances["flash_bwd"] if r["kernel"] == f"flash_bwd_{kernel}_bf16"],
    } for i, (kernel, line, line_t, design) in enumerate((
        ("dq", 387, 540, "bf16: wgmma (S = Q·Kᵀ and dP = dO·Vᵀ SS, P's exponentials while dP runs; dQ += dS·K "
                         "RS with dS from registers, K MN-major), K/V tiles by TMA over rank-4 (D, N, H, B) tensor "
                         "maps into a 2-stage ring on mbarriers, Q/dO resident; one producer warp (it also copies "
                         "the keys' bias), one consumer warpgroup of 64 queries per block, two blocks an SM "
                         "(setmaxnreg 24/232; one at d = 160); 128-key tiles, 64 at d = 160; d = 40 on the "
                         "64-column kernel; no atomics; f32: CUDA cores"),
        ("dkv", 430, 593, "bf16: wgmma (Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ SS; dV += Pᵀ·dO and dK += dSᵀ·Q RS from "
                          "registers, dO and Q MN-major from the same swizzled tile), Q/dO tiles by TMA over rank-4 "
                          "tensor maps into a 2-stage ring on mbarriers with their lse/di slices (copied by the "
                          "producer warp's lanes), K/V resident; one consumer warpgroup of 64 keys per block, two "
                          "blocks an SM (setmaxnreg 24/232; one at d = 160); 64-query tiles, 32 at d = 160; d = 40 "
                          "on the 64-column kernel; no atomics; f32: CUDA cores"),
    ))]
    fwd = {
        "name": "flash_fwd", "route": "cuda", "source": "image_editing_framework_torch/csrc/flash_fwd.cu",
        "replaces": f"{tpu}:76", "also_replaces": f"{tpu}:205",
        "launches": sum(launches.values()),
        "launches_by_path": {"main_path": launches["sd"], "checkpoint_path": launches["checkpoint"],
                             "sweep_path": launches["sweep"], "xl_main_path": launches["xl"],
                             "xl_checkpoint_path": launches["xl_checkpoint"],
                             "masactrl_path": launches["masactrl"], "xl_masactrl_path": launches["xl_masactrl"],
                             "pnp_path": launches["pnp"], "xl_pnp_path": launches["xl_pnp"],
                             "p2z_path": launches["p2z"], "xl_p2z_path": launches["xl_p2z"],
                             "refiner": launches["refiner"]},
        "p2z_launches_by_run": p2z_runs,
        "sweep_launches_by_run": sweep_runs,
        "masactrl_launches_by_run": masa_runs,
        "max_abs_err": worst[torch.bfloat16], "max_abs_err_f32": worst[torch.float32],
        **at(sums["sd"]), "work": "the 16 self-attention sites of one SD1.5 512² UNet forward at CFG batch 4, bf16",
        "at_xl": dict(at(sums["xl"]), work="the 70 sites of one SDXL 1024² UNet forward at CFG batch 4, bf16"),
        "design": "bf16: wgmma (S = Q·Kᵀ SS, O += P·V RS with P from registers, V MN-major), K/V tiles by TMA "
                  "over rank-4 (D, N, H, B) tensor maps into a 2-stage ring on mbarriers, one producer warp, two "
                  "consumer warpgroups of 64 queries (128 per block; one, 64 queries, at d = 160), setmaxnreg "
                  "24/240; 128-key tiles, 64 at d = 160; f32: CUDA cores",
        "at_bias": {model: {variant: dict(at(part), forward_ms=part["forward_ms"], work=(
            f"MasaCtrl's {variant} calls at the {'6 SD1.5' if model == 'sd' else '16 SDXL'} gated sites of one CFG-4 "
            f"UNet forward (BIAS_SHAPES), bf16, with their bias; forward_ms: all the forward's flash calls")) for
            variant, part in per.items()} for model, per in bias_sums.items()},
        "enqueue_us_b1_1024_d64": enqueue,
        "bf16_instances": [{key: r.get(key) for key in ("dp", "bias", "lse", "registers", "smem_bytes",
                                                         "spill_stores", "spill_loads")}
                           for r in instances["flash_fwd"]],
    }
    mma_probe = {
        "name": "mma_probe", "route": "cuda", "source": "image_editing_framework_torch/csrc/mma_probe.cu",
        "replaces": "tools/bench_attn_layouts.py:57", "launches": probe["launches"],
        "max_abs_err": probe["max_abs_err"], "max_err_over_limit": probe["max_err_over_limit"],
        "ms": probe["ms"], "plain_ms": probe["plain_ms"], "bound_ms": probe["bound_ms"], "bound_by": "operations",
        "library_ms": None,
        "work": "one iteration (a 512 x 512 product on every SM at once) of each of the 4 layouts at d = 40, 64, "
                "128; plain_ms: the plain version's one iteration of each, one product",
        "library": "none: no PyTorch call computes a looped product that stores nothing",
        "design": "wgmma SS on 128-byte-swizzled TMA tiles, every layout one form (K-major as stored plain, "
                  "MN-major by the transpose bit as stored transposed; pv_sub as the sum of the transposed "
                  "product, P the 64-row side): scores with b resident and the rescaled a streamed in 64-row "
                  "chunks through a 4-slot ring, the weighted sums with P streamed in 64-deep K chunks (2-3 "
                  "slots) beside the rescaled V; one producer warp issues every copy, one rescale warpgroup "
                  "scales each slot's rescaled piece in place while two consumer warpgroups run wgmma on the "
                  "slots before it, each slot's accumulator summed into a running f32 sum; no atomics, no "
                  "clusters",
        "instances": [{key: r.get(key) for key in ("plan", "ta", "tb", "np", "registers", "spill_stores",
                                                    "spill_loads")} for r in instances["mma_probe"]],
    }
    print(json.dumps({"kernels": [fwd] + bwd + [mma_probe]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
     its paths' shapes (SD1.5's, SDXL's and SD2.1's 768² sites: 9216, 2304,
     576 and 144 tokens, the last two part-filling the last key tile), as
     the head-split views the
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
     at the batched paths' batches: the forward at each group's G and
     CFG-4 x G (2, 3, 8, 12, 16) at every SD1.5 site shape, and bitwise
     equal rows out of a batch of 16 equal rows; the backward at batched
     NTI's 3 and batched p2z's CFG-2 x 2 = 4 at every SD1.5 site and at 4
     at every SDXL site, held with their planted faults;
     probe: the tile-shape probe kernel against its plain version for
     every layout and head dim, every block's value, then its timed table
     through the tool's entry point;
  3. tiny: the tiny pipeline's invert + P2P edit, and its null-text
     inversion + edit, on the card against the same pipeline on the CPU (the
     kernels' plain versions); the same for the tiny SDXL pipeline, its NTI
     with and without the checkpointed UNet; on both, MasaCtrl (mutual,
     union, mask, auto mask, direction), PnP and pix2pix-zero, whose guided
     steps never synchronise; the batched editors (``eval/batched.py``, a
     group of 2: P2P replace and refine in one group, MasaCtrl mutual and
     union, PnP, p2z with recorded and recomputed references, direct
     inversion, NTI embeddings; batched NTI of a group of 3 that stops at
     different inner iterations; XL P2P) on the card against the CPU and
     against each image alone on the card;
  4. main path: SD1.5 at full width (random weights from a seed), 512²,
     bf16 — image2latent, 50-step DDIM inversion, 50-step P2P replace edit
     with LocalBlend at CFG batch 4, decode — with the launch counts of
     every kernel read around it (forward only);
     checkpoint path: the reference's entry points on a checkpoint: the
     main path's weights written as an HF snapshot (fp16, with a synthetic
     49408-entry CLIP BPE vocab) and as an LDM single file, named through
     ``sd_mapping.sd_maps`` ("1.5", "ghostv2") and loaded by
     ``cli.load_pipe`` (timed per component; the two loads bitwise equal),
     then the pipeline cache (``registry.save_pipeline_cache``) of the
     load restored into a fresh random pipeline, bitwise; ``shims`` p2p
     ``edit_real`` (DDIM) on a 512² PNG and p2p ``edit_syn``, exact launch
     counts, the PNGs read back;
     sweep path: the PIE-Bench sweep (``shims`` p2p ``test``) from that
     snapshot over a mini PIE of 512² JPEGs (three items in the default
     categories, one outside): with ``--save_inversions``, again (resume),
     and from the cache (``--inversion_path``), and batched
     (``--batch_size 3``: one group, the launches of one image), exact launch
     counts, the PNGs, event log and stats read back, the cache's edits held
     to the first run's;
     serve path: the editing service (``serve.py EditService.poll_once``)
     on the same snapshot, loaded by ``cli.load_pipe``: a spool of four P2P
     real-image requests (one group of 4), two MasaCtrl ones (a group of 2),
     a synthesis request, a bad method and a torn file, polled until
     drained; the first request again alone; each group's exact launches
     (those of one image), the answers, the groups, the PNGs, the torn
     file's rejection;
     grad groups path: the gradient paths' groups on the same snapshot, on
     a 10-step schedule: the service's pix2pix-zero DDIM group of 2 and P2P
     null-text group of 2, and a pix2pix-zero request alone (exact
     launches: the p2z group one image's, the null-text group one image's
     inversion and edit and each image's NTI); batched NTI of a group of 3
     whose images stop apart at step 0 (a stopped image's embedding frozen
     bit for bit), P2P and p2z ``edit_batch`` on its embeddings; the
     group's f32 guided step against each image's alone (1e-3 ·
     max|ref|);
     launcher path: two processes of ``tools/launch_distributed_sweep.py
     --random_weights --num_steps 10`` at once, shards 0 and 1 of 2 over a
     mini PIE into one ``--exp_path``: exit codes, the shards' partition,
     every item's PNGs, both stats files;
     validation path: the validation runway (``eval/validate.py main``) on
     the same snapshot with a seeded random CLIP checkpoint and LPIPS file:
     all four methods on the synthesized source image, 10 steps, its
     report's hashes, metrics and exact launches, the CLIP and LPIPS towers
     on the card against the same towers on the CPU, then P2P again through
     the port's ``tools/golden_check.py`` against the runway's report;
  5. nti path: the same model and edit through null-text inversion
     (``cli.invert(..., "null-text")``, 50 steps of ``SD_INNER_STEPS`` (2)
     Adam iterations, each a UNet forward and backward), the edit taking the
     per-step embeddings; launch counts of every kernel read around it;
  6. profile: one UNet forward at the edit's and the inversion's batch under
     torch.profiler: device busy time, idle share, launches, top kernels;
     on SD1.5 also ``utils/profiling.py``: one CFG-4 forward under
     ``phase`` inside ``trace``, timed by ``Timer``, the written trace
     naming the phase and the flash forward kernel;
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
     img2img through ``eval/validate.py validate_refiner``) and runs the
     p2p shim's ``edit_real`` at 1024² (the NTI path
     with ``XL_INNER_STEPS`` inner iterations per step and the checkpointed
     UNet; p2z with the references recomputed from pass 1's trajectory and
     the checkpointed UNet, the XL defaults, both of its edits over every
     5th step, as SD1.5's), decode full-frame and tiled; then
     xl p2z group path: a batched pix2pix-zero group of 2 through
     ``edit_batch("p2z", ...)`` on the 10-step schedule (CFG batch 4 through
     the checkpointed UNet): exact launches, finite latents, the peak;
  10. sd21 path: SD2.1 at full width from a converted single file: the
     weights of ``random_pipeline("2.1")`` written as an fp16 LDM single
     file (OpenCLIP-H with a 24th resblock, as real SD2.x files carry),
     converted by the port's ``tools/convert_checkpoint.py --family sd21``
     in a subprocess, loaded by ``cli.load_pipe("2.1")`` (bitwise the fp16
     values written), then the main path at 768² through ``cli.invert`` and
     ``cli.run_method("p2p")`` (800 + 800 launches), and the NTI path on
     the loaded pipe cut as SDXL's (10 steps, 1 inner iteration a step);
  11. refiner: img2img through the SDXL refiner at 1024², strength 0.3;
  12. cp path: context parallelism (``parallel/ring_attention.py``) on
     rank processes of their own, a group of 4 and then one of 2, over
     gloo on one card (NCCL with a card per rank where there are enough):
     (a) the ring, Ulysses and 2D attention at SDXL's and SD1.5's
     4096-token sites (bf16 and f32, MasaCtrl's union at 8192 keys with its
     segment bias, a shard of NEG_INF keys) against the unsharded forward
     kernel and the plain version, the ring's backward at batch 1 and 2
     against the unsharded backward kernels and the plain version with two
     planted faults rejected, launches per rank exact, times per site;
     (b) one SDXL 1024² CFG-4 UNet forward in f32 with the ring and with
     Ulysses against the same forward without CP (weights equal across
     ranks by checksum); (c) the SDXL main path under the ring on the
     10-step schedule of ``xl_nti_path`` (DDIM
     inversion, P2P replace edit, decode through ``cli.invert`` /
     ``cli.run_method``, 80 launches per UNet forward), its images equal
     on both ranks; (d) tensor parallelism (``parallel/sharding.py``) on a
     data 1 x tensor 2 mesh of the same 2 ranks: (b)'s f32 SDXL UNet split
     in place, the same forward within 1e-3 · max|ref| (70 launches); an
     SD1.5 512² f32 CFG-4 forward under a P2P refine control with
     LocalBlend (eps and the blend's records within 1e-3 · max|ref|, the
     prompt encode under a split text tower within 1e-4, 16 launches); one
     ``make_sharded_train_step`` step on an SD1.5 UNet at batch 2 (loss and
     gradients within 1e-3 · max|ref| of the unsharded step, 16 / 16 / 16
     launches); the ranks' outputs, records, losses and replicated weights
     bitwise equal; then on the same split SD1.5 pipe an f32 p2z guided
     step's gradient against the unsharded one (1e-3 · max|ref|, the
     recorded maps' heads gathered under autograd), and, cast to bf16, NTI
     (2 inner iterations a step, its stop in lockstep over the tensor mesh)
     and p2z on a 10-step schedule; (e) NTI and pix2pix-zero under the ring:
     on (b)'s module, f32 gradients of a random projection of the output
     with respect to the latent and the context through the checkpointed
     UNet at batch 1 and 2 against unsharded (1e-3 · max|ref|), and on (c)'s
     pipe and inversion NTI over 5 steps and ``cli.run_method("p2z")`` over
     its 10, exact launches per rank, the ranks' gradients, embeddings,
     stops and images bitwise equal;
then each phase's seconds, the kernels JSON line, the card line, and the
result line last.
"""

from __future__ import annotations

import contextlib
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
    # SD2.1 at 768²: 576 = 4.5 x 128 and 144 = 128 + 16 tokens leave the
    # forward's last query block and key tile part filled (and 144 is off
    # the backward's 64-row tiles); no 256-token site
    "sd21": [(9216, 64, 5, 5), (2304, 64, 10, 5), (576, 64, 20, 5), (144, 64, 20, 1)],
}
# the sites NTI's gradient flows through (the first site sees no embedding)
GRAD_SHAPES = {
    "sd": [(4096, 40, 8, 4), (1024, 80, 8, 5), (256, 160, 8, 5), (64, 160, 8, 1)],
    "xl": [(4096, 64, 10, 9), (1024, 64, 20, 60)],
    "sd21": [(9216, 64, 5, 4), (2304, 64, 10, 5), (576, 64, 20, 5), (144, 64, 20, 1)],
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
# the batched editors' groups (eval/batched.py folds G images into the batch):
# the service's group of 4 (CFG batch 16), the batched sweep's group of 3,
# batched NTI's group of 3 (batch 3), batched p2z's group of 2 (CFG batch 4)
SERVE_GROUP = 4
SWEEP_GROUP = 3
NTI_GROUP = 3
P2Z_GROUP = 2
SITES = {model: sum(shape[3] for shape in shapes) for model, shapes in PATH_SHAPES.items()}
GRAD_SITES = {model: sum(shape[3] for shape in shapes) for model, shapes in GRAD_SHAPES.items()}
SOURCES = ("flash_fwd", "flash_bwd", "mma_probe")
HEADS = 8  # of the edge cases
# NTI inner iterations per step on the XL path (the default is 10); 1 since
# the p2z paths joined the script, to keep it within half its time limit
XL_INNER_STEPS = 1
# ... and over every 5th step of the 50 (a 10-step schedule for its DDIM
# inversion, NTI and edit) since cp_path joined: a depth cut that keeps the
# script inside its time limit on slower hosts
XL_NTI_STRIDE = 5
# ... on the SD1.5 path: 2 since the serve path joined (random weights never
# stop early, so J = 2 · 50)
SD_INNER_STEPS = 2
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


def group_batches():
    """The flash forward's batches on the batched paths (eval/batched.py
    folds G images into the batch): each group's inversion at G and its
    CFG-4 edit at 4G, for the service's groups of SERVE_GROUP and
    len(MASA_GROUP) and the batched sweep's of SWEEP_GROUP; less the batches
    1 and 4 that the earlier paths give."""
    groups = (SERVE_GROUP, len(MASA_GROUP), SWEEP_GROUP)
    return sorted({m * g for g in groups for m in (1, 4)} - {1, 4})


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
    # the batched paths' groups at every SD1.5 site shape (1 and 4 are held above)
    for b in group_batches():
        for n, d, h, _ in PATH_SHAPES["sd"]:
            check(torch.bfloat16, b, h, n, n, d, model="sd")
    # a batch whose rows are all equal gives bitwise-equal rows: the kernel's
    # result does not depend on a row's place in the batch
    b = max(group_batches())
    for n, d, h, _ in PATH_SHAPES["sd"]:
        q, k, v = (split_heads(torch.randn(1, n, h * d, device="cuda", dtype=torch.bfloat16, generator=gen)
                               .expand(b, -1, -1).contiguous(), h) for _ in range(3))
        out = fa.flash_attention(q, k, v)
        unequal = [i for i in range(1, b) if not torch.equal(out[i], out[0])]
        if unequal:
            raise AssertionError(f"flash forward at batch {b}, {n} tokens, d = {d}: rows {unequal} of equal inputs "
                                 f"differ from row 0 by up to {(out.float() - out[:1].float()).abs().max().item()}")
        emit("rows_equal", kernel="flash_fwd", dtype="bfloat16", shape=[b, h, n, n, d], equal=True)
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

    def check(dtype, b, h, nq, nk, d, bias=None, timed=False, sites=0, zero_batch=None, model=None, into=sums,
              faults=False):
        """Path shapes (``model`` given) come as the UNet and autograd give
        them: head-split views of (B, N, H·D) tensors, dO included; the edge
        cases as contiguous tensors. A timed bf16 check, and one with
        ``faults``, also reads the planted faults, which its limits must
        reject."""
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
        if (timed or faults) and dtype == torch.bfloat16:
            row["faults"] = readings = bwd_fault_readings(q, k, v, do, ref_o, ref_lse, ref)
            passed = [name for name, reads in readings.items() if not any(e > tols[out] for out, e in reads.items())]
            if passed:
                raise AssertionError(f"the bf16 limits {tols} do not reject the planted faults {passed}: {readings}")
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
            if model not in MODELS:
                continue  # the script runs p2z on SD1.5 and SDXL only
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
    # the batched gradients' batches, each with its planted faults: batched
    # NTI's group of NTI_GROUP at every site its gradient reaches, batched
    # p2z's CFG-2 x P2Z_GROUP at all (SD1.5's and SDXL's)
    for batch, model, shapes in ((NTI_GROUP, "sd", GRAD_SHAPES["sd"]), (P2Z_BATCH * P2Z_GROUP, "sd", PATH_SHAPES["sd"]),
                                 (P2Z_BATCH * P2Z_GROUP, "xl", PATH_SHAPES["xl"])):
        for n, d, h, _ in shapes:
            check(torch.bfloat16, batch, h, n, n, d, model=model, faults=True)
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


TINY_PAIRS = [["a cat sitting on the grass", "a dog sitting on the grass"],  # replace
              ["a cat sitting on the grass", "a white cat sitting on the grass"]]  # refine
TINY_NTI_SCALES = (0.05, 0.2, 1.0)  # of the group's start latents: the three images' losses spread
TINY_NTI_EPSILON = 0.05  # between them at step 0: the images stop after 3, 3 and 1 inner iterations
TINY_NTI_STOPS = [3, 3, 1]


def tiny_batched(pipe, model_type, alone=True):
    """The batched editors (``eval/batched.py``) on the tiny pipeline, a
    group of 2, and the same images one at a time on the same device. SD:
    P2P (replace and refine in one group), MasaCtrl mutual and union, PnP,
    pix2pix-zero with recorded and with recomputed references, P2P on a
    batched DDIM inversion with each image's trajectory replayed (direct),
    batched null-text inversion of a group of 3 whose images stop at
    different inner iterations, and P2P on its embeddings; XL: P2P.
    Returns ({name: (the group's final latents (G, 2, h, w, 4), each image
    alone's), on the CPU}, {"nti": (the group's embeddings, each image
    alone's)}, the group's NTI stops); each image alone's is None without
    ``alone``."""
    from image_editing_framework_torch.core.config import MasaCtrlConfig, NTIConfig, P2PConfig, P2ZConfig, \
        SamplerConfig
    from image_editing_framework_torch.eval import batched
    from image_editing_framework_torch.inversion import nti
    from image_editing_framework_torch.methods.masactrl import masactrl_edit
    from image_editing_framework_torch.methods.p2p import p2p_edit
    from image_editing_framework_torch.methods.p2z import p2z_edit
    from image_editing_framework_torch.methods.pnp import pnp_edit

    xl = model_type == "xl"
    # the serial editors take the XL time ids from the sampler, the batched
    # ones from the latents (16 · 8)
    sampler = SamplerConfig(height=128, width=128) if xl else SamplerConfig(height=32, width=32)
    rng = np.random.RandomState(7)
    lats = torch.from_numpy(rng.randn(2, 1, 16, 16, 4).astype(np.float32)).to(pipe.device)
    cfgs = [P2PConfig(edit_type="replace"), P2PConfig(edit_type="refine")]
    masa = MasaCtrlConfig(start_step=1, start_layer=4 if xl else 2)
    finals, decode = [], pipe.latent2image

    def recording_decode(lat, **kw):
        finals.append(lat.cpu())
        return decode(lat, **kw)

    def run(group, singles):
        """(the group's final latents, each image's or None)."""
        finals.clear()
        group()
        out = finals[0].reshape((2, 2) + tuple(finals[0].shape[1:]))
        if not alone:
            return out, None
        finals.clear()
        for i in range(2):
            singles(i)
        return out, torch.cat(finals).reshape(out.shape)

    edits = {"p2p": (lambda: batched.p2p_edit_batch(pipe, TINY_PAIRS, lats, cfgs),
                     lambda i: p2p_edit(pipe, TINY_PAIRS[i], lats[i], cfgs[i], sampler))}
    if not xl:
        inverted, trajs = batched.ddim_invert_batch(pipe, lats * 0.1, [p[0] for p in TINY_PAIRS],
                                                    return_trajectory=True)
        for mode in ("mutual", "union"):
            c = dataclasses.replace(masa, mode=mode)
            edits["masactrl_" + mode] = (lambda c=c: batched.masactrl_edit_batch(pipe, TINY_PAIRS, lats, c),
                                         lambda i, c=c: masactrl_edit(pipe, TINY_PAIRS[i], lats[i], c, sampler))
        edits["pnp"] = (lambda: batched.pnp_edit_batch(pipe, TINY_PAIRS, lats),
                        lambda i: pnp_edit(pipe, TINY_PAIRS[i], lats[i], sampler=sampler))
        for name, c in (("p2z", P2ZConfig()), ("p2z_recompute", P2ZConfig(recompute_refs=True))):
            edits[name] = (lambda c=c: batched.p2z_edit_batch(pipe, TINY_PAIRS, lats, c),
                           lambda i, c=c: p2z_edit(pipe, TINY_PAIRS[i], lats[i], c, sampler))
        edits["direct"] = (
            lambda: batched.p2p_edit_batch(pipe, TINY_PAIRS, inverted, cfgs, source_replays=trajs),
            lambda i: p2p_edit(pipe, TINY_PAIRS[i], inverted[i], cfgs[i], sampler, source_replay=trajs[i]))
    out, seqs, stops = {}, {}, None
    pipe.latent2image = recording_decode
    try:
        for name, (group, singles) in edits.items():
            out[name] = run(group, singles)
        if not xl:
            prompts = [p[0] for p in TINY_PAIRS] + [TINY_PAIRS[1][1]]
            scales = torch.tensor(TINY_NTI_SCALES, device=pipe.device)[:, None, None, None, None]
            lats3 = torch.from_numpy(np.random.RandomState(2).randn(3, 1, 16, 16, 4).astype(np.float32))
            inv3, trajs3 = batched.ddim_invert_batch(pipe, lats3.to(pipe.device) * scales, prompts,
                                                     return_trajectory=True)
            cfg = NTIConfig(num_inner_steps=3, epsilon=TINY_NTI_EPSILON)
            useq, stops = batched.nti_batch(pipe, trajs3, prompts, cfg, return_stops=True)
            context, _ = pipe.encode_prompts(prompts)
            seqs["nti"] = (useq.cpu(), torch.stack([
                nti.null_text_inversion(pipe, trajs3[i], torch.stack([context[i], context[3 + i]]), cfg)
                for i in range(3)]).cpu() if alone else None)
            out["nti_edit"] = run(
                lambda: batched.p2p_edit_batch(pipe, TINY_PAIRS, inv3[:2], cfgs, uncond_seqs=useq[:2]),
                lambda i: p2p_edit(pipe, TINY_PAIRS[i], inv3[i], cfgs[i], sampler, uncond_seq=useq[i]))
    finally:
        del pipe.latent2image
    return out, seqs, stops


def phase_tiny():
    """Tiny pipelines on the card (f32 kernels, head dims 16 and 32) against
    the same weights on the CPU (plain versions). SD: invert + P2P edit with
    LocalBlend, and null-text inversion (4 steps, 2 inner iterations) + the
    edit with its embeddings. SDXL: invert + P2P edit, and XL null-text
    inversion with and without the checkpointed UNet. Both: MasaCtrl
    (mutual, union, mask, auto mask, direction) and PnP (``tiny_edits``);
    their steps never synchronise (``controls_sync_free``); the batched
    editors (``tiny_batched``) against the CPU and against each image
    alone on the card."""
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
        # the batched editors: card against CPU, and the group against each
        # image alone on the card (both backward kernels run batched here:
        # batched NTI at batch 3, batched p2z at CFG batch 4)
        (cpu_b, cpu_seqs, cpu_stops), (gpu_b, gpu_seqs, gpu_stops) = (
            tiny_batched(cpu, model_type, alone=False), tiny_batched(gpu, model_type))
        batch_errs = {k: (cpu_b[k][0] - gpu_b[k][0]).abs().max().item() for k in cpu_b}
        batch_errs.update({k: (cpu_seqs[k][0] - gpu_seqs[k][0]).abs().max().item() for k in cpu_seqs})
        alone_errs = {k: (v[0] - v[1]).abs().max().item() for k, v in list(gpu_b.items()) + list(gpu_seqs.items())}
        stops_ok = cpu_stops == gpu_stops and (model_type == "xl" or gpu_stops[0] == TINY_NTI_STOPS)
        if len(batch_errs) != (9 if model_type == "sd" else 1) or not stops_ok or not all(
                e < 1e-3 for e in list(batch_errs.values()) + list(alone_errs.values())):
            raise AssertionError(f"tiny {model_type} batched editors: card vs CPU {batch_errs}, group vs each image "
                                 f"alone on the card {alone_errs}, NTI stops card {gpu_stops} CPU {cpu_stops}")
        fields = dict(max_abs_err=errs[0], nti_edit_max_abs_err=errs[1], nti_embedding_max_abs_err=errs[2], tol=1e-3,
                      masactrl_pnp_max_abs_err=edit_errs, masactrl_pnp_target_max_abs_err=target_errs,
                      auto_mask_margin=gap, p2z_max_abs_err=edit_errs["p2z"], p2z_sync_free=p2z_sync,
                      batched_max_abs_err=batch_errs, batched_vs_alone_max_abs_err=alone_errs,
                      nti_batch_stops=gpu_stops)
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

    return fa.launch_counts()


def reset_launch_counts():
    from image_editing_framework_torch.ops import flash_attention as fa

    fa.flash_attention.launches = fa.flash_bwd_dq.launches = fa.flash_bwd_dkv.launches = 0


# per model: (sd_version, name, image side, context width)
MODELS = {"sd": ("1.5", "SD1.5", 512, 768), "xl": ("xl", "SDXL base", 1024, 2048)}
# SD2.1 at the registry's 768², which sd21_path runs from a converted single file
FAMILIES = dict(MODELS, sd21=("2.1", "SD2.1", 768, 1024))
PREFIX = {"sd": "", "xl": "xl_", "sd21": "sd21_"}  # of each model's phase tags
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


def to_ldm_single_file_21(pipe):
    """An SD2.x pipeline's weights under the LDM single-file keys: UNet,
    VAE, and the OpenCLIP-H tower in OpenCLIP's layout as
    ``cond_stage_model.model.*`` with the 24th resblock a real SD2.x file
    carries (``OPEN_CLIP_VIT_H`` runs 23; the loader ignores the 24th): here
    a copy of the 23rd's tensors."""
    text = dict(pipe.text_encoder.state_dict())
    last = pipe.text_encoder.config.num_layers - 1
    prefix = f"text_model.encoder.layers.{last}."
    text.update({f"text_model.encoder.layers.{last + 1}.{k[len(prefix):]}": v for k, v in list(text.items())
                 if k.startswith(prefix)})
    return {**to_ldm_unet(pipe.unet.state_dict(), pipe.unet.config),
            **to_ldm_vae(pipe.vae.state_dict(), pipe.vae.config),
            **to_open_clip(text, "cond_stage_model.model.")}


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

    from image_editing_framework_torch.models.loader import save_safetensors

    nbytes = 0
    for sub, module, name in parts:
        os.makedirs(os.path.join(directory, sub))
        extra = clip_position_ids() if sub.startswith("text_encoder") else {}
        nbytes += save_safetensors(dict(module.state_dict(), **extra),
                                   os.path.join(directory, sub, name + ".safetensors"), torch.float16)
    for sub in tokenizers:
        write_tokenizer(os.path.join(directory, sub), vocab, merges)
    return nbytes


def write_single_file(state, directory, vocab, merges):
    """One LDM single file ``directory/model.safetensors`` (fp16) with the
    tokenizer beside it. Returns (path, bytes of tensor data)."""
    import os

    from image_editing_framework_torch.models.loader import save_safetensors

    os.makedirs(directory)
    path = os.path.join(directory, "model.safetensors")
    nbytes = save_safetensors(state, path, torch.float16)
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


def pipeline_cache_round_trip(pipe, cache_dir):
    """``registry.save_pipeline_cache`` of the loaded ``pipe``, restored into
    a fresh random pipeline (another seed) by ``restore_pipeline_cache``:
    every tensor bitwise equal. Returns the seconds and the bytes."""
    import os

    from image_editing_framework_torch.models import registry
    from image_editing_framework_torch.pipelines import random_pipeline

    _, save_s = timed(lambda: registry.save_pipeline_cache(pipe, cache_dir))
    fresh = random_pipeline(MODELS["sd"][0], num_steps=STEPS, dtype=pipe.dtype, seed=1, device=pipe.device)
    _, restore_s = timed(lambda: registry.restore_pipeline_cache(fresh, cache_dir))
    differ = [f"{name}.{key}" for name in ("unet", "vae", "text_encoder")
              for key, value in getattr(fresh, name).state_dict().items()
              if not torch.equal(value, getattr(pipe, name).state_dict()[key])]
    if differ:
        raise AssertionError(f"the restored pipeline cache differs in {len(differ)} tensors: {differ[:5]}")
    del fresh
    torch.cuda.empty_cache()
    files = sorted(os.listdir(cache_dir))
    return dict(save_s=save_s, restore_s=restore_s, files=files, bitwise_equal=True,
                gb=sum(os.path.getsize(os.path.join(cache_dir, f)) for f in files) / 1e9)


def phase_checkpoint_path(pipe, tmp):
    """The reference's own entry points on a checkpoint, SD1.5 at full
    width, bf16: ``pipe``'s weights (``random_pipeline("1.5", seed=0)``)
    written into ``tmp`` as an HF snapshot and as an LDM single file, named
    through ``sd_mapping.sd_maps`` ("1.5" and "ghostv2"), loaded by
    ``cli.load_pipe`` (timed per component; the two loads bitwise equal, and
    equal to the weights through fp16), then ``shims`` p2p ``edit_real``
    (DDIM inversion) on a 512² PNG the phase writes and p2p ``edit_syn``,
    each with its exact flash-forward launches, PNGs read back; between
    them, the pipeline cache of the snapshot load saved and restored into a
    fresh pipeline, bitwise (``pipeline_cache_round_trip``). Returns the
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
        cache = pipeline_cache_round_trip(loaded, os.path.join(tmp, "pipeline_cache"))
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
         edit_real=runs["edit_real"], edit_syn=runs["edit_syn"], pipeline_cache=cache,
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
SWEEP_TAIL_KEYS = {"p50_s_per_image", "p95_s_per_image", "max_s_per_image"}
SWEEP_DONE_KEYS = SWEEP_STATS_KEYS | {"recon_mse_mean", "recon_psnr_mean", "recon_ssim_mean"} | SWEEP_TAIL_KEYS


def phase_sweep_path(root, snapshot):
    """The reference's third entry point, the PIE-Bench sweep, on the SD1.5
    snapshot ``phase_checkpoint_path`` wrote into ``root``, bf16, 512²: a
    mini PIE (``SWEEP_PIE``, 512² JPEGs) and three runs of ``shims`` p2p
    ``test``: (a) with ``--save_inversions``, (b) the same command again
    (resume: every image skipped), (c) from (a)'s cache
    (``--inversion_path``) into another ``--exp_path``, (d) the batched
    sweep (``--batch_size 3``: the three items as one group) into a third.
    Each run's exact flash-forward launches (a group launches what one image
    launches); its PNGs read back (512² uint8, not constant);
    its event log strict JSON with finite reconstruction metrics; its stats
    file's keys; (c)'s images against (a)'s (the cache gives back the same
    bf16 latent, so within one level); (d)'s images against (a)'s in
    levels, a reading; seconds per image beside ``main_path``'s."""
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
    exp = {label: os.path.join(root, "exp_" + label) for label in "acd"}
    sites = SITES["sd"]
    # (d): the three items as one group of the batched sweep, which launches
    # what one image launches
    plan = (("a", exp["a"], ["--save_inversions", cache], 3, sweep_launches(sites, 3, STEPS, False)),
            ("b", exp["a"], [], 0, 0),
            ("c", exp["c"], ["--inversion_path", cache], 3, sweep_launches(sites, 3, STEPS, True)),
            ("d", exp["d"], ["--batch_size", str(SWEEP_GROUP)], SWEEP_GROUP, sweep_launches(sites, 1, STEPS, False)))
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
            if label == "d":  # its one group is the warm-up, which the steady-state stats leave out
                keys = keys - SWEEP_TAIL_KEYS
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
    # the batched run against the serial one: bf16 GEMMs at another batch may
    # round otherwise, so this is a reading, not a gate
    batched_levels = {name: {"max": max(int(np.abs(images["d", key, name].astype(np.int32)
                                                   - images["a", key, name].astype(np.int32)).max()) for key in work),
                             "mean": float(np.mean([np.abs(images["d", key, name].astype(np.int32)
                                                           - images["a", key, name].astype(np.int32)).mean()
                                                    for key in work]))}
                      for name in ("source", "inversion", "edit")}
    emit("sweep_path", model="SD1.5 (random weights, seed 0, from the fp16 snapshot, bf16)", resolution=side,
         dtype="bfloat16", steps=STEPS, items=work, runs=runs, cache_vs_inversion_max_levels=levels,
         batched_vs_serial_levels=batched_levels,
         mean_s_per_image={k: r["mean_s_per_image"] for k, r in runs.items()},
         p50_s_per_image={k: r.get("p50_s_per_image") for k, r in runs.items()},
         main_path_image_s=EMITTED["main_path"]["image_s"], card=card_line())
    return sum(r["flash_launches"] for r in runs.values()), {k: r["flash_launches"] for k, r in runs.items()}


# the service's spool: name -> (method, source prompt, target prompt, has an
# image); four P2P requests (two replace pairs, two refine) make one group of
# SERVE_GROUP, two MasaCtrl requests one of 2; a synthesis request and a bad
# method run alone
SERVE_SPOOL = {
    "p2p_0": ("p2p", "a cat sitting on the grass", "a dog sitting on the grass", True),
    "p2p_1": ("p2p", "a dog sitting on the grass", "a cat standing on the grass", True),
    "p2p_2": ("p2p", "a cat sitting on the grass", "a white cat sitting on the grass", True),
    "p2p_3": ("p2p", "a dog sitting on the grass", "a small dog sitting on the grass", True),
    "masa_0": ("masactrl", "a cat sitting on the grass", "a cat standing on the grass", True),
    "masa_1": ("masactrl", "a dog sitting on the grass", "a dog standing on the grass", True),
    "syn": ("p2p", "a cat sitting on the grass", "a dog sitting on the grass", False),
    "nope": ("nope", "a cat", "a dog", False),
}


P2P_GROUP = ("p2p_0", "p2p_1", "p2p_2", "p2p_3")
# the service's schedule: 10 steps since the gradient paths' groups joined
# the script (a cut in depth: a group's launches are one image's per step)
SERVE_STEPS = 10
MASA_GROUP = ("masa_0", "masa_1")


def load_snapshot(snapshot):
    """(the SD1.5 snapshot ``phase_checkpoint_path`` wrote, loaded by
    ``cli.load_pipe("1.5")`` in bf16, the load's seconds)."""
    from image_editing_framework_torch import cli, sd_mapping

    saved = dict(sd_mapping.sd_maps)
    try:
        sd_mapping.sd_maps["1.5"] = snapshot
        return timed(lambda: cli.load_pipe("1.5"))
    finally:
        sd_mapping.sd_maps.clear()
        sd_mapping.sd_maps.update(saved)


def served_response(svc, name):
    import os

    with open(os.path.join(svc.results_dir, name, "response.json")) as f:
        return json.load(f)


def served_calls(svc):
    """Each group's or request's launches, seconds and NTI inner iterations,
    read around its call on the polling thread: {names: (launches, seconds,
    inner iterations)}."""
    from image_editing_framework_torch.inversion import nti

    calls, handle_batch, handle = {}, svc.handle_batch, svc.handle

    def read(key, fn, *args, **kw):
        before, inner, start = launch_counts(), nti.null_text_inversion.inner_iterations, time.perf_counter()
        try:
            out, _ = timed(lambda: fn(*args, **kw))
        finally:  # a request that fails counts too
            calls[key] = (tuple(a - b for a, b in zip(launch_counts(), before)), time.perf_counter() - start,
                          nti.null_text_inversion.inner_iterations - inner)
        return out

    svc.handle_batch = lambda names, *a, **kw: read(tuple(names), handle_batch, names, *a, **kw)
    svc.handle = lambda name, *a, **kw: read((name,), handle, name, *a, **kw)
    return calls


def phase_serve_path(root, snapshot):
    """The editing service, the system's production entry point
    (``serve.py EditService.poll_once``), on the SD1.5 snapshot
    ``phase_checkpoint_path`` wrote into ``root``, loaded by
    ``cli.load_pipe`` in bf16, 512², ``SERVE_STEPS`` steps: a spool of ``SERVE_SPOOL``
    (smooth seeded 512² PNGs, DDIM inversion, the synthesis request at seed
    7) and one torn request file, polled until drained with
    ``max_batch=SERVE_GROUP``; then the first P2P request alone on a service
    with ``max_batch=1``. Gates: every answer "ok" but the bad method's and
    the torn file's, the torn file rejected after ``PARSE_RETRIES`` + 1
    polls with its bytes kept, groups of 4 and 2, every PNG 512² uint8, and
    each group's exact flash-forward launches: those of one image of its
    method. Readings: seconds per poll and request, the group's time per
    image beside the solo request's, and the grouped request's images
    against the solo ones (bf16 GEMMs at another batch may round
    otherwise)."""
    import os

    from PIL import Image

    from image_editing_framework_torch.serve import EditService

    from image_editing_framework_torch.core.scheduler import make_ddim_schedule

    side = MODELS["sd"][2]
    pipe, load_s = load_snapshot(snapshot)
    pipe.scheduler = make_ddim_schedule(SERVE_STEPS)
    rng = np.random.RandomState(11)
    inputs = os.path.join(root, "service_inputs")
    os.makedirs(inputs)

    def request(svc, name):
        method, source, target, real = SERVE_SPOOL[name]
        req = dict(method=method, source_prompt=source, target_prompt=target, image_path=None)
        if real:
            req.update(image_path=os.path.join(inputs, name + ".png"), inversion_type="ddim")
            if not os.path.exists(req["image_path"]):
                grid = Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8))
                grid.resize((side, side), Image.BICUBIC).save(req["image_path"])
        else:
            req["seed"] = 7
        with open(os.path.join(svc.requests_dir, name + ".json"), "w") as f:
            json.dump(req, f)

    response = served_response

    def png(svc, name, f):
        return png_of(os.path.join(svc.results_dir, name), f, side, f"served {name}/")

    svc = EditService(pipe, os.path.join(root, "service"), max_batch=SERVE_GROUP)
    solo = EditService(pipe, os.path.join(root, "service_solo"), max_batch=1)
    try:
        for name in SERVE_SPOOL:
            request(svc, name)
        torn = os.path.join(svc.requests_dir, "torn.json")
        with open(torn, "w") as f:
            f.write('{"method": "p2p", "source_prompt": "a cat')
        calls = served_calls(svc)
        reset_launch_counts()
        polls = []
        while any(f.endswith(".json") for f in os.listdir(svc.requests_dir)):
            if len(polls) > svc.PARSE_RETRIES:
                raise AssertionError(f"the spool is not drained after {len(polls)} polls")
            handled, poll_s = timed(svc.poll_once)
            polls.append(dict(handled=handled, seconds=poll_s))
        poll_launches = launch_counts()
        # the first P2P request again, alone
        request(solo, "p2p_0")
        solo_calls = served_calls(solo)
        reset_launch_counts()
        solo_handled, solo_s = timed(solo.poll_once)

        # a group launches what one image does; a synthesis inverts nothing,
        # as an item from the cache
        real, synthesis = (sweep_launches(SITES["sd"], 1, SERVE_STEPS, cached) for cached in (False, True))
        expected = {P2P_GROUP: (real, 0, 0), MASA_GROUP: (real, 0, 0), ("syn",): (synthesis, 0, 0),
                    ("nope",): (0, 0, 0)}
        got = {key: launches for key, (launches, _, _) in calls.items()}
        if got != expected or poll_launches != tuple(map(sum, zip(*expected.values()))):
            raise AssertionError(f"served launches (forward, dQ, dK/dV) {got}, the poll {poll_launches}; expected "
                                 f"{expected}")
        if set(solo_calls) != {("p2p_0",)} or solo_calls[("p2p_0",)][0] != (real, 0, 0):
            raise AssertionError(f"the solo request launched {solo_calls}")
        answers = {name: response(svc, name) for name in list(SERVE_SPOOL) + ["torn"]}
        bad = {name: r for name, r in answers.items() if (r["status"] == "ok") == (name in ("nope", "torn"))}
        sizes = {name: answers[name].get("batched_with") for name in SERVE_SPOOL}
        want_sizes = {name: SERVE_GROUP if name.startswith("p2p") else 2 if name.startswith("masa") else None
                      for name in SERVE_SPOOL}
        if bad or sizes != want_sizes or response(solo, "p2p_0")["status"] != "ok" or solo_handled != 1:
            raise AssertionError(f"service answers {bad or answers}, groups {sizes}")
        rejected = os.path.join(svc.rejected_dir, "torn.json")
        if [p["handled"] for p in polls] != [len(SERVE_SPOOL)] + [0] * svc.PARSE_RETRIES or not os.path.exists(
                rejected) or open(rejected).read() != '{"method": "p2p", "source_prompt": "a cat':
            raise AssertionError(f"polls {polls}: the torn request was not rejected after "
                                 f"{svc.PARSE_RETRIES + 1} polls with its bytes kept")
        for name, (method, _, _, has_image) in SERVE_SPOOL.items():
            if method != "nope":
                for f in ("source", "inversion", "edit") if has_image else ("inversion", "edit"):
                    png(svc, name, f)
        grouped_vs_solo = {}
        for f in ("inversion", "edit"):
            a, b = png(svc, "p2p_0", f).astype(np.float64), png(solo, "p2p_0", f).astype(np.float64)
            mse = float(np.mean((a - b) ** 2))
            grouped_vs_solo[f] = dict(max_levels=int(np.abs(a - b).max()), mean_levels=float(np.abs(a - b).mean()),
                                      psnr_db=10 * math.log10(255.0 ** 2 / mse) if mse else float("inf"))
    finally:
        for service in (svc, solo):
            service._io_pool.shutdown()
            service._finalize_pool.shutdown()
    group_s = {",".join(k): s for k, (_, s, _) in calls.items()}
    per_image = calls[P2P_GROUP][1] / len(P2P_GROUP)
    emit("serve_path", model="SD1.5 (random weights, seed 0, from the fp16 snapshot, bf16)", resolution=side,
         dtype="bfloat16", steps=SERVE_STEPS, load_s=load_s, max_batch=SERVE_GROUP, polls=polls,
         poll_s=sum(p["seconds"] for p in polls), s_per_request=sum(p["seconds"] for p in polls) / len(SERVE_SPOOL),
         call_s=group_s, launches={",".join(k): v for k, v in got.items()}, poll_launches=poll_launches,
         p2p_group_s_per_image=per_image, masactrl_group_s_per_image=calls[MASA_GROUP][1] / len(MASA_GROUP),
         solo_s=solo_calls[("p2p_0",)][1], solo_poll_s=solo_s, images_per_hour_at_group=3600.0 / per_image,
         grouped_vs_solo=grouped_vs_solo, stats=svc.stats, main_path_image_s=EMITTED["main_path"]["image_s"],
         card=card_line())
    del pipe
    torch.cuda.empty_cache()
    return poll_launches[0] + solo_calls[("p2p_0",)][0][0]


# The gradient paths' groups (grad_groups_path, SD1.5 512², the snapshot as
# the service loads it; xl_p2z_group_path, SDXL 1024²) and the parallel
# runs of NTI and pix2pix-zero (cp_path (e), tp (d4)-(d5)) run on 10-step
# schedules: every GRAD_STRIDE-th step of the 50, a cut in depth only (a
# group launches per step what one image does at any depth).
GRAD_STRIDE = 5
GRAD_INNER_STEPS = 2  # NTI inner iterations a step there (random weights never stop at the default epsilon)
GRAD_RTOL = 1e-3  # f32: a group's guided step against each image's alone; CP's gradients against unsharded
GRAD_STEP = 5  # the f32 guided step's index on the 10-step schedule
# the service's gradient groups: name -> (method, source, target, inversion)
GRAD_SPOOL = {
    "p2z_0": ("p2z", "a cat sitting on the grass", "a dog sitting on the grass", "ddim"),
    "p2z_1": ("p2z", "a dog sitting on the grass", "a cat standing on the grass", "ddim"),
    "nti_0": ("p2p", "a cat sitting on the grass", "a white cat sitting on the grass", "null-text"),
    "nti_1": ("p2p", "a dog sitting on the grass", "a small dog sitting on the grass", "null-text"),
}
P2Z_SERVE_GROUP = ("p2z_0", "p2z_1")
NTI_SERVE_GROUP = ("nti_0", "nti_1")
# batched NTI's group of NTI_GROUP: each image's (source, target), its start
# latent scaled as TINY_NTI_SCALES scales the tiny group's
NTI_GROUP_PAIRS = [SERVE_SPOOL[name][1:3] for name in P2P_GROUP[:NTI_GROUP]]
XL_P2Z_PAIRS = [PROMPTS, PROMPTS[::-1]]  # SDXL's batched pix2pix-zero group of P2Z_GROUP
LAUNCHER_SHARDS = 2
LAUNCHER_TIMEOUT_S = 300


def p2z_launches(sites, steps, recompute=False, checkpointed=False, inverted=True, grad_sites=None):
    """(forward, dQ, dK/dV) launches of one image's pix2pix-zero edit, which a
    group launches too: a step of pass 1's forward, pass 2's gradient and
    noise forwards (with recomputed references their forward too, with the
    checkpointed UNet the blocks' forward again in the backward pass), the
    backward at ``grad_sites`` (every site: the gradient reaches the input
    latent); the DDIM inversion's forward a step if ``inverted``."""
    grad_sites = sites if grad_sites is None else grad_sites
    per_step = sites * (3 + int(recompute) + int(checkpointed))
    return per_step * steps + (sites * steps if inverted else 0), grad_sites * steps, grad_sites * steps


def nti_launches(sites, grad_sites, steps, inner, checkpointed=False, images=1):
    """(forward, dQ, dK/dV) launches of null-text inversion of ``images``
    images run one by one, or of a group's batch (``images`` 1), over
    ``steps`` steps and ``inner`` inner iterations in all (a batch's: its
    slowest image's at each step): a conditional and a final forward a step,
    an inner iteration's forward (twice with the checkpointed UNet) and its
    backward at the gradient's sites."""
    fwd = sites * (2 * steps * images + inner * (1 + int(checkpointed)))
    return fwd, grad_sites * inner, grad_sites * inner


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def seconds_of(fn, device):
    """(fn(), seconds from one synchronize to the next), on any device."""
    sync(device)
    start = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - start


@contextlib.contextmanager
def steps_schedule(pipe, steps):
    """The pipe's schedule swapped for a ``steps``-step one (every
    50 / steps-th step of the 50), the full one restored after."""
    from image_editing_framework_torch.core.scheduler import make_ddim_schedule

    full = pipe.scheduler
    pipe.scheduler = make_ddim_schedule(steps)
    try:
        yield pipe.scheduler
    finally:
        pipe.scheduler = full


@contextlib.contextmanager
def nti_inner_steps(inner):
    """``cli.nti_config_for`` with ``inner`` inner iterations a step (the
    service's and the CLI's NTI read their config from it)."""
    from image_editing_framework_torch import cli

    real = cli.nti_config_for
    cli.nti_config_for = lambda method, pipe: dataclasses.replace(real(method, pipe), num_inner_steps=inner)
    try:
        yield
    finally:
        cli.nti_config_for = real


@contextlib.contextmanager
def nti_recorded():
    """Records what NTI's inner loop runs on: ``seen["embeddings"]``, the
    unconditional embeddings that enter each inner iteration's gradient
    forward (G, 77, D), and ``seen["losses"]``, each iteration's loss
    vector as every rank takes it (after ``lockstep``)."""
    from image_editing_framework_torch.inversion import nti

    seen, grad_unet, lockstep = {"embeddings": [], "losses": []}, nti.grad_unet, nti.lockstep

    def recording_unet(*args, **kwargs):
        unet = grad_unet(*args, **kwargs)

        def call(x, t, ctx, *more, **kw):
            if torch.is_grad_enabled():
                seen["embeddings"].append(ctx.detach().clone())
            return unet(x, t, ctx, *more, **kw)
        return call

    def recording_lockstep(x, mesh):
        out = lockstep(x, mesh)
        seen["losses"].append(out)
        return out

    nti.grad_unet, nti.lockstep = recording_unet, recording_lockstep
    try:
        yield seen
    finally:
        nti.grad_unet, nti.lockstep = grad_unet, lockstep


def frozen_after_stop(stops, embeddings, seqs):
    """How many (step, iteration, image) entries show an image that has
    stopped keeping its embedding bit for bit: the embedding entering each
    inner iteration after its stop equals the step's result. Raises on the
    first that does not."""
    if sum(max(step) for step in stops) != len(embeddings):
        raise AssertionError(f"{len(embeddings)} inner iterations recorded, the stops {stops} say "
                             f"{sum(max(step) for step in stops)}")
    frozen, it = 0, 0
    for i, step_stops in enumerate(stops):
        for j in range(max(step_stops)):  # the embeddings entering iteration j + 1
            for k, stop in enumerate(step_stops):
                if j >= stop:
                    if not torch.equal(embeddings[it + j][k], seqs[k, i]):
                        raise AssertionError(f"image {k} stopped after {stop} inner iterations at step {i} but its "
                                             f"embedding moved at iteration {j + 1}")
                    frozen += 1
        it += max(step_stops)
    return frozen


def step0_epsilon(pipe, trajs, prompts, guidance_scale=7.5):
    """(an epsilon that splits a group's images at step 0, the step-0
    losses): the geometric mean of the two adjacent sorted losses farthest
    apart in ratio, the losses of the first inner iteration computed as
    NTI computes them, so that the images below it stop after one iteration
    and the rest iterate on."""
    from image_editing_framework_torch.inversion import nti
    from image_editing_framework_torch.methods.base import flat

    g, s = trajs.shape[0], pipe.scheduler.num_steps
    emb, _ = pipe.encode_prompts(list(prompts))
    lat, target = flat(trajs[:, -1].float()), flat(trajs[:, s - 1].float())
    t = int(pipe.scheduler.timesteps[0])
    with torch.no_grad():
        eps_c = pipe.unet(lat, t, emb[g:].float())[0]
        losses = nti.nti_losses(pipe.unet, pipe.scheduler, 0, lat, target, eps_c, emb[:g].float(), guidance_scale)
    ordered = sorted(losses.tolist())
    low, high = max(zip(ordered, ordered[1:]), key=lambda pair: pair[1] / max(pair[0], 1e-30))
    return math.sqrt(low * high), losses.tolist()


def png_of(directory, name, side, what):
    """The uint8 PNG ``directory/name.png``: ``side``², 3 channels, not
    constant, or fail naming ``what``."""
    import os

    from image_editing_framework_torch.utils.images import decode_png

    with open(os.path.join(directory, name + ".png"), "rb") as f:
        img = decode_png(f.read())
    if img is None or img.shape != (side, side, 3) or img.dtype != np.uint8 or img.std() == 0:
        raise AssertionError(f"{what}{name}.png: {None if img is None else img.shape}, constant or misshapen")
    return img


def images_held(images, side, what):
    """Every image of a (..., side, side, 3) uint8 array not constant."""
    flat_images = images.reshape((-1,) + images.shape[-3:])
    if images.shape[-3:] != (side, side, 3) or images.dtype != np.uint8 or any(x.std() == 0 for x in flat_images):
        raise AssertionError(f"{what}: images {images.shape} {images.dtype}, constant or misshapen")


def grad_groups_service(pipe, root):
    """(A1): the editing service's gradient groups on the loaded snapshot,
    ``max_batch`` = 2: ``GRAD_SPOOL`` (a pix2pix-zero DDIM group and a P2P
    null-text group, ``GRAD_INNER_STEPS`` inner iterations a step), polled
    once; then the first pix2pix-zero request alone (``max_batch`` = 1).
    Gates: every answer "ok", groups of 2 and 2, every PNG 512² uint8 and
    not constant, exact launches: the p2z group those of one image; the
    null-text group one image's batched inversion and edit and each
    image's NTI (run image by image, ``nti_group_serial``), at the inner
    iterations it ran."""
    import os

    from PIL import Image

    from image_editing_framework_torch.serve import EditService

    side, sites, grad_sites = MODELS["sd"][2], SITES["sd"], GRAD_SITES["sd"]
    steps = pipe.scheduler.num_steps
    inputs = os.path.join(root, "grad_service_inputs")
    os.makedirs(inputs, exist_ok=True)
    rng = np.random.RandomState(12)

    def request(svc, name):
        method, source, target, inversion = GRAD_SPOOL[name]
        path = os.path.join(inputs, name + ".png")
        if not os.path.exists(path):
            grid = Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8))
            grid.resize((side, side), Image.BICUBIC).save(path)
        with open(os.path.join(svc.requests_dir, name + ".json"), "w") as f:
            json.dump(dict(method=method, source_prompt=source, target_prompt=target, image_path=path,
                           inversion_type=inversion), f)

    svc = EditService(pipe, os.path.join(root, "grad_service"), max_batch=P2Z_GROUP)
    solo = EditService(pipe, os.path.join(root, "grad_service_solo"), max_batch=1)
    try:
        for name in GRAD_SPOOL:
            request(svc, name)
        calls = served_calls(svc)
        torch.cuda.reset_peak_memory_stats()
        with nti_inner_steps(GRAD_INNER_STEPS):
            handled, poll_s = timed(svc.poll_once)
        peak = torch.cuda.max_memory_allocated() / 2**30
        request(solo, P2Z_SERVE_GROUP[0])
        solo_calls = served_calls(solo)
        solo_handled, _ = timed(solo.poll_once)
        answers = {name: served_response(svc, name) for name in GRAD_SPOOL}
        solo_answer = served_response(solo, P2Z_SERVE_GROUP[0])
    finally:
        for service in (svc, solo):
            service._io_pool.shutdown()
            service._finalize_pool.shutdown()
    bad = {name: r for name, r in answers.items() if r["status"] != "ok" or r.get("batched_with") != 2}
    if bad or solo_answer["status"] != "ok" or handled != len(GRAD_SPOOL) or solo_handled != 1:
        raise AssertionError(f"the service's gradient groups answered {bad or answers}, alone {solo_answer}")
    inner = calls.get(NTI_SERVE_GROUP, (None, None, 0))[2]
    if not len(NTI_SERVE_GROUP) * steps <= inner <= len(NTI_SERVE_GROUP) * steps * GRAD_INNER_STEPS:
        raise AssertionError(f"the null-text group ran {inner} inner iterations over {steps} steps")
    nti_fwd, nti_dq, nti_dkv = nti_launches(sites, grad_sites, steps, inner, images=len(NTI_SERVE_GROUP))
    one_p2z = p2z_launches(sites, steps)
    expected = {P2Z_SERVE_GROUP: one_p2z, NTI_SERVE_GROUP: (2 * sites * steps + nti_fwd, nti_dq, nti_dkv)}
    got = {key: launches for key, (launches, _, _) in calls.items()}
    if got != expected or solo_calls[P2Z_SERVE_GROUP[:1]][0] != one_p2z:
        raise AssertionError(f"the gradient groups launched (forward, dQ, dK/dV) {got}, alone "
                             f"{solo_calls[P2Z_SERVE_GROUP[:1]][0]}; expected {expected}, alone {one_p2z}")
    for name in GRAD_SPOOL:
        for f in ("source", "inversion", "edit"):
            png_of(os.path.join(svc.results_dir, name), f, side, f"served {name}/")
    grouped_vs_solo = {}
    for f in ("inversion", "edit"):
        a, b = (png_of(os.path.join(s.results_dir, P2Z_SERVE_GROUP[0]), f, side, "served ").astype(np.int32)
                for s in (svc, solo))
        grouped_vs_solo[f] = dict(max_levels=int(np.abs(a - b).max()), mean_levels=float(np.abs(a - b).mean()))
    seconds = {",".join(k): s for k, (_, s, _) in calls.items()}
    return dict(poll_s=poll_s, call_s=seconds,
                s_per_image={",".join(k): s / len(k) for k, (_, s, _) in calls.items()},
                solo_s=solo_calls[P2Z_SERVE_GROUP[:1]][1], launches={",".join(k): v for k, v in got.items()},
                nti_inner_iterations=inner, groups={name: 2 for name in answers}, p2z_grouped_vs_solo=grouped_vs_solo,
                peak_gib=peak), tuple(map(sum, zip(one_p2z, *expected.values())))


def grad_groups_nti_batch(pipe):
    """(A2): batched NTI (``eval/batched.py nti_batch``) of a group of
    NTI_GROUP, ``GRAD_INNER_STEPS`` inner iterations a step, its start
    latents scaled as TINY_NTI_SCALES scales the tiny group's and its
    epsilon taken between its step-0 losses (``step0_epsilon``), so that the
    images stop at different inner iterations; then ``edit_batch`` P2P and
    pix2pix-zero of the first P2Z_GROUP images on those embeddings. Gates:
    the stops differ between the images; an image that has stopped keeps
    its embedding bit for bit (``frozen_after_stop``); exact launches of
    the NTI (the group's slowest image's iterations at each step) and of
    each edit (one image's); finite embeddings; 512² images, not constant.
    Returns (the line, the launches, (the inverted latents, the embeddings,
    the pairs))."""
    from image_editing_framework_torch.core.config import NTIConfig
    from image_editing_framework_torch.eval import batched
    from image_editing_framework_torch.eval.sweep import _auto_p2p_config
    from image_editing_framework_torch.inversion import nti

    side, sites, grad_sites = MODELS["sd"][2], SITES["sd"], GRAD_SITES["sd"]
    steps, lat = pipe.scheduler.num_steps, side // 8
    sources = [pair[0] for pair in NTI_GROUP_PAIRS]
    gen = torch.Generator(device=pipe.device).manual_seed(13)
    scales = torch.tensor(TINY_NTI_SCALES, device=pipe.device)[:, None, None, None, None]
    lats = (torch.randn(NTI_GROUP, 1, lat, lat, 4, device=pipe.device, generator=gen) * scales).to(pipe.dtype)
    inverted, trajs = batched.ddim_invert_batch(pipe, lats, sources, return_trajectory=True)
    epsilon, step0_losses = step0_epsilon(pipe, trajs, sources)
    cfg = NTIConfig(num_inner_steps=GRAD_INNER_STEPS, epsilon=epsilon)
    reset_launch_counts()
    nti.null_text_inversion.inner_iterations = 0
    with nti_recorded() as seen:
        (seqs, stops), nti_s = timed(lambda: batched.nti_batch(pipe, trajs, sources, cfg, return_stops=True))
    counts, inner = launch_counts(), sum(max(step) for step in stops)
    if counts != nti_launches(sites, grad_sites, steps, inner) or nti.null_text_inversion.inner_iterations != inner:
        raise AssertionError(f"batched NTI launched (forward, dQ, dK/dV) {counts} over {inner} inner iterations, "
                             f"expected {nti_launches(sites, grad_sites, steps, inner)}")
    if not any(len(set(step)) > 1 for step in stops):
        raise AssertionError(f"batched NTI's images stopped together at every step: {stops} (epsilon {epsilon}, "
                             f"step-0 losses {step0_losses})")
    frozen = frozen_after_stop(stops, seen["embeddings"], seqs)
    if seqs.shape != (NTI_GROUP, steps, 77, MODELS["sd"][3]) or not torch.isfinite(seqs).all() or not frozen:
        raise AssertionError(f"batched NTI's embeddings {tuple(seqs.shape)}, not finite or never frozen ({frozen})")
    pairs = NTI_GROUP_PAIRS[:P2Z_GROUP]
    edits, totals = {}, counts
    for method in ("p2p", "p2z"):
        cfgs = [_auto_p2p_config(*pair) for pair in pairs] if method == "p2p" else None
        reset_launch_counts()
        images, edit_s = timed(lambda: batched.edit_batch(method, pipe, pairs, inverted[:P2Z_GROUP], cfgs,
                                                          uncond_seqs=seqs[:P2Z_GROUP]))
        got = launch_counts()
        want = (sites * steps, 0, 0) if method == "p2p" else p2z_launches(sites, steps, inverted=False)
        if got != want:
            raise AssertionError(f"{method} on batched NTI's embeddings launched {got}, expected {want}")
        images_held(images, side, f"{method} on batched NTI's embeddings")
        edits[method] = dict(seconds=edit_s, launches=got, image_means=images.reshape(-1).mean().item())
        totals = tuple(a + b for a, b in zip(totals, got))
    line = dict(group=NTI_GROUP, epsilon=epsilon, step0_losses=step0_losses, stops=stops, inner_iterations=inner,
                frozen_entries=frozen, nti_s=nti_s, nti_launches=counts, edits=edits)
    return line, totals, (inverted[:P2Z_GROUP], pairs)


def grad_groups_f32_step(pipe, latents, pairs):
    """(A3), f32: one guided step (step ``GRAD_STEP``) of a pix2pix-zero
    group of P2Z_GROUP against each image's guided step alone, on the
    loaded UNet cast to f32 for it (and back: bf16 -> f32 -> bf16 is
    exact), no TF32: each image's gradient, next latent and loss within
    GRAD_RTOL · max|ref| of its own alone. The group fold's correctness gate
    at full width (bf16 outputs of a group may differ from solo ones by the
    batch place)."""
    from image_editing_framework_torch.methods import p2z
    from image_editing_framework_torch.methods.base import flat

    g, unet, sched, i = len(pairs), pipe.unet, pipe.scheduler, GRAD_STEP
    t = int(sched.timesteps[i])
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    unet.float()
    try:
        def contexts(prompts):
            emb, _ = pipe.encode_prompts(prompts)
            return torch.stack([emb[:g], emb[g:]], dim=1).float()  # (G, 2, 77, D)

        ctx_src, ctx_tgt = contexts([p[0] for p in pairs]), contexts([p[1] for p in pairs])
        lat = latents.float()
        src_trajs = lat[None].expand((sched.num_steps,) + tuple(lat.shape))
        ref = p2z.source_records_group(unet, sched, i, src_trajs, ctx_src)
        _, grad = p2z.guidance_gradient_group(unet, flat(torch.cat([lat, lat], dim=1)), t, flat(ctx_tgt), ref, None, g)
        nxt, losses = p2z.guided_step_group(unet, sched, i, lat, ctx_tgt, ref, 7.5, 0.1)
        held = {}
        for k in range(g):
            ref_k = p2z.source_records(unet, sched, i, src_trajs[:, k], ctx_src[k])
            _, grad_k = p2z.guidance_gradient(unet, torch.cat([lat[k], lat[k]]), t, ctx_tgt[k], ref_k)
            nxt_k, loss_k = p2z.guided_step(unet, sched, i, lat[k], ctx_tgt[k], ref_k, 7.5, 0.1)
            for name, a, b in (("gradient", grad[2 * k:2 * k + 2], grad_k), ("next latent", nxt[k], nxt_k),
                               ("loss", losses[k], loss_k)):
                held[f"image{k} {name}"] = rel_held(f"the p2z group's f32 guided step, image {k}'s {name}", a, b,
                                                    GRAD_RTOL)
    finally:
        unet.to(pipe.dtype)
        torch.backends.cudnn.allow_tf32 = tf32
    return held


def phase_grad_groups_path(root, snapshot):
    """The gradient paths' groups at SD1.5 512² on the snapshot
    ``phase_checkpoint_path`` wrote, loaded by ``cli.load_pipe("1.5")`` as
    the service loads it, bf16, on a 10-step schedule (every
    ``GRAD_STRIDE``-th step): (A1) the service's pix2pix-zero and null-text
    groups and a pix2pix-zero request alone (``grad_groups_service``), (A2)
    batched NTI of a group of 3 and the batched edits on its embeddings
    (``grad_groups_nti_batch``), (A3) the group's f32 guided step against
    each image's alone (``grad_groups_f32_step``). Returns the launches
    (forward, dQ, dK/dV) of (A1) and (A2)."""
    side = MODELS["sd"][2]
    pipe, load_s = load_snapshot(snapshot)
    with steps_schedule(pipe, STEPS // GRAD_STRIDE) as sched:
        service, service_launches = grad_groups_service(pipe, root)
        torch.cuda.reset_peak_memory_stats()
        group, group_launches, (latents, pairs) = grad_groups_nti_batch(pipe)
        group["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        f32_step, f32_s = timed(lambda: grad_groups_f32_step(pipe, latents, pairs))
    emit("grad_groups_path", model="SD1.5 (random weights, seed 0, from the fp16 snapshot, bf16)", resolution=side,
         dtype="bfloat16", steps=sched.num_steps, inner_steps=GRAD_INNER_STEPS, load_s=load_s, service=service,
         nti_batch=group, f32_group_step=dict(step=GRAD_STEP, rtol=GRAD_RTOL, seconds=f32_s, held=f32_step),
         launches=[a + b for a, b in zip(service_launches, group_launches)], card=card_line())
    del pipe
    torch.cuda.empty_cache()
    return tuple(a + b for a, b in zip(service_launches, group_launches))


def phase_xl_p2z_group_path(pipe, starts):
    """SDXL 1024²'s batched pix2pix-zero: a group of P2Z_GROUP
    (``XL_P2Z_PAIRS``, from the start latents ``starts``) through
    ``edit_batch("p2z", ...)`` on ``xl_nti_path``'s 10-step schedule, the
    XL defaults (references recomputed, the checkpointed UNet by the auto
    rule), bf16: backpropagation at CFG batch 4 through the checkpointed
    UNet. Gates: exact launches (a group as one image), finite final
    latents, 1024² images not constant. Readings: seconds, the peak memory."""
    import functools

    from image_editing_framework_torch.eval import batched
    from image_editing_framework_torch.methods import common

    _, name, side, _ = MODELS["xl"]
    sites = SITES["xl"]
    checkpointed = isinstance(common.grad_unet(pipe, side // 8), functools.partial)
    latents = torch.stack([start.to(pipe.dtype) for start in starts])
    finals, decode = [], batched._decode_pairs

    def recording(p, final):
        finals.append(final)
        return decode(p, final)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    batched._decode_pairs = recording
    try:
        with steps_schedule(pipe, STEPS // XL_NTI_STRIDE) as sched:
            images, seconds = timed(lambda: batched.edit_batch("p2z", pipe, XL_P2Z_PAIRS, latents))
    finally:
        batched._decode_pairs = decode
    counts, peak = launch_counts(), torch.cuda.max_memory_allocated() / 2**30
    want = p2z_launches(sites, sched.num_steps, recompute=True, checkpointed=checkpointed, inverted=False)
    if counts != want or not checkpointed:
        raise AssertionError(f"SDXL's p2z group launched (forward, dQ, dK/dV) {counts}, expected {want} (the "
                             f"checkpointed UNet: {checkpointed})")
    if len(finals) != 1 or finals[0].shape != (P2Z_GROUP, 2, side // 8, side // 8, 4) or not torch.isfinite(
            finals[0].float()).all():
        raise AssertionError(f"SDXL's p2z group's final latents {[tuple(f.shape) for f in finals]}, not finite")
    images_held(images, side, "SDXL's p2z group")
    emit("xl_p2z_group_path", model=f"{name} (random weights, seed 0)", resolution=side, dtype="bfloat16",
         steps=sched.num_steps, group=P2Z_GROUP, cfg_batch=P2Z_BATCH * P2Z_GROUP, checkpointed_unet=checkpointed,
         recompute_refs=True, seconds=seconds, s_per_image=seconds / P2Z_GROUP, launches=counts,
         image_means=[float(x.mean()) for x in images.reshape((-1,) + images.shape[-3:])], peak_gib=peak,
         card=card_line())
    return counts


def phase_launcher_path(root):
    """The distributed sweep launcher (``tools/launch_distributed_sweep.py``)
    on the card: LAUNCHER_SHARDS processes at once, each ``--random_weights
    --num_steps 10 --shard_index i --shard_count 2`` over one mini PIE
    (``SWEEP_PIE``, 512²) into one ``--exp_path``, a process group of none
    (its ``--num_processes`` form takes NCCL, which refuses two ranks on one
    card). Gates: exit codes 0; the shards' event logs partition the items
    of the default categories as the launcher strides them; every item's
    ``source``, ``inversion`` and ``edit`` PNGs 512² and not constant; both
    stats files. Their launches are the processes' own, not counted here."""
    import os

    from image_editing_framework_torch.data.pie import DEFAULT_CATEGORIES, PIE

    side = MODELS["sd"][2]
    pie = write_mini_pie(os.path.join(root, "launcher_PIE"), side)
    work = [it.key for c in DEFAULT_CATEGORIES for it in PIE(pie, c).items]
    exp = os.path.join(root, "launcher_exp")
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "image_editing_framework_torch.tools.launch_distributed_sweep", "--random_weights",
           "--num_steps", str(STEPS // GRAD_STRIDE), "--dataset_path", pie, "--exp_path", exp,
           "--shard_count", str(LAUNCHER_SHARDS)]
    logs = [open(os.path.join(root, f"launcher{i}.log"), "w") for i in range(LAUNCHER_SHARDS)]
    start = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--shard_index", str(i)], cwd=here, stdout=logs[i], stderr=subprocess.STDOUT)
             for i in range(LAUNCHER_SHARDS)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, LAUNCHER_TIMEOUT_S - (time.perf_counter() - start)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    seconds, codes = time.perf_counter() - start, [p.returncode for p in procs]
    if any(codes):
        tails = "".join(f"--- shard {i}\n" + open(os.path.join(root, f"launcher{i}.log")).read()[-3000:]
                        for i in range(LAUNCHER_SHARDS))
        raise AssertionError(f"the launcher's shards exited {codes}\n{tails}")
    shards, stats = [], []
    for i in range(LAUNCHER_SHARDS):
        with open(os.path.join(exp, f"events_p2p_{i}.jsonl")) as f:
            shards.append([json.loads(line)["key"] for line in f if line.strip()])
        with open(os.path.join(exp, f"sweep_stats_p2p_{i}.json")) as f:
            stats.append(json.load(f))
    if sorted(k for keys in shards for k in keys) != sorted(work) or any(
            sorted(keys) != sorted(work[i::LAUNCHER_SHARDS]) for i, keys in enumerate(shards)):
        raise AssertionError(f"the launcher's shards {shards} do not partition the items {work} by stride")
    for key in work:
        for f in ("source", "inversion", "edit"):
            png_of(os.path.join(exp, key), f, side, f"the launcher's {key}/")
    emit("launcher_path", processes=LAUNCHER_SHARDS, steps=STEPS // GRAD_STRIDE, items=len(work), shards=shards,
         exit_codes=codes, seconds=seconds, images_done=[s["images_done"] for s in stats],
         mean_s_per_image=[s["mean_s_per_image"] for s in stats],
         note="two processes share the one card; the process-group form (--num_processes, NCCL) needs a card "
              "per process", card=card_line())


# the runway's UNet forwards per image of each method (one launch at every
# self-attention site of each) and its backwards (p2z's guided steps): P2P,
# MasaCtrl and PnP denoise once; p2z records the source (pass 1), then each
# guided step runs a forward with its backward and a forward on the updated
# latent
VALIDATION_FORWARDS = {"p2p": 1, "masactrl": 1, "pnp": 1, "p2z": 3}
# the runway's schedule: a 10-step one since the gradient paths' groups
# joined the script (a cut in depth: its gates count per step)
VALIDATION_STEPS = 10
VALIDATION_BACKWARDS = {"p2p": 0, "masactrl": 0, "pnp": 0, "p2z": 1}
TOWER_RTOL = 1e-4  # the card's CLIP score and LPIPS against the same towers on the CPU, f32, relative
CLIP_SEED = 5


def validation_launches(sites, steps, methods, real):
    """(forward, dQ, dK/dV) launches of ``validate_pipeline`` over
    ``methods``: each method's synthesized edit, and with a ``real`` source
    image one DDIM inversion shared by all methods and each method's edit
    of it."""
    edits = 2 if real else 1
    fwd = sum(VALIDATION_FORWARDS[m] for m in methods) * edits + (1 if real else 0)
    bwd = sum(VALIDATION_BACKWARDS[m] for m in methods) * edits
    return sites * steps * fwd, sites * steps * bwd, sites * steps * bwd


def write_clip_checkpoint(directory, words, device, seed=CLIP_SEED):
    """A seeded random CLIP checkpoint in the shapes ``eval/metrics.py
    CLIPScore`` builds (``models/clip.py``'s ``CLIPTextConfig`` with
    ``CLIP_VIT_B32_VISION``'s projection, and that vision tower, read at
    call time as the scorer reads them): ``model.safetensors`` (fp16, with
    the text tower's ``position_ids``) and the synthetic BPE vocab that
    makes ``words`` whole under ``tokenizer/``. Returns the bytes of tensor
    data."""
    import os

    from image_editing_framework_torch.models import clip
    from image_editing_framework_torch.models.loader import save_safetensors
    from image_editing_framework_torch.pipelines import _build

    vision_cfg = clip.CLIP_VIT_B32_VISION
    text = _build(clip.CLIPTextModel, clip.CLIPTextConfig(projection_dim=vision_cfg.projection_dim), device,
                  torch.float32, seed)
    vision = _build(clip.CLIPVisionModel, vision_cfg, device, torch.float32, seed + 1)
    os.makedirs(directory, exist_ok=True)
    nbytes = save_safetensors(dict(text.state_dict(), **vision.state_dict(), **clip_position_ids()),
                              os.path.join(directory, "model.safetensors"), torch.float16)
    write_tokenizer(os.path.join(directory, "tokenizer"), *synthetic_clip_vocab(words, size=text.config.vocab_size))
    return nbytes


def write_lpips_weights(path):
    """``eval/lpips.py LPIPS``'s seeded random net as one ``.safetensors``
    file (f32) in the released artifacts' keys: torchvision's vgg16
    ``features.N.{weight,bias}`` and LPIPS's ``linN.model.1.weight``.
    Returns the bytes of tensor data."""
    from image_editing_framework_torch.eval import lpips
    from image_editing_framework_torch.models.loader import save_safetensors

    state = lpips.LPIPS(None, device="cpu").net.state_dict()
    tv = {}
    for i, (_, idx) in enumerate(lpips._VGG16_CONVS):
        tv[f"features.{idx}.weight"], tv[f"features.{idx}.bias"] = (state[f"vgg.conv_{i}.{leaf}"]
                                                                    for leaf in ("weight", "bias"))
    for i in range(len(lpips._TAPS)):
        tv[f"lin{i}.model.1.weight"] = state[f"lin_{i}.weight"]
    return save_safetensors(tv, path)


def tower_err(card, cpu):
    """|card - cpu| relative to |cpu| (0 where both are 0)."""
    return abs(card - cpu) / abs(cpu) if cpu else abs(card)


def phase_validation_path(root, snapshot):
    """The validation runway (``eval/validate.py main``, its own entry
    point) on the SD1.5 snapshot ``phase_checkpoint_path`` wrote into
    ``root``, bf16, 512², ``VALIDATION_STEPS`` steps, all four methods, the synthesized source
    image (``--source_image synth``), DDIM inversion, with a seeded random
    CLIP checkpoint in ``CLIPScore``'s shapes (fp16, ~0.42 GB) and a seeded
    random LPIPS file (VGG16 and the heads, f32, ~59 MB) written here.
    Gates: ``report.json`` holds the four methods with 64-hex hashes of
    every PNG; the reconstruction metrics are finite; CLIP scores in [0,
    100], LPIPS finite and >= 0; exact launches (``validation_launches``);
    the card's CLIP scores, unit CLIP embeddings and LPIPS within
    ``TOWER_RTOL`` of the same towers on the CPU on the same images
    (relative; the embeddings' distance); LPIPS(a, a) == 0 and LPIPS(a, b)
    > 0 on the card. Readings: seconds per method and flow, the towers' ms
    on the card, and whether P2P run again by the golden check
    (``tools/golden_check.py --path`` the snapshot, against this run's
    report) gives the same hashes."""
    import os

    from image_editing_framework_torch.eval import validate
    from image_editing_framework_torch.eval.lpips import LPIPS
    from image_editing_framework_torch.eval.metrics import CLIPScore
    from image_editing_framework_torch.tools import golden_check

    side, sites = MODELS["sd"][2], SITES["sd"]
    clip_dir, lpips_path = os.path.join(root, "clip"), os.path.join(root, "lpips.safetensors")
    (clip_bytes, lpips_bytes), write_s = timed(lambda: (write_clip_checkpoint(clip_dir, CKPT_WORDS, "cuda"),
                                                        write_lpips_weights(lpips_path)))
    torch.cuda.empty_cache()
    source, target = CKPT_PROMPTS

    def runway(out, *more):
        reset_launch_counts()
        _, loads, seconds = timed_loads(lambda: validate.main(
            ["--path", snapshot, "--sd_version", "1.5", "--num_steps", str(VALIDATION_STEPS), "--resolution",
             str(side), "--source_image", "synth",
             "--source_prompt", source, "--target_prompt", target, "--clip_checkpoint", clip_dir, "--lpips_weights",
             lpips_path, "--out", out, *more]))
        counts = launch_counts()
        torch.cuda.empty_cache()
        with open(os.path.join(out, "1.5", "report.json")) as f:
            return json.load(f), counts, seconds, sum(s for _, _, s in loads)

    def png(out, method, name):
        return png_of(os.path.join(out, "1.5", method), name, side, f"validation {method}/")

    out = os.path.join(root, "validation")
    report, counts, run_s, load_s = runway(out)
    methods = validate.METHODS
    expected = validation_launches(sites, VALIDATION_STEPS, methods, real=True)
    if counts != expected:
        raise AssertionError(f"the runway launched (forward, dQ, dK/dV) {counts} times, expected {expected}")
    if tuple(report["methods"]) != methods or report["num_steps"] != VALIDATION_STEPS or report["backend"] != "cuda":
        raise AssertionError(f"report.json: methods {list(report['methods'])}, {report['num_steps']} steps, backend "
                             f"{report['backend']}")
    hashes = ("syn_source_sha256", "syn_edit_sha256", "real_inversion_sha256", "real_edit_sha256")
    for method, entry in report["methods"].items():
        bad = [k for k in hashes if not re.fullmatch(r"[0-9a-f]{64}", entry.get(k, ""))]
        bad += [k for k in ("recon_mse", "recon_psnr", "recon_ssim") if not math.isfinite(entry[k])]
        bad += [k for k in ("syn_clip_score", "real_clip_score") if not 0.0 <= entry[k] <= 100.0]
        if bad or not (math.isfinite(entry["recon_lpips"]) and entry["recon_lpips"] >= 0):
            raise AssertionError(f"report.json {method}: {bad or 'recon_lpips'} out of range: {entry}")
        for name in ("syn_source", "syn_edit", "real_inversion", "real_edit"):
            png(out, method, name)

    # the towers on the CPU, f32, on the same images (the PNGs are lossless):
    # the report's scores and distances, and the unit embeddings (a random
    # CLIP's cosines may be negative, which the score clamps to 0)
    image = validate.synth_source_image(42, side)
    cpu_clip, cpu_lpips = CLIPScore(clip_dir, device="cpu"), LPIPS(lpips_path, device="cpu")
    card_clip, card_lpips = CLIPScore(clip_dir, device="cuda"), LPIPS(lpips_path, device="cuda")
    towers, embeddings_err, cosines = {}, 0.0, {}
    for method, entry in report["methods"].items():
        edits = {flow: png(out, method, flow + "_edit")[None] for flow in ("syn", "real")}
        got = {"syn_clip_score": cpu_clip(edits["syn"], [target]),
               "real_clip_score": cpu_clip(edits["real"], [target]),
               "recon_lpips": cpu_lpips(image[None], png(out, method, "real_inversion")[None])}
        towers[method] = {k: dict(card=entry[k], cpu=v, rel_err=tower_err(entry[k], v)) for k, v in got.items()}
        for flow, edit in edits.items():
            on_card, on_cpu = card_clip.embeddings(edit, [target]), cpu_clip.embeddings(edit, [target])
            embeddings_err = max([embeddings_err] + [float(torch.linalg.vector_norm(a.cpu() - b))
                                                     for a, b in zip(on_card, on_cpu)])
            cosines[f"{method}_{flow}"] = float((on_cpu[0] * on_cpu[1]).sum())
    worst = max(t["rel_err"] for per in towers.values() for t in per.values())
    if worst > TOWER_RTOL or embeddings_err > TOWER_RTOL:
        raise AssertionError(f"the card's towers differ from the CPU's by {worst} relative, the unit embeddings by "
                             f"{embeddings_err} (limit {TOWER_RTOL}): {towers}")
    edit = png(out, "p2p", "real_edit")
    same, apart = card_lpips(image[None], image[None]), card_lpips(image[None], edit[None])
    if same != 0.0 or not apart > 0.0:
        raise AssertionError(f"LPIPS(a, a) = {same}, LPIPS(a, b) = {apart} on the card")
    px = torch.from_numpy(edit[None])
    tower_ms = {"clip_score_1x512": cuda_ms(lambda: card_clip.scores(px, [target])),
                "lpips_1x512": cuda_ms(lambda: card_lpips.distances(image[None], edit[None]))}
    del card_clip, card_lpips
    torch.cuda.empty_cache()

    # P2P again through the golden check (tools/golden_check.py) against
    # this run's report: do its hashes repeat the first run's? (a reading:
    # exit 0 or 1; a refusal or an exception fails the phase)
    out2 = os.path.join(root, "validation_p2p")
    reset_launch_counts()
    golden, rerun_s = timed(lambda: golden_check.main(
        ["--report", os.path.join(out, "1.5", "report.json"), "--method", "p2p", "--path", snapshot, "--out", out2,
         "--source_prompt", source, "--target_prompt", target]))
    rerun_counts = launch_counts()
    torch.cuda.empty_cache()
    if golden not in (0, 1):
        raise AssertionError(f"the golden check refused the runway's report (exit {golden})")
    if rerun_counts != validation_launches(sites, VALIDATION_STEPS, ("p2p",), real=True):
        raise AssertionError(f"the P2P rerun launched (forward, dQ, dK/dV) {rerun_counts} times")
    with open(os.path.join(out2, "report.json")) as f:
        report2 = json.load(f)
    rerun_same = {k: report2["methods"]["p2p"][k] == report["methods"]["p2p"][k] for k in hashes}
    if (golden == 0) != all(rerun_same.values()):
        raise AssertionError(f"the golden check exited {golden} on hashes {rerun_same}")
    emit("validation_path", model="SD1.5 (random weights, seed 0, from the fp16 snapshot, bf16)", resolution=side,
         dtype="bfloat16", steps=VALIDATION_STEPS, methods=list(methods), write_s=write_s, clip_gb=clip_bytes / 1e9,
         lpips_mb=lpips_bytes / 1e6, run_s=run_s, load_s=load_s,
         syn_s={m: e["syn_elapsed_s"] for m, e in report["methods"].items()},
         real_s={m: e["real_elapsed_s"] for m, e in report["methods"].items()},
         launches=counts, towers_card_vs_cpu=towers, towers_worst_rel_err=worst, tower_rtol=TOWER_RTOL,
         clip_embeddings_max_err=embeddings_err, clip_cosines_cpu=cosines,
         lpips_same=same, lpips_apart=apart, tower_ms=tower_ms,
         recon={m: {k: e[k] for k in ("recon_mse", "recon_psnr", "recon_ssim", "recon_lpips")}
                for m, e in report["methods"].items()},
         rerun_s=rerun_s, rerun_launches=rerun_counts, rerun_same_hashes=rerun_same, rerun_golden_check_exit=golden,
         main_path_image_s=EMITTED["main_path"]["image_s"], card=card_line())
    return counts, rerun_counts


def phase_xl_checkpoint_path(pipe):
    """SDXL base and refiner from checkpoints on the card, bf16: ``pipe``'s
    weights (``random_pipeline("xl", seed=0)``) written fp16 as an HF
    snapshot and as an LDM single file, and a seeded refiner UNet as the
    refiner's snapshot (about 18.4 GB on disk); ``cli.load_pipe`` of
    "xl-base" (the snapshot) and "animagineXL" (the single file), bitwise
    equal to each other and to the weights through fp16; then "xl-refiner"
    (the base a third time with the refiner attached), which must share the
    base's VAE, bigG tower and tokenizer, and one refiner img2img on it
    through the runway's ``validate_refiner`` (hashes and structure metrics
    in its report);
    then the p2p shim's ``edit_real`` with DDIM inversion at 1024², exact
    launches. Each pipe is freed before the next load."""
    import os

    from image_editing_framework_torch import cli, sd_mapping, shims
    from image_editing_framework_torch.eval.validate import validate_refiner
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
            refine, refine_s = timed(lambda: validate_refiner(refiner, os.path.join(tmp, "refine"), image,
                                                              CKPT_PROMPTS[0], strength=0.3, seed=0))
            refine_counts = launch_counts()
            forwards = STEPS - int(STEPS * (1.0 - 0.3))
            if refine_counts != (ref_sites * forwards, 0, 0):
                raise AssertionError(f"the loaded refiner launched (forward, dQ, dK/dV) {refine_counts} times, "
                                     f"expected {ref_sites} x {forwards} forward")
            with open(os.path.join(tmp, "refine", "refined.png"), "rb") as f:
                refined = decode_png(f.read())
            if refined is None or refined.shape != (side, side, 3) or refined.std() == 0 or not all(
                    re.fullmatch(r"[0-9a-f]{64}", refine[k]) for k in ("source_sha256", "refined_sha256")) or not (
                    math.isfinite(refine["refine_ssim"])):
                raise AssertionError(f"refiner output {None if refined is None else refined.shape} constant or "
                                     f"misshapen, or its report {refine}")
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
         refine_report={k: refine[k] for k in ("elapsed_s", "source_sha256", "refined_sha256", "refine_mse",
                                                "refine_psnr", "refine_ssim")},
         edit_real=dict(seconds=run_s, load_s=run_load_s, image_s=run_s - run_load_s, flash_launches=counts[0],
                        image_means=means),
         xl_main_path_image_s=EMITTED["xl_main_path"]["image_s"], card=card_line())
    return counts[0] + refine_counts[0]


SD21_DISK_GIB = 8  # the SD2.1 single file and its converted snapshot (2.6 GB each, fp16)


def phase_sd21_path(root):
    """SD2.1 on the card from a converted single file, bf16, 768²: the
    weights of ``random_pipeline("2.1", seed=0)`` written as an fp16 LDM
    single file (``to_ldm_single_file_21``: UNet, VAE, OpenCLIP-H under
    ``cond_stage_model.model.`` with a 24th resblock), converted by the
    port's ``tools/convert_checkpoint.py --family sd21`` in a subprocess,
    the tokenizer written beside it, then loaded by ``cli.load_pipe("2.1")``
    through ``sd_mapping.sd_maps`` (every tensor bitwise the written fp16
    value); then the main path through the user's calls on the loaded pipe:
    ``cli.invert`` (DDIM, batch 1) and ``cli.run_method("p2p")`` (replace,
    CFG batch 4, LocalBlend's words given: at 768² no 256-token site exists,
    so it idles, as in JAX), with exact launches: 16 a UNet forward, 800 +
    800. Returns (launches, the CFG-4 UNet ms, the loaded pipe)."""
    import os

    from image_editing_framework_torch import cli, sd_mapping
    from image_editing_framework_torch.core.config import P2PConfig, SamplerConfig
    from image_editing_framework_torch.methods import common
    from image_editing_framework_torch.pipelines import random_pipeline

    version, name, side, _ = FAMILIES["sd21"]
    sites = SITES["sd21"]
    here = os.path.dirname(os.path.abspath(__file__))
    pipe, setup_s = timed(lambda: random_pipeline(version, num_steps=STEPS, dtype=torch.bfloat16, seed=0,
                                                  device="cuda"))
    vocab, merges = synthetic_clip_vocab(CKPT_WORDS + " ".join(PROMPTS).split())
    saved = dict(sd_mapping.sd_maps)
    with tempfile.TemporaryDirectory(prefix="ief_sd21_", dir=root) as tmp:
        (single, single_bytes), write_s = timed(lambda: write_single_file(
            to_ldm_single_file_21(pipe), os.path.join(tmp, "single"), vocab, merges))
        snapshot = os.path.join(tmp, "converted")
        t0 = time.perf_counter()
        tool = subprocess.run([sys.executable, "-m", "image_editing_framework_torch.tools.convert_checkpoint",
                               single, snapshot, "--family", "sd21"], cwd=here, capture_output=True, text=True)
        convert_s = time.perf_counter() - t0
        if tool.returncode != 0:
            raise AssertionError(f"convert_checkpoint exited {tool.returncode}:\n{tool.stdout[-2000:]}"
                                 f"{tool.stderr[-4000:]}")
        write_tokenizer(os.path.join(snapshot, "tokenizer"), vocab, merges)
        try:
            sd_mapping.sd_maps[version] = snapshot
            loaded, load = measured_load(lambda: cli.load_pipe(version))
        finally:
            sd_mapping.sd_maps.clear()
            sd_mapping.sd_maps.update(saved)
    unequal = [k for part in ("unet", "vae", "text_encoder")
               for k in unequal_tensors(part, getattr(loaded, part), getattr(loaded, part), getattr(pipe, part))]
    if unequal:
        raise AssertionError(f"{len(unequal)} tensors of the converted SD2.1 load differ from the weights written "
                             f"through fp16: {unequal[:5]}")
    layers = len(loaded.text_encoder.text_model.encoder.layers)
    unet_params = sum(p.numel() for p in loaded.unet.parameters())
    del pipe
    torch.cuda.empty_cache()

    image = (np.random.RandomState(0).rand(side, side, 3) * 255).astype(np.uint8)
    cfg = P2PConfig(edit_type="replace", blend_words=(("cat",), ("dog",)))
    sampler = SamplerConfig(num_inference_steps=STEPS, height=side, width=side)
    ctx, _ = common.prepare_conditioning(loaded, PROMPTS, side, side)
    lat4 = torch.randn(4, side // 8, side // 8, 4, device="cuda", dtype=torch.bfloat16)
    unet_ms = cuda_ms(lambda: loaded.unet_apply(lat4, 501, ctx), min_ms=500.0)
    unet_b1_ms = cuda_ms(lambda: loaded.unet_apply(lat4[:1], 501, ctx[2:3]), min_ms=500.0)
    del lat4, ctx

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    (last, traj, _), invert_s = timed(lambda: cli.invert(loaded, image, PROMPTS[0], "ddim", "p2p"))
    inv_counts = launch_counts()
    images, edit_s = timed(lambda: np.stack(cli.run_method("p2p", loaded, PROMPTS, last, sampler,
                                                           method_kwargs={"config": cfg})))
    counts = launch_counts()
    if inv_counts != (sites * STEPS, 0, 0) or counts != (2 * sites * STEPS, 0, 0):
        raise AssertionError(f"the SD2.1 main path launched (forward, dQ, dK/dV) {inv_counts} in the inversion and "
                             f"{counts} in all, expected {sites} a UNet forward")
    if images.shape != (2, side, side, 3) or images.dtype != np.uint8 or any(img.std() == 0 for img in images):
        raise AssertionError(f"SD2.1 edit output {images.shape} {images.dtype} constant or misshapen")
    if not (torch.isfinite(traj.float()).all() and torch.isfinite(last.float()).all()):
        raise AssertionError("the SD2.1 inversion produced non-finite latents")
    emit("sd21_path", model=f"{name} (random weights, seed 0, written as an fp16 single file, converted, loaded "
                            f"bf16)", resolution=side, dtype="bfloat16", steps=STEPS, unet_params=unet_params,
         text_layers=layers, setup_s=setup_s, write_s=write_s, single_file_gb=single_bytes / 1e9,
         convert_s=convert_s, convert_output=tool.stdout.strip().splitlines(), load_s=load["s"], load_gb=load["gb"],
         load_gb_per_s=load["gb_per_s"], load_components=load["components"],
         host_peak_rss_gib=load["host_peak_rss_gib"], device_load_peak_gib=load["device_load_peak_gib"],
         loads_bitwise_equal=True, invert_s=invert_s, edit_and_decode_s=edit_s, image_s=invert_s + edit_s,
         unet_forward_cfg4_ms=unet_ms, unet_forward_b1_ms=unet_b1_ms, flash_launches=counts[0],
         inversion_launches=inv_counts[0], flash_launches_per_forward=sites, bwd_launches=counts[1:],
         peak_gib=torch.cuda.max_memory_allocated() / 2**30, image_means=[float(img.mean()) for img in images],
         card=card_line())
    return counts[0], unet_ms, loaded


def phase_nti_path(model, pipe):
    """The same edit through null-text inversion, the reference's default:
    ``cli.invert(..., "null-text", "p2p")`` (DDIM inversion, then 50 steps of
    Adam iterations on the unconditional embedding) and
    ``p2p_edit(uncond_seq=...)``. SD1.5 runs the default NTIConfig with
    SD_INNER_STEPS inner iterations per step. SDXL runs its own schedule (each step from
    the original embedding, the negative pooled embeds on the unconditional
    branch, the checkpointed UNet by the auto rule at latent side 128) at
    full width with XL_INNER_STEPS inner iterations per step, on a schedule
    of every XL_NTI_STRIDE-th step (the pipe's schedule swapped for the
    run): with random weights the early stop never fires, and 500
    iterations of a 2.6B-parameter forward, recomputation and backward
    would take minutes. SD2.1 (``sd21_path``'s loaded pipe, 768²) is cut as
    SDXL is, on the plain UNet (the checkpointed one is XL's at 1024²)."""
    from image_editing_framework_torch import cli
    from image_editing_framework_torch.core.config import NTIConfig, P2PConfig, SamplerConfig
    from image_editing_framework_torch.core.scheduler import make_ddim_schedule
    from image_editing_framework_torch.inversion import nti
    from image_editing_framework_torch.methods.p2p import p2p_edit

    _, name, side, width = FAMILIES[model]
    image = (np.random.RandomState(1).rand(side, side, 3) * 255).astype(np.uint8)
    cfg = P2PConfig(edit_type="replace", blend_words=(("cat",), ("dog",)))
    steps = STEPS if model == "sd" else STEPS // XL_NTI_STRIDE
    sampler = SamplerConfig(num_inference_steps=steps, height=side, width=side)
    inner_steps = SD_INNER_STEPS if model == "sd" else XL_INNER_STEPS

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
    full_schedule = pipe.scheduler
    pipe.scheduler = full_schedule if steps == STEPS else make_ddim_schedule(steps)
    try:
        (last, traj, uncond_seq), invert_s = timed(lambda: cli.invert(pipe, image, PROMPTS[0], "null-text", "p2p"))
        cli.null_text_inversion, cli.nti_config_for = inner, config_for
        images, edit_s = timed(lambda: p2p_edit(pipe, PROMPTS, last, cfg, sampler, uncond_seq=uncond_seq))
    finally:
        cli.null_text_inversion, cli.nti_config_for, pipe.scheduler = inner, config_for, full_schedule
    counts = launch_counts()
    j = nti.null_text_inversion.inner_iterations

    # Forward launches of NTI: per step one conditional and one final
    # unconditional forward, and per inner iteration one forward, or two
    # with the checkpointed UNet (every block's forward is run again in the
    # backward pass). The backward kernels run at every site but the first.
    sites, grad_sites = SITES[model], GRAD_SITES[model]
    per_iteration = 2 * sites if model == "xl" else sites
    nti_counts = tuple(a - b for a, b in zip(marks["after"], marks["before"]))
    if not steps <= j <= inner_steps * steps:
        raise AssertionError(f"{j} inner iterations over {steps} steps")
    if nti_counts != (sites * 2 * steps + per_iteration * j, grad_sites * j, grad_sites * j):
        raise AssertionError(f"NTI launched (forward, dQ, dK/dV) {nti_counts} times; J = {j}")
    if counts != (sites * 4 * steps + per_iteration * j, grad_sites * j, grad_sites * j):
        raise AssertionError(f"the NTI path launched (forward, dQ, dK/dV) {counts} times; J = {j}")
    if uncond_seq.shape != (steps, 77, width) or not torch.isfinite(uncond_seq).all():
        raise AssertionError(f"NTI embeddings {tuple(uncond_seq.shape)} not finite or misshapen")
    if images.shape != (2, side, side, 3) or images.dtype != np.uint8 or images.std() == 0:
        raise AssertionError(f"edit output {images.shape} {images.dtype} constant or misshapen")
    emit(PREFIX[model] + "nti_path", model=f"{name} (random weights, seed 0)", resolution=side,
         dtype="bfloat16", steps=steps, num_inner_steps=inner_steps, base_lr=marks["config"].base_lr,
         lr_decay_span=marks["config"].lr_decay_span, checkpointed_unet=model == "xl",
         invert_s=invert_s - marks["nti_s"], nti_s=marks["nti_s"], edit_and_decode_s=edit_s,
         image_s=invert_s + edit_s, nti_share=marks["nti_s"] / (invert_s + edit_s), inner_iterations=j,
         nti_launches=nti_counts, launches=counts, uncond_moved=float((uncond_seq[-1] - uncond_seq[0]).abs().max()),
         peak_gib=torch.cuda.max_memory_allocated() / 2**30, image_mean=float(images.mean()), card=card_line())
    return counts, (last, uncond_seq, traj)


def profiling_check(forward, sites):
    """``utils/profiling.py`` on the card: one UNet forward under
    ``phase("unet_forward")`` inside ``trace(dir)``, timed by
    ``Timer.measure``; the Chrome trace it writes must name the phase and
    the flash forward kernel."""
    import os

    from image_editing_framework_torch.utils import profiling

    timer = profiling.Timer()
    with tempfile.TemporaryDirectory(prefix="ief_trace_") as log_dir:
        with profiling.trace(log_dir):
            with timer.measure("unet_forward"), profiling.phase("unet_forward"):
                forward()
        path = os.path.join(log_dir, "trace.json")
        trace_mb = os.path.getsize(path) / 1e6
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    phases = [e for e in events if e.get("name") == "unet_forward"]
    flash = [e for e in events if e.get("cat") == "kernel" and "flash_fwd" in e.get("name", "")]
    if not phases or not flash:
        raise AssertionError(f"the trace names the phase {len(phases)} times and the flash forward kernel "
                             f"{len(flash)} times")
    return dict(phase_events=len(phases), flash_fwd_kernels=len(flash), sites=sites, trace_mb=trace_mb,
                timer_s=timer.times["unet_forward"], kernel_events=sum(e.get("cat") == "kernel" for e in events))


def phase_profile(model, pipe, lat4, ctx, added):
    """Device busy time of one UNet forward under torch.profiler (the sum of
    kernel durations on the one stream), against its unprofiled time; on
    SD1.5 also ``profiling_check``."""
    from torch.profiler import ProfilerActivity, profile

    added1 = None if added is None else {k: v[2:3] for k, v in added.items()}
    for batch, lat, c, add in ((4, lat4, ctx, added), (1, lat4[:1], ctx[2:3], added1)):
        forward = lambda: pipe.unet_apply(lat, 501, c, None, add)  # noqa: E731
        wall_ms = cuda_ms(forward, min_ms=500.0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:  # every reading is of kernels
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
    if model == "sd":
        emit("profiling", **profiling_check(lambda: pipe.unet_apply(lat4, 501, ctx, None, added), SITES["sd"]),
             batch=4, card=card_line())


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
    null-text embeddings, over their steps (SDXL's: every XL_NTI_STRIDE-th).
    Exact forward launches per run, none backward."""
    from image_editing_framework_torch import cli
    from image_editing_framework_torch.core.config import SamplerConfig
    from image_editing_framework_torch.core.scheduler import make_ddim_schedule
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
    runs, full_schedule = {}, pipe.scheduler
    for label, start, kw, per_step, steps in (
            ("mutual", last, {}, sites, STEPS),
            ("union", last, dict(method_kwargs={"config": dataclasses.replace(cfg, mode="union")}), sites, STEPS),
            ("mask", last, dict(method_kwargs={"mask_s": mask_s, "mask_t": mask_t}), sites + 2 * gated, STEPS),
            ("auto", last, dict(method_kwargs={"auto_mask": True}), sites + (AUTO_CALLS[model] - 1) * gated, STEPS),
            ("nti_mutual", nti[0], dict(uncond_seq=nti[1]), sites, nti[1].shape[0])):
        reset_launch_counts()
        pipe.scheduler = full_schedule if steps == STEPS else make_ddim_schedule(steps)
        try:
            images, edit_s = timed(lambda: cli.run_method("masactrl", pipe, PROMPTS, start, sampler, **kw))
        finally:
            pipe.scheduler = full_schedule
        counts = launch_counts()
        if counts != (per_step * steps, 0, 0):
            raise AssertionError(f"MasaCtrl {label} on {model} launched (forward, dQ, dK/dV) {counts} times, "
                                 f"expected ({per_step * steps}, 0, 0)")
        if any(x.shape != (side, side, 3) or x.dtype != np.uint8 or x.std() == 0 for x in images):
            raise AssertionError(f"MasaCtrl {label} output constant or misshapen")
        runs[label] = dict(edit_and_decode_s=edit_s, flash_launches=counts[0], steps=steps, images=images)
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
# The p2z edits on the DDIM inversion take every 5th step of the 50 (10
# guided steps from the inversion trajectory's latent at that schedule's
# first timestep; SD1.5's since the gradient paths' groups joined the
# script), and the edits on the NTI path's embeddings the
# same steps (SD1.5: ``strided_nti``; SDXL: that path's own 10,
# XL_NTI_STRIDE): depth cuts that keep the script inside its time limit on
# slower hosts
XL_P2Z_NTI_STRIDE = 5


def strided_nti(nti, stride):
    """(start latent, embeddings, steps) of an edit on ``phase_nti_path``'s
    inversion (last latent, embeddings, trajectory) over every
    ``stride``-th step of its 50: the trajectory's entry at that schedule's
    first timestep and the embeddings of its steps (the k-th is the full
    schedule's step stride * k + stride - 1). An NTI run already on a cut
    schedule (SDXL's) gives its own."""
    last, seq, traj = nti
    if seq.shape[0] < STEPS:
        return last, seq, seq.shape[0]
    return traj[STEPS + 1 - stride], seq[stride - 1::stride], STEPS // stride


def phase_p2z_path(model, pipe, nti):
    """pix2pix-zero through the user entry points, bf16, 50 steps, 2
    prompts: ``cli.invert(..., "ddim", "p2z")`` and ``cli.run_method("p2z",
    ...)`` with the default configuration (SD1.5: the references recorded
    in pass 1; SDXL: recomputed from pass 1's trajectory, the checkpointed
    UNet by the auto rule at latent side 128); then the edit alone on
    ``phase_nti_path``'s inversion and embeddings (their swap in both
    passes, over every ``XL_P2Z_NTI_STRIDE``-th step: ``strided_nti``).
    The DDIM run edits over every ``XL_P2Z_NTI_STRIDE``-th step of its
    50-step inversion. Per run: seconds of pass 1, pass 2 and the decodes, exact
    launch counts, the loss of the first and last guided step. Then one
    guided step (step ``P2Z_PROBE_STEP`` from the inverted latent, SDXL's
    recomputed references included) timed alone and under torch.profiler,
    beside its gradient alone and a forward at CFG batch 2."""
    import functools

    from torch.profiler import ProfilerActivity, profile

    from image_editing_framework_torch import cli
    from image_editing_framework_torch.core.config import P2ZConfig, SamplerConfig
    from image_editing_framework_torch.core.scheduler import make_ddim_schedule
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

    runs, full_schedule = {}, pipe.scheduler
    # pass 1's final latent only: its recorded references go before the decodes
    p2z.denoise, p2z._guided_scan = measured("pass1", denoise, keep=lambda out: out[0]), measured("pass2", guided)
    pipe.latent2image = measured("decode", decode, keep=lambda out: None)
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        (last, ddim_traj, _), invert_s = timed(lambda: cli.invert(pipe, image, PROMPTS[0], "ddim", "p2z"))
        inv_counts = launch_counts()
        # every stride-th step of the schedule: its k-th step is the full
        # schedule's step stride * k + stride - 1, whose latent the inversion
        # trajectory holds at index STEPS - (stride - 1)
        stride = XL_P2Z_NTI_STRIDE
        for label, start, uncond, steps in (
                ("ddim", last if stride == 1 else ddim_traj[STEPS + 1 - stride], None, STEPS // stride),
                ("nti", *strided_nti(nti, stride))):
            marks.clear()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            pipe.scheduler = full_schedule if steps == STEPS else make_ddim_schedule(steps)
            images, edit_s = timed(lambda: cli.run_method("p2z", pipe, PROMPTS, start, sampler, uncond_seq=uncond))
            runs[label] = dict(marks, edit_s=edit_s, launches=launch_counts(), images=images, steps=steps,
                               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    finally:
        p2z.denoise, p2z._guided_scan, pipe.scheduler = denoise, guided, full_schedule
        del pipe.latent2image

    if inv_counts != (sites * STEPS, 0, 0):
        raise AssertionError(f"the p2z inversion on {model} launched (forward, dQ, dK/dV) {inv_counts} times")
    expected = (sites * STEPS + per_step * STEPS, sites * STEPS, sites * STEPS)
    lines = {}
    for label, run in runs.items():
        (final, losses), final_src, steps = run["pass2"], run["pass1"], run["steps"]
        want = tuple(n // STEPS * steps for n in expected)  # each count is per step
        if run["launches"] != want or run["pass2_launches"] != (per_step * steps,) + want[1:]:
            raise AssertionError(f"p2z {label} on {model} launched (forward, dQ, dK/dV) {run['launches']} times "
                                 f"(pass 2: {run['pass2_launches']}), expected {want}")
        moved = (final.float() - final_src.float()).abs().max().item()
        if not (torch.isfinite(losses).all() and losses.shape == (steps,) and math.isfinite(moved) and moved > 0):
            raise AssertionError(f"p2z {label} on {model}: losses {losses}, edit moved {moved} from pass 1")
        if any(x.shape != (side, side, 3) or x.dtype != np.uint8 or x.std() == 0 for x in run["images"]):
            raise AssertionError(f"p2z {label} output constant or misshapen")
        lines[label] = dict(
            pass1_s=run["pass1_s"], pass2_s=run["pass2_s"], decode_s=run["decode_s"], edit_and_decode_s=run["edit_s"],
            steps=steps, guided_step_s=run["pass2_s"] / steps, launches=run["launches"],
            pass2_launches=run["pass2_launches"],
            loss_first=losses[0].item(), loss_last=losses[-1].item(), edit_moved_from_source=moved,
            image_means=[float(x.mean()) for x in run["images"]], peak_gib=run["peak_gib"])
    lines["ddim"].update(invert_s=invert_s, image_s=invert_s + runs["ddim"]["edit_s"],
                         image_launches=tuple(a + b for a, b in zip(inv_counts, runs["ddim"]["launches"])),
                         inversion_launches=inv_counts)
    tag = "p2z_path" if model == "sd" else "xl_p2z_path"
    for label, line in lines.items():
        emit(tag, run=label, model=f"{name} (random weights, seed 0)", resolution=side, dtype="bfloat16",
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
    t0 = time.perf_counter()
    with torch.no_grad():
        step_ms, gradient_ms, forward_ms = (cuda_ms(fn, min_ms=500.0, warmup=1) for fn in (step, gradient, forward))
    t1 = time.perf_counter()
    # the card's activity alone: every reading below is of kernels, and the
    # host ops' events made key_averages take about a minute at SDXL
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_REPS):
            step()
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    probe_s = dict(timing=t1 - t0, profiled_steps=t2 - t1, key_averages=time.perf_counter() - t2)
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
         flash_bwd_share_of_busy=(kernel_ms("bwd_dq") + kernel_ms("bwd_dkv")) / busy, probe_s=probe_s,
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


# ------------------------------------------------------- context parallelism
# The cp_path phase runs its ranks as processes of their own (``cp_rank``),
# one gloo group of 4 and then one of 2 on the one card (NCCL refuses two
# ranks on one device; with as many cards as ranks a group takes NCCL, one
# card each). Every check below runs on every rank.

CP_SITES = {"xl": (4, 10, 4096, 64), "sd": (4, 8, 4096, 40)}  # the 4096-token sites' (B, H, N, D), CFG batch 4
CP_GRAD_BATCHES = (1, 2)  # the ring's backward at NTI's batch and p2z's CFG batch, SDXL's site
CP_UNET_CONFIG = "SDXL_UNET"  # (b)'s UNet, in models/configs.py
CP_MIN_SEQ = 4096  # the UNet's cp_min_seq: the sites at SDXL 1024²'s 64 x 64 latent level run context-parallel
CP_BIG_SITES = 10  # SDXL 1024²'s self-attention sites at 4096 tokens (of 70)
CP_UNET_RTOL = 1e-3  # the f32 SDXL UNet forward with CP against the same forward without CP, of max|ref|
CP_TIME_REPS = 10  # fixed on every rank: a timed loop of collectives must run the same count everywhere
CP_GROUP_TIMEOUT_S = 480
CP_COLLECTIVE_TIMEOUT_S = 300


def cp_plain(q, k, v, bias=None):
    """The flash forward's plain version, one batch row at a time (four rank
    processes share the card's memory)."""
    from image_editing_framework_torch.ops import flash_attention as fa

    return torch.cat([fa.flash_attention_reference(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                                   None if bias is None else bias[i:i + 1])
                      for i in range(q.shape[0])])


def cp_neg_inf_bias(b, nk, count, device):
    """A (B, Nk) f32 bias whose chunk 0 (rank 0's own keys) is all NEG_INF:
    rank 0's own block and, in the ring, every other rank's block that
    meets it are fully masked for every row."""
    from image_editing_framework_torch.ops.flash_attention import NEG_INF

    bias = torch.zeros((b, nk), device=device)
    bias[:, :nk // count] = NEG_INF
    return bias


def cp_ring_backward_variant(q, k, v, out, g, lse, group, sm_scale, home=True, global_lse=True):
    """The ring backward on this rank's shards with a planted fault: without
    the final rotation that sends each block's (dk, dv) home, or with each
    block's gradient taken against this rank's own block's lse in place of
    the global one. ``RingAttention.backward`` is the sound version."""
    from image_editing_framework_torch.ops import flash_attention as fa
    from image_editing_framework_torch.parallel import ring_attention as ra

    if not global_lse:
        lse = fa.flash_attention(q, k, v, None, sm_scale, return_lse=True)[1]
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, None, out, g, lse, sm_scale)
    kb, vb = k, v
    for _ in range(torch.distributed.get_world_size(group) - 1):
        kb, vb, dk, dv = ra._rotate([kb, vb, dk, dv], group)
        dq_i, dk_i, dv_i = fa.flash_attention_bwd(q, kb, vb, None, out, g, lse, sm_scale)
        dq, dk, dv = dq + dq_i, dk + dk_i, dv + dv_i
    if home:
        dk, dv = ra._rotate([dk, dv], group)
    return dq, dk, dv


def cp_timed(fn, reps=CP_TIME_REPS):
    """Mean host ms of fn() over ``reps`` calls after 2 warm-up calls, from
    one synchronize to the next (the same count on every rank)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def cp_kernel_checks(mesh, mesh2d, world, device):
    """(a): ring, Ulysses and 2D attention at the 4096-token sites against
    the unsharded forward kernel and the plain version, through
    ``context_parallel_attention`` (each rank's chunk, the ranks' outputs
    all-gathered); the ring's backward against the unsharded backward
    kernels and the plain version, and its planted faults."""
    from image_editing_framework_torch.ops import flash_attention as fa
    from image_editing_framework_torch.parallel import ring_attention as ra

    gen = torch.Generator(device=device).manual_seed(15)  # the same inputs on every rank
    rows = []

    def check(name, mode, q, k, v, bias, expect_launches, axis="data", m=mesh):
        reset_launch_counts()
        out = ra.context_parallel_attention(q, k, v, bias, m, axis, mode)
        got = launch_counts()
        kern = fa.flash_attention(q, k, v, bias)
        plain = cp_plain(q, k, v, bias)
        torch.cuda.synchronize()
        err_plain = (out.float() - plain.float()).abs().max().item()
        err_kern = (out.float() - kern.float()).abs().max().item()
        tol_plain, tol_kern = fa.parity_atol(plain), fa.parity_atol(kern)
        row = dict(name=name, mode=mode, world=world, shape=list(q.shape), nk=k.shape[2], dtype=str(q.dtype)[6:],
                   max_abs_err=err_plain, limit=tol_plain, max_abs_err_vs_kernel=err_kern, limit_vs_kernel=tol_kern,
                   launches=got[0])
        if got != (expect_launches, 0, 0):
            raise AssertionError(f"cp {name}: launched (forward, dQ, dK/dV) {got}, expected ({expect_launches}, 0, 0)")
        if not (err_plain <= tol_plain and err_kern <= tol_kern):
            raise AssertionError(f"cp {name}: {row}")
        rows.append(row)

    for model, (b, h, n, d) in CP_SITES.items():
        for dtype in ((torch.bfloat16, torch.float32) if model == "xl" else (torch.bfloat16,)):
            q, k, v = (torch.randn(b, h, n, d, device=device, dtype=dtype, generator=gen) for _ in range(3))
            check(f"{model}_ring_{str(dtype)[6:]}", "ring", q, k, v, None, world)
            if h % world == 0:
                check(f"{model}_ulysses_{str(dtype)[6:]}", "ulysses", q, k, v, None, 1)
            else:  # SDXL's 10 heads on 4 ranks: every rank refuses, as the JAX package asserts
                try:
                    ra.context_parallel_attention(q, k, v, None, mesh, "data", "ulysses")
                except AssertionError as e:
                    if str(e) != "Ulysses needs heads % devices == 0":
                        raise
                else:
                    raise AssertionError(f"Ulysses took {h} heads on {world} ranks")
            if model == "xl" and mesh2d is not None:
                check(f"xl_2d_{str(dtype)[6:]}", "ulysses_ring", q, k, v, None, 2, ("tensor", "data"), mesh2d)
            if model == "xl" and dtype == torch.bfloat16:
                check("xl_ring_neg_inf_shard", "ring", q, k, v, cp_neg_inf_bias(b, n, world, device), world)
    # MasaCtrl union at Nk = 8192 (two segments) with its segment bias, as
    # the plan path hands it over (an ungated step: the targets' source
    # segment masked)
    b, h, n, d = CP_SITES["xl"]
    q, k, v, bias = bias_operands("union", b, h, n, d, gen, device=device)
    check("xl_ring_union_8192", "ring", q, k, v, bias, world)

    # the ring's backward: dq, dk, dv of sum(out * do) through the boundary
    group = mesh.get_group("data")
    index, count = ra._chunk(mesh, "ring", "data")[:2]
    grads = []
    for gb in CP_GRAD_BATCHES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn(gb, h, n, d, device=device, dtype=dtype, generator=gen) for _ in range(4))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = ra.context_parallel_attention(*leaves, None, mesh, "data", "ring")
            reset_launch_counts()
            out.backward(do)
            got = launch_counts()
            if got != (0, world, world):
                raise AssertionError(f"the ring backward launched (forward, dQ, dK/dV) {got}, expected (0, {world}, "
                                     f"{world})")
            o, lse = fa.flash_attention(q, k, v, None, return_lse=True)
            kern = fa.flash_attention_bwd(q, k, v, None, o, do, lse)
            po, plse = fa.flash_attention_reference(q, k, v, return_lse=True)
            plain = fa.flash_attention_bwd_reference(q, k, v, None, po, do, plse)

            # the planted faults, on this rank's shards
            size = n // count
            sl = [t.narrow(2, index * size, size).contiguous() for t in (q, k, v, do)]
            scale = 1.0 / math.sqrt(d)
            with torch.no_grad():
                o_s, lse_s = ra._ring_forward(*sl[:3], None, group, scale)
            faults = {}
            for fault, kw in (("no_home_rotation", dict(home=False)), ("local_lse", dict(global_lse=False))):
                parts = cp_ring_backward_variant(*sl[:3], o_s, sl[3], lse_s, group, scale, **kw)
                faults[fault] = [ra._gather_chunks(p, [group], 2) for p in parts]
            torch.cuda.synchronize()
            row = dict(batch=gb, dtype=str(dtype)[6:], shape=[gb, h, n, d], launches=list(got[1:]))
            for j, name in enumerate(("dq", "dk", "dv")):
                got_g = leaves[j].grad.float()
                tol = fa.grad_parity_atol(plain[j])
                err, err_k = (got_g - plain[j].float()).abs().max().item(), (got_g - kern[j].float()).abs().max().item()
                tol_k = fa.grad_parity_atol(kern[j])
                row[name] = dict(max_abs_err=err, limit=tol, max_abs_err_vs_kernel=err_k, limit_vs_kernel=tol_k,
                                 faults={f: (p[j].float() - plain[j].float()).abs().max().item()
                                         for f, p in faults.items()})
                if not (err <= tol and err_k <= tol_k):
                    raise AssertionError(f"the ring's {name} disagrees: {row[name]}")
            for fault in faults:  # each fault must move some gradient past its limit
                if not any(row[g]["faults"][fault] > row[g]["limit"] for g in ("dq", "dk", "dv")):
                    raise AssertionError(f"the planted fault {fault} passed the ring backward's gate: {row}")
            grads.append(row)

    # times at SDXL's site, bf16: the ring per site on every rank at once
    # (host clock, gloo's host copies included), and its kernels alone
    q, k, v = (torch.randn(*CP_SITES["xl"], device=device, dtype=torch.bfloat16, generator=gen) for _ in range(3))
    ring_ms = cp_timed(lambda: ra.context_parallel_attention(q, k, v, None, mesh, "data", "ring"))
    times = dict(ring_wall_ms_per_site=ring_ms)
    torch.distributed.barrier(group)
    if index == 0:  # alone on the card: the other ranks wait at the barrier
        qs, ks, vs = (t.narrow(2, 0, n // count).contiguous() for t in (q, k, v))
        shard_ms = cuda_ms(lambda: fa.flash_attention(qs, ks, vs, return_lse=True))
        times.update(ring_kernel_ms_per_site=count * shard_ms, shard_kernel_ms=shard_ms,
                     unsharded_kernel_ms=cuda_ms(lambda: fa.flash_attention(q, k, v)))
    torch.distributed.barrier(group)
    return dict(forward=rows, backward=grads, times=times)


def cp_unet_forward(mesh, device, tp_mesh=None, grads=False):
    """(b): one SDXL 1024² CFG-4 UNet forward, f32, seeded random weights
    built in each rank, with the ring and with Ulysses against the same
    forward without CP on the same rank; the ranks' weights equal by an
    all-gathered checksum; exact launches. With ``grads``, then (e1) on the
    same module (``cp_unet_gradients``). With ``tp_mesh``, then (d1) on
    the same module: split over "tensor", the same forward
    (``tp_unet_forward``), under ``res["tp"]``."""
    from image_editing_framework_torch.models import configs
    from image_editing_framework_torch.models.unet import UNet2DCondition
    from image_editing_framework_torch.parallel import ring_attention as ra
    from image_editing_framework_torch.pipelines import _build

    group = mesh.get_group("data")
    world = torch.distributed.get_world_size(group)
    cfg = getattr(configs, CP_UNET_CONFIG)
    unet = _build(UNet2DCondition, cfg, device, torch.float32, 0)
    checksum = torch.stack([sum(p.double().sum() for p in unet.parameters()),
                            sum(p.double().abs().sum() for p in unet.parameters())])
    sums = ra._all_gather(checksum, group)
    if not all(torch.equal(s, sums[0]) for s in sums):
        raise AssertionError(f"the ranks built other weights: checksums {sums.tolist()}")
    gen = torch.Generator(device=device).manual_seed(16)
    side = MODELS["xl"][2]
    lat = torch.randn(4, side // 8, side // 8, 4, device=device, generator=gen)
    ctx = torch.randn(4, 77, cfg.cross_attention_dim, device=device, generator=gen)
    pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
    added = {"text_embeds": torch.randn(4, pooled, device=device, generator=gen),
             "time_ids": torch.tensor([side, side, 0.0, 0.0, side, side], device=device).expand(4, 6)}
    sites = unet.config.num_transformer_blocks
    res = {}
    with torch.no_grad():
        ref = unet(lat, 501, ctx, None, added)[0]
        for mode, per_site in (("ring", world), ("ulysses", 1)):
            unet.set_context_parallel(mesh, CP_MIN_SEQ, mode)
            reset_launch_counts()
            (out, _), seconds = timed(lambda: unet(lat, 501, ctx, None, added))
            got = launch_counts()
            unet.set_context_parallel(None)
            want = sites - CP_BIG_SITES + CP_BIG_SITES * per_site
            err, tol = (out - ref).abs().max().item(), CP_UNET_RTOL * ref.abs().max().item()
            res[mode] = dict(max_abs_err=err, limit=tol, max_abs_ref=ref.abs().max().item(), launches=got[0],
                             expected_launches=want, seconds=seconds)
            if got != (want, 0, 0) or not err <= tol:
                raise AssertionError(f"the SDXL UNet with {mode} CP: {res[mode]}, launches {got}")
    res["checksum"] = checksum.tolist()
    if grads:
        res["grad"] = cp_unet_gradients(unet, mesh, lat, ctx, added)
    if tp_mesh is not None:
        res["tp"] = tp_unet_forward(unet, tp_mesh, lat, 501, ctx, added, ref)
    del unet, ref
    torch.cuda.empty_cache()
    return res


def cp_main_path(mesh, device):
    """(c): the SDXL 1024² main path under the ring, bf16, on
    ``xl_nti_path``'s 10-step schedule (every ``XL_NTI_STRIDE``-th step of
    50: its gates, launches per forward, finiteness and equal images on both
    ranks, keep their meaning at any depth): DDIM inversion through
    ``cli.invert``, the P2P replace edit at CFG batch 4 and the decode
    through ``cli.run_method``; exact launches. Returns (the line, (the
    pipe, the inverted latent, the inversion trajectory) for (e))."""
    import hashlib

    from image_editing_framework_torch import cli
    from image_editing_framework_torch.core.config import P2PConfig, SamplerConfig
    from image_editing_framework_torch.pipelines import random_pipeline

    world = torch.distributed.get_world_size(mesh.get_group("data"))
    side = MODELS["xl"][2]
    steps = STEPS // XL_NTI_STRIDE
    (pipe, setup_s) = timed(lambda: random_pipeline("xl", num_steps=steps, dtype=torch.bfloat16, seed=0,
                                                    device=device))
    pipe.unet.set_context_parallel(mesh, CP_MIN_SEQ, "ring")
    image = (np.random.RandomState(0).rand(side, side, 3) * 255).astype(np.uint8)
    cfg = P2PConfig(edit_type="replace", blend_words=(("cat",), ("dog",)))
    sampler = SamplerConfig(num_inference_steps=steps, height=side, width=side)
    reset_launch_counts()
    (last, traj, _), invert_s = timed(lambda: cli.invert(pipe, image, PROMPTS[0], "ddim", "p2p"))
    inv_counts = launch_counts()
    images, edit_s = timed(lambda: cli.run_method("p2p", pipe, PROMPTS, last, sampler,
                                                  method_kwargs={"config": cfg}))
    counts = launch_counts()
    per_forward = SITES["xl"] - CP_BIG_SITES + CP_BIG_SITES * world
    per_pass = per_forward * STEPS // XL_NTI_STRIDE
    if inv_counts != (per_pass, 0, 0) or counts != (2 * per_pass, 0, 0):
        raise AssertionError(f"the main path under the ring launched (forward, dQ, dK/dV) {inv_counts} in the "
                             f"inversion and {counts} in all, expected {per_forward} per UNet forward")
    for img in images:
        if img.shape != (side, side, 3) or img.dtype != np.uint8 or img.std() == 0:
            raise AssertionError(f"the main path under the ring gave a constant or misshapen image {img.shape}")
    if not torch.isfinite(traj.float()).all():
        raise AssertionError("the inversion under the ring gave non-finite latents")
    line = dict(steps=steps, setup_s=setup_s, invert_s=invert_s, edit_and_decode_s=edit_s, image_s=invert_s + edit_s,
                launches=counts[0], inversion_launches=inv_counts[0], launches_per_unet_forward=per_forward,
                image_sha256=[hashlib.sha256(img.tobytes()).hexdigest() for img in images],
                image_means=[float(img.mean()) for img in images], peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return line, (pipe, last, traj)


CP_NTI_STEPS = 5  # (e2): every 10th step of the 50, from (c)'s 10-step trajectory
CP_NTI_EPSILON = 20.0  # (e2)'s: its steps' first losses ran 8.0 and 18.0 at steps 0 and 2, 22.0-24.5 at the others
TP_NTI_EPSILON = 1.8  # (d4)'s: its step losses ran 0.05-1.37 at steps 0-3, 2.45-7.85 after


def cp_unet_gradients(unet, mesh, lat, ctx, added, min_seq=CP_MIN_SEQ, big_sites=CP_BIG_SITES):
    """(e1), f32: the gradients of a fixed random projection of the UNet's
    output with respect to its input latent and its context, through the
    checkpointed UNet (``remat=True``), at NTI's batch 1 and p2z's CFG batch
    2 (CP_GRAD_BATCHES), under the ring against the same unsharded in this
    rank: within GRAD_RTOL · max|ref|; exact launches (every site's forward
    twice, the checkpointed blocks' again in the backward pass, and the
    backward at every site, a ring site's n times); digests for the ranks
    to compare. ``big_sites``: the sites at ``min_seq`` tokens or more."""
    device = lat.device
    world = torch.distributed.get_world_size(mesh.get_group("data"))
    sites = unet.config.num_transformer_blocks
    per_forward = sites - big_sites + big_sites * world
    proj = torch.randn(lat.shape, device=device, generator=torch.Generator(device=device).manual_seed(19))
    res = {}
    for b in CP_GRAD_BATCHES:
        extra = None if added is None else {k: v[:b] for k, v in added.items()}

        def gradients():
            x, c = (t[:b].clone().requires_grad_(True) for t in (lat, ctx))
            with torch.enable_grad():
                eps = unet(x, 501, c, None, extra, remat=True)[0]
                return torch.autograd.grad((eps.float() * proj[:b]).sum(), (x, c))

        ref = gradients()
        unet.set_context_parallel(mesh, min_seq, "ring")
        reset_launch_counts()
        try:
            got, seconds = seconds_of(gradients, device)
        finally:
            unet.set_context_parallel(None)
        counts, want = tp_counts(device), tp_want(device, 2 * per_forward, per_forward, per_forward)
        if counts != want:
            raise AssertionError(f"cp the gradients at batch {b} launched (forward, dQ, dK/dV) {counts}, expected "
                                 f"{want}")
        res[f"batch{b}"] = dict(
            latent=rel_held(f"cp the latent's gradient at batch {b}", got[0], ref[0], GRAD_RTOL),
            context=rel_held(f"cp the context's gradient at batch {b}", got[1], ref[1], GRAD_RTOL),
            launches=list(counts), seconds=seconds, digest=tp_digest(torch.cat([g.flatten() for g in got])))
    return res


def trajectory_at(traj, full, short):
    """The entries of ``full``'s inversion trajectory (S+1, ...) at
    ``short``'s inversion timesteps: its first (the clean latent) and, for
    each step of ``short``, the one after ``full``'s step at that
    timestep."""
    from image_editing_framework_torch.core.scheduler import inversion_timestep

    at = {inversion_timestep(full, j): j + 1 for j in range(full.num_steps)}
    return traj[[0] + [at[inversion_timestep(short, m)] for m in range(short.num_steps)]]


def ring_grad_paths(pipe, side, last, traj, epsilon, per_forward, nti_grad_sites, p2z_grad_sites, remat=None):
    """(e2) and (e3): NTI and pix2pix-zero under the ring on (c)'s pipe
    (``side``² images),
    its 10-step schedule and its inversion, bf16. (e2): ``nti_batch`` of one
    image over CP_NTI_STEPS steps (``trajectory_at`` of (c)'s trajectory),
    2 inner iterations a step at ``epsilon``, the checkpointed UNet by the
    auto rule (``remat`` forces it). (e3): ``cli.run_method("p2z", ...)``
    from (c)'s inverted latent. Gates: exact launches per rank (a UNet
    forward ``per_forward``, NTI's backward ``nti_grad_sites``, p2z's
    ``p2z_grad_sites``); finite embeddings and latents; non-constant
    images. The ranks' stops, embeddings and images are compared by the
    caller (their digests)."""
    import functools
    import hashlib

    from image_editing_framework_torch import cli
    from image_editing_framework_torch.core.config import P2ZConfig, SamplerConfig
    from image_editing_framework_torch.eval import batched
    from image_editing_framework_torch.methods import common

    device, full = last.device, pipe.scheduler
    checkpointed = isinstance(common.grad_unet(pipe, traj.shape[-3], remat), functools.partial)
    with steps_schedule(pipe, CP_NTI_STEPS) as short:
        trajectory = trajectory_at(traj, full, short)
        cfg = dataclasses.replace(cli.nti_config_for("p2p", pipe), num_inner_steps=GRAD_INNER_STEPS,
                                  epsilon=epsilon, remat=remat)
        reset_launch_counts()
        with nti_recorded() as seen:
            (seqs, stops), nti_s = seconds_of(
                lambda: batched.nti_batch(pipe, trajectory[None], PROMPTS[:1], cfg, return_stops=True), device)
    counts, inner = tp_counts(device), sum(max(step) for step in stops)
    want = tp_want(device, *nti_launches(per_forward, nti_grad_sites, CP_NTI_STEPS, inner, checkpointed))
    if counts != want or not torch.isfinite(seqs).all():
        raise AssertionError(f"cp NTI under the ring launched (forward, dQ, dK/dV) {counts} over {inner} inner "
                             f"iterations, expected {want} (or its embeddings are not finite)")
    losses = [[float(v) for v in loss.flatten().tolist()] for loss in seen["losses"]]
    nti_line = dict(steps=CP_NTI_STEPS, epsilon=epsilon, stops=[step[0] for step in stops], inner_iterations=inner,
                    losses=losses, launches=list(counts), seconds=nti_s, digest=tp_digest(seqs),
                    checkpointed_unet=checkpointed)

    finals, decode = [], pipe.latent2image

    def recording(lat, **kw):
        finals.append(lat)
        return decode(lat, **kw)

    sampler = SamplerConfig(num_inference_steps=full.num_steps, height=side, width=side)
    config = P2ZConfig(recompute_refs=pipe.model_type == "xl", remat_grad=remat)
    pipe.latent2image = recording
    reset_launch_counts()
    try:
        images, p2z_s = seconds_of(lambda: cli.run_method("p2z", pipe, PROMPTS, last, sampler,
                                                          method_kwargs={"config": config}), device)
    finally:
        del pipe.latent2image
    counts = tp_counts(device)
    want = tp_want(device, *p2z_launches(per_forward, full.num_steps, config.recompute_refs, checkpointed,
                                         inverted=False, grad_sites=p2z_grad_sites))
    if counts != want or not all(torch.isfinite(f.float()).all() for f in finals):
        raise AssertionError(f"cp p2z under the ring launched (forward, dQ, dK/dV) {counts}, expected {want} (or "
                             f"its latents are not finite)")
    for img in images:
        if img.shape != (side, side, 3) or img.dtype != np.uint8 or img.std() == 0:
            raise AssertionError(f"cp p2z under the ring gave a constant or misshapen image {img.shape}")
    p2z_line = dict(steps=full.num_steps, launches=list(counts), seconds=p2z_s, recompute_refs=config.recompute_refs,
                    checkpointed_unet=checkpointed,
                    image_sha256=[hashlib.sha256(img.tobytes()).hexdigest() for img in images],
                    image_means=[float(img.mean()) for img in images])
    return dict(nti=nti_line, p2z=p2z_line)


def tp_p2z_step(pipe, latent_side, inputs=None):
    """(d5) f32: one pix2pix-zero guided step's loss and its gradient with
    respect to the CFG pair's latent (``p2z.guidance_gradient``: every
    recorded cross map's heads gathered under autograd). Called first
    unsharded (``inputs`` None), it makes the inputs (a seeded pair whose
    halves differ, the target context, a source forward's references);
    called again under tensor parallelism on the same inputs. Returns
    (inputs, loss, gradient, launches, seconds)."""
    from image_editing_framework_torch.methods import p2z
    from image_editing_framework_torch.methods.common import prepare_conditioning
    from image_editing_framework_torch.ops.controls import P2ZStep

    device = pipe.device
    if inputs is None:
        gen = torch.Generator(device=device).manual_seed(20)
        x, src = (torch.randn(P2Z_BATCH, latent_side, latent_side, 4, device=device, generator=gen) for _ in range(2))
        t = int(pipe.scheduler.timesteps[TP_STEP])
        with torch.no_grad():
            ctx_src, _ = prepare_conditioning(pipe, PROMPTS[:1], latent_side, latent_side)
            ctx, _ = prepare_conditioning(pipe, PROMPTS[1:], latent_side, latent_side)
            _, ref = pipe.unet(src, t, ctx_src, P2ZStep())
        inputs = dict(x=x, t=t, ctx=ctx, ref=ref)
    reset_launch_counts()
    (loss, grad), seconds = seconds_of(
        lambda: p2z.guidance_gradient(pipe.unet, inputs["x"], inputs["t"], inputs["ctx"], inputs["ref"]), device)
    return inputs, loss, grad, tp_counts(device), seconds


def tp_grad_paths(pipe, side, epsilon=TP_NTI_EPSILON):
    """(d4) and (d5): NTI and pix2pix-zero under tensor parallelism on (d)'s
    pipe (bf16 on the card, f32 in the CPU rehearsal), on a 10-step
    schedule: the DDIM inversion of a seeded ``side``² image
    (``cli.invert``), ``nti_batch`` of it (``GRAD_INNER_STEPS`` inner
    iterations a step at ``epsilon``; NTI's stop in lockstep over the
    tensor mesh), ``cli.run_method("p2z", ...)`` from the inverted latent.
    Gates: exact launches (one a site, on H/n heads), finite embeddings and
    latents, non-constant images; the ranks' digests and stops are compared
    by ``tp_line``."""
    import hashlib

    from image_editing_framework_torch import cli
    from image_editing_framework_torch.core.config import NTIConfig, SamplerConfig
    from image_editing_framework_torch.eval import batched

    device, sites = pipe.device, pipe.unet.config.num_transformer_blocks
    steps = STEPS // GRAD_STRIDE
    image = (np.random.RandomState(21).rand(side, side, 3) * 255).astype(np.uint8)
    with steps_schedule(pipe, steps):
        (last, traj, _), invert_s = seconds_of(lambda: cli.invert(pipe, image, PROMPTS[0], "ddim", "p2p"), device)
        cfg = NTIConfig(num_inner_steps=GRAD_INNER_STEPS, epsilon=epsilon)
        reset_launch_counts()
        with nti_recorded() as seen:
            (seqs, stops), nti_s = seconds_of(
                lambda: batched.nti_batch(pipe, traj[None], PROMPTS[:1], cfg, return_stops=True), device)
        counts, inner = tp_counts(device), sum(max(step) for step in stops)
        want = tp_want(device, *nti_launches(sites, sites - 1, steps, inner))
        if counts != want or not torch.isfinite(seqs).all():
            raise AssertionError(f"tp NTI launched (forward, dQ, dK/dV) {counts} over {inner} inner iterations, "
                                 f"expected {want} (or its embeddings are not finite)")
        nti_line = dict(steps=steps, epsilon=epsilon, stops=[s[0] for s in stops], inner_iterations=inner,
                        losses=[[float(v) for v in loss.flatten().tolist()] for loss in seen["losses"]],
                        launches=list(counts), seconds=nti_s, invert_s=invert_s, digest=tp_digest(seqs))
        finals, decode = [], pipe.latent2image
        pipe.latent2image = lambda lat, **kw: finals.append(lat) or decode(lat, **kw)
        reset_launch_counts()
        try:
            images, p2z_s = seconds_of(lambda: cli.run_method(
                "p2z", pipe, PROMPTS, last, SamplerConfig(num_inference_steps=steps, height=side, width=side)), device)
        finally:
            del pipe.latent2image
    counts, want = tp_counts(device), tp_want(device, *p2z_launches(sites, steps, inverted=False))
    if counts != want or not all(torch.isfinite(f.float()).all() for f in finals):
        raise AssertionError(f"tp p2z launched (forward, dQ, dK/dV) {counts}, expected {want} (or its latents are not "
                             f"finite)")
    for img in images:
        if img.shape != (side, side, 3) or img.dtype != np.uint8 or img.std() == 0:
            raise AssertionError(f"tp p2z gave a constant or misshapen image {img.shape}")
    return dict(nti=nti_line, p2z=dict(steps=steps, launches=list(counts), seconds=p2z_s,
                                       digest=hashlib.sha256(b"".join(img.tobytes() for img in images)).hexdigest(),
                                       image_means=[float(img.mean()) for img in images]))


TP_RTOL = 1e-3  # each tp check against the same work unsharded in the rank, of max|ref|
TP_ENCODE_RTOL = 1e-4  # the prompt encode under TP, of max|ref|
TP_TRAIN_BATCH = 2
TP_GRAD_FLOOR = 1e-3  # a gradient group's max|ref| counts as at least this share of the whole gradient's
TP_GRAD_FAULTS = ("copy", "dkv")  # planted in (d3); each must put the q/k/v gradients over their limit
TP_STEP = 1  # the P2P refine control's step of the control forward: its cross-replace window is open


def tp_counts(device):
    """(forward, dQ, dK/dV) launches since the counts were set to 0; on the
    CPU (the rehearsal) the wrappers run their plain versions and count
    nothing."""
    return launch_counts() if device.type == "cuda" else (0, 0, 0)


def tp_want(device, *counts):
    return tuple(counts) if device.type == "cuda" else (0, 0, 0)


def tp_digest(x):
    """A bitwise fingerprint of a tensor (the ranks' results must match)."""
    import hashlib

    return hashlib.sha256(x.detach().float().cpu().contiguous().numpy().tobytes()).hexdigest()


def rel_held(name, got, ref, rtol):
    """{max_abs_err, limit}: ``got`` within rtol · max|ref| of ``ref``, both
    finite, or fail naming ``name``."""
    err, limit = (got.float() - ref.float()).abs().max().item(), rtol * ref.float().abs().max().item()
    if not (err <= limit and torch.isfinite(got).all()):
        raise AssertionError(f"{name}: max |err| {err} over the limit {limit} (or not finite)")
    return dict(max_abs_err=err, limit=limit)


def tp_held(name, got, ref, rtol):
    return rel_held(f"tp {name}", got, ref, rtol)


def tp_unet_forward(unet, mesh, lat, t, ctx, added, ref):
    """(d1): ``unet`` (whose unsharded forward gave ``ref``) split in place
    over ``mesh``'s "tensor" axis, the same forward again: within TP_RTOL of
    ``ref``, one forward launch per site on H/n heads."""
    from image_editing_framework_torch.parallel import sharding

    sharding.shard_params(unet, mesh)
    sync(lat.device)
    t0 = time.perf_counter()
    reset_launch_counts()
    with torch.no_grad():
        out = unet(lat, t, ctx, None, added)[0]
    sync(lat.device)
    seconds, got = time.perf_counter() - t0, tp_counts(lat.device)
    want = tp_want(lat.device, unet.config.num_transformer_blocks, 0, 0)
    if got != want:
        raise AssertionError(f"tp the UNet forward launched {got}, expected {want}")
    return dict(tp_held("unet forward", out, ref, TP_RTOL), launches=got[0], expected_launches=want[0],
                seconds=seconds, digest=tp_digest(out))


def tp_control_forward(pipe, mesh, side, latent_side):
    """(d2): a CFG-4 UNet forward under a P2P refine control with
    LocalBlend at a step where the blend records the 256-token sites, and
    the prompt encode, unsharded and then with the UNet and the text tower
    split over "tensor": the eps and the blend's records within TP_RTOL,
    the encode within TP_ENCODE_RTOL; one forward launch per site."""
    from image_editing_framework_torch.core.config import P2PConfig
    from image_editing_framework_torch.methods.common import prepare_conditioning
    from image_editing_framework_torch.ops.controls import build_p2p_control
    from image_editing_framework_torch.parallel import sharding

    device = pipe.device
    cfg = P2PConfig(edit_type="refine", blend_words=(("cat",), ("dog",)))
    ctrl = build_p2p_control(PROMPTS, pipe.tokenizer, STEPS, cfg, record_blend=True, device=device).at_step(TP_STEP)
    gen = torch.Generator(device=device).manual_seed(17)
    lat = torch.randn(4, latent_side, latent_side, 4, device=device, generator=gen)
    t = int(pipe.scheduler.timesteps[TP_STEP])
    with torch.no_grad():
        ctx0, _ = prepare_conditioning(pipe, PROMPTS, side, side)
        eps0, rec0 = pipe.unet(lat, t, ctx0, ctrl)
        sharding.shard_params(pipe.unet, mesh)
        sharding.shard_params(pipe.text_encoder, mesh)
        ctx1, _ = prepare_conditioning(pipe, PROMPTS, side, side)
        sync(device)
        t0 = time.perf_counter()
        reset_launch_counts()
        eps1, rec1 = pipe.unet(lat, t, ctx0, ctrl)  # the unsharded context: the forward's own error
        sync(device)
        seconds, got = time.perf_counter() - t0, tp_counts(device)
    want = tp_want(device, pipe.unet.config.num_transformer_blocks, 0, 0)
    if got != want or sorted(rec1) != sorted(rec0) or not rec0:
        raise AssertionError(f"tp the control forward launched {got} (expected {want}), recorded {sorted(rec1)} "
                             f"(unsharded: {sorted(rec0)})")
    blend = {key: tp_held(f"LocalBlend record {key}", rec1[key], rec0[key], TP_RTOL) for key in rec0}
    return dict(eps=tp_held("control forward eps", eps1, eps0, TP_RTOL), blend_records=blend,
                encode=tp_held("prompt encode", ctx1, ctx0, TP_ENCODE_RTOL), launches=got[0],
                expected_launches=want[0], seconds=seconds, digest=tp_digest(eps1),
                blend_digest=tp_digest(torch.cat([rec1[k].flatten() for k in sorted(rec1)])))


def tp_train_step(unet, mesh, latent_side):
    """(d3): one ``make_sharded_train_step`` step on ``unet`` at batch
    TP_TRAIN_BATCH against the same loss and gradients unsharded in the
    rank: the loss within TP_RTOL of |ref|; every gradient (gathered to
    full shape) within TP_RTOL of its group's max|ref| (``tp_grad_groups``);
    exact forward, dQ and dK/dV launches (every site needs the weights'
    gradients); the replicated weights' SHA-256 after the update, for the
    ranks to compare; everything finite. Before the step, on the split
    weights, each of TP_GRAD_FAULTS planted in turn (``tp_planted``) must
    put the attention q/k/v group over its limit."""
    from image_editing_framework_torch.parallel import sharding

    device = next(unet.parameters()).device
    gen = torch.Generator(device=device).manual_seed(18)
    lat, target = (torch.randn(TP_TRAIN_BATCH, latent_side, latent_side, 4, device=device, generator=gen)
                   for _ in range(2))
    ctx = torch.randn(TP_TRAIN_BATCH, 77, unet.config.cross_attention_dim, device=device, generator=gen)
    unet.requires_grad_(True)

    def gradients():
        for p in unet.parameters():
            p.grad = None
        eps, _ = unet(lat, 501, ctx)
        loss = torch.mean((eps - target) ** 2)
        loss.backward()
        return loss.detach()

    ref_loss = gradients()
    ref_grads = {}
    for name, p in unet.named_parameters():
        ref_grads[name], p.grad = p.grad, None
    init, step = sharding.make_sharded_train_step(unet, mesh)
    init(unet)
    faults = {}
    for fault in TP_GRAD_FAULTS:
        with tp_planted(fault):
            gradients()
        groups, _ = tp_grad_groups(unet, sharding.gather_params(unet, mesh, grads=True), ref_grads)
        faults[fault] = {k: g["max_abs_err"] / g["limit"] for k, g in groups.items()}
        if not faults[fault]["attention q/k/v"] > 1:
            raise AssertionError(f"tp the planted fault {fault!r} passed the q/k/v gradients' gate: {groups}")
    for p in unet.parameters():
        p.grad = None
    sync(device)
    t0 = time.perf_counter()
    reset_launch_counts()
    loss = step(lat, 501, ctx, target)
    sync(device)
    seconds, got = time.perf_counter() - t0, tp_counts(device)
    sites = unet.config.num_transformer_blocks
    want = tp_want(device, sites, sites, sites)
    if got != want:
        raise AssertionError(f"tp the train step launched (forward, dQ, dK/dV) {got}, expected {want}")
    params, grads = dict(unet.named_parameters()), sharding.gather_params(unet, mesh, grads=True)
    groups, scale = tp_grad_groups(unet, grads, ref_grads)
    err = max(group["max_abs_err"] for group in groups.values())
    finite = all(torch.isfinite(g).all() for g in grads.values()) and all(
        torch.isfinite(p).all() for p in params.values())
    del grads, ref_grads
    specs = sharding.unet_param_specs(unet)
    over = sorted(k for k, g in groups.items() if not g["max_abs_err"] <= g["limit"])
    if over or not finite:
        raise AssertionError(f"tp the train step's gradients: groups over their limits {over} (or not finite: "
                             f"{not finite}); whole max|ref| {scale}, every group {groups}")
    loss_held = tp_held("train step loss", loss, ref_loss, TP_RTOL)
    replicated = [p.detach().flatten() for n, p in params.items() if not isinstance(specs[n], sharding.Shard)]
    return dict(loss=loss.item(), ref_loss=ref_loss.item(), loss_held=loss_held, grad_max_abs_err=err,
                grad_max=scale, grad_groups=groups, planted_faults_err_over_limit=faults, launches=list(got),
                expected_launches=list(want), seconds=seconds, replicated_tensors=len(replicated),
                replicated_digest=tp_digest(torch.cat(replicated)))


def tp_grad_groups(unet, grads, ref_grads):
    """({group: leaves, max|ref|, max |err|, limit}, the whole gradient's
    max|ref|) of full-shape ``grads`` against ``ref_grads``: each group
    (``tp_grad_group``) held at TP_RTOL of its own max|ref|, floored at
    TP_GRAD_FLOOR of the whole gradient's."""
    scale = max(g.abs().max().item() for g in ref_grads.values())
    groups = {}
    for name, ref in ref_grads.items():
        group = groups.setdefault(tp_grad_group(unet, name), dict(leaves=0, max=0.0, max_abs_err=0.0))
        group["leaves"] += 1
        group["max"] = max(group["max"], ref.abs().max().item())
        group["max_abs_err"] = max(group["max_abs_err"], (grads[name] - ref).abs().max().item())
    for group in groups.values():
        group["limit"] = TP_RTOL * max(group["max"], TP_GRAD_FLOOR * scale)
    return groups, scale


@contextlib.contextmanager
def tp_planted(fault):
    """A planted tensor-parallel fault that the train step's gradient gate
    must reject: ``"copy"``, ``copy_to_tensor_parallel``'s backward without
    its all-reduce (each rank's input gradient only its heads' share);
    ``"dkv"``, the attention backward's dK and dV swapped."""
    from image_editing_framework_torch.ops import flash_attention as fa
    from image_editing_framework_torch.parallel import sharding

    if fault == "copy":
        owner, name, planted = sharding._CopyToTensorParallel, "backward", staticmethod(lambda ctx, g: (g, None))
    else:
        real_bwd = fa.flash_attention_bwd

        def planted(*args, **kwargs):
            dq, dk, dv = real_bwd(*args, **kwargs)
            return dq, dv, dk

        owner, name = fa, "flash_attention_bwd"
    real = owner.__dict__[name]
    setattr(owner, name, planted)
    try:
        yield
    finally:
        setattr(owner, name, real)


def tp_grad_group(unet, name):
    """The group of a UNet parameter whose gradients the train step's gate
    holds at the group's own max: the attention's q/k/v projections (the
    dQ and dK/dV kernels' operands), its output projections, the
    feed-forwards, the convolutions, the norms, and every other weight."""
    layer = unet.get_submodule(name.rpartition(".")[0])
    if any(name.endswith(f".{p}.{leaf}") for p in ("to_q", "to_k", "to_v") for leaf in ("weight", "bias")):
        return "attention q/k/v"
    if ".to_out." in name:
        return "attention out"
    if ".ff." in name:
        return "feed-forward"
    if isinstance(layer, torch.nn.Conv2d):
        return "convolutions"
    if isinstance(layer, (torch.nn.GroupNorm, torch.nn.LayerNorm)):
        return "norms"
    return "other"


def tp_parts(mesh, device, tiny=False):
    """(d2), the f32 p2z guided step's gradient (``tp_p2z_step``, its
    unsharded reference taken before the split), (d4) and (d5)
    (``tp_grad_paths``, on the split pipe cast to bf16) and (d3) on SD1.5 at
    512², f32 (``tiny``: the tiny pipeline at 32², the CPU rehearsal, f32
    throughout), seeded random weights built in each rank.
    cuDNN's deterministic algorithms, so that the ranks' replicated
    gradients, and the weights after the update, are bitwise equal."""
    from image_editing_framework_torch.models import configs
    from image_editing_framework_torch.models.unet import UNet2DCondition
    from image_editing_framework_torch.pipelines import _build, random_pipeline, tiny_pipeline

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        if tiny:  # the tiny VAE halves the side: 32² images, 16² latents
            pipe, side, latent_side, cfg = tiny_pipeline(num_steps=STEPS, device=device), 32, 16, configs.TINY_UNET
            pipe.tokenizer.encode(" ".join(PROMPTS))
        else:
            pipe = random_pipeline(MODELS["sd"][0], num_steps=STEPS, dtype=torch.float32, seed=0, device=device)
            side, latent_side, cfg = MODELS["sd"][2], MODELS["sd"][2] // 8, configs.SD15_UNET
        inputs, ref_loss, ref_grad, _, _ = tp_p2z_step(pipe, latent_side)
        res = dict(control=tp_control_forward(pipe, mesh, side, latent_side))
        _, loss, grad, counts, seconds = tp_p2z_step(pipe, latent_side, inputs)
        sites = pipe.unet.config.num_transformer_blocks
        want = tp_want(device, sites, sites, sites)
        if counts != want:
            raise AssertionError(f"tp the p2z guided step launched (forward, dQ, dK/dV) {counts}, expected {want}")
        res["p2z_step"] = dict(gradient=tp_held("p2z guided step gradient", grad, ref_grad, TP_RTOL),
                               loss_held=tp_held("p2z guided step loss", loss, ref_loss, TP_RTOL),
                               launches=list(counts),
                               expected_launches=list(want), seconds=seconds, digest=tp_digest(grad))
        del inputs, ref_grad, grad
        if not tiny:  # (d4) and (d5) in bf16 on the split modules, cast in place
            for module in (pipe.unet, pipe.vae, pipe.text_encoder):
                module.to(torch.bfloat16)
            pipe.dtype = torch.bfloat16
        res.update(tp_grad_paths(pipe, side))
        del pipe
        res["train"] = tp_train_step(_build(UNet2DCondition, cfg, device, torch.float32, 1), mesh, latent_side)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def cp_rank(rank, world, store, out_dir, parts="abcde"):
    """One rank of a cp_path group (its own process): join the group over
    gloo on the one card, or over NCCL with a card per rank; run (a), and on
    2 ranks also (b), (c), (d) and (e) (those of ``parts`` asked for; (d),
    tensor parallelism, on a data 1 x tensor 2 mesh of the same ranks, its
    first check on (b)'s module when (b) runs; (e), NTI and pix2pix-zero
    under the ring, its f32 gradients (e1) on (b)'s module and its bf16 runs
    (e2, e3) on (c)'s pipe and inversion); write ``rank<r>.json``. Returns
    the exit code."""
    import datetime

    from image_editing_framework_torch.parallel import mesh as mesh_lib

    rank, world = int(rank), int(world)
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's deterministic algorithms: the ranks run the layers outside the
    # ring on the same inputs, and their gradients must be bitwise equal
    torch.backends.cudnn.deterministic = True
    mesh_lib.initialize_distributed(f"file://{store}", world, rank, backend=backend,
                                    timeout=datetime.timedelta(seconds=CP_COLLECTIVE_TIMEOUT_S))
    try:
        mesh = mesh_lib.make_mesh(device_type="cuda")
        mesh2d = mesh_lib.make_mesh(data=2, tensor=2, device_type="cuda") if world == 4 else None
        t0 = time.perf_counter()
        res = dict(rank=rank, world=world, backend=backend, kernels=cp_kernel_checks(mesh, mesh2d, world, device))
        res["kernels_s"] = time.perf_counter() - t0
        tp_mesh = mesh_lib.make_mesh(data=1, tensor=2, device_type="cuda") if world == 2 and "d" in parts else None
        if world == 2 and "b" in parts:
            t0 = time.perf_counter()
            res["unet"] = cp_unet_forward(mesh, device, tp_mesh, grads="e" in parts)
            res["unet_s"] = time.perf_counter() - t0
            if "grad" in res["unet"]:
                res["unet_s"] -= sum(r["seconds"] for r in res["unet"]["grad"].values())
        if world == 2 and "c" in parts:
            res["main"], carry = cp_main_path(mesh, device)
            if "e" in parts:
                t0 = time.perf_counter()
                per_forward = SITES["xl"] + CP_BIG_SITES * (world - 1)
                # NTI's gradient skips the first site, a ring site
                res["ring_grads"] = ring_grad_paths(carry[0], MODELS["xl"][2], *carry[1:], CP_NTI_EPSILON, per_forward,
                                                    per_forward - world, per_forward)
                res["ring_grads_s"] = time.perf_counter() - t0
            del carry
            torch.cuda.empty_cache()
        if tp_mesh is not None:
            t0 = time.perf_counter()
            res["tp"] = tp_parts(tp_mesh, device)
            if "b" in parts:
                res["tp"]["unet"] = res["unet"].pop("tp")
            res["tp_s"] = time.perf_counter() - t0
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def cp_group(world, root, parts="abcde"):
    """Run ``cp_rank`` on ``world`` processes; returns their results. A rank
    that exits non-zero, or a group past ``CP_GROUP_TIMEOUT_S``, kills every
    rank and fails with the ranks' output."""
    import os

    out_dir = tempfile.mkdtemp(prefix=f"ief_cp{world}_", dir=root)
    here = os.path.dirname(os.path.abspath(__file__))
    code = "import sys, chip_smoke; sys.exit(chip_smoke.cp_rank(*sys.argv[1:]))"
    logs = [open(f"{out_dir}/rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-u", "-c", code, str(r), str(world), f"{out_dir}/store", out_dir,
                               parts],
                              cwd=here, stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + CP_GROUP_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        tails = "".join(f"--- rank {r}\n" + open(f"{out_dir}/rank{r}.log").read()[-4000:] for r in range(world))
        raise AssertionError(f"cp_path's {world} ranks exited {codes} (timeout {CP_GROUP_TIMEOUT_S} s)\n{tails}")
    results = []
    for r in range(world):
        with open(f"{out_dir}/rank{r}.json") as f:
            results.append(json.load(f))
    return results


def phase_cp_path():
    """Context parallelism on the card: groups of 4 and of 2 rank processes
    (``cp_group``). Every rank checks (a) itself; here the ranks' results
    are held to each other: the same launches, the same (b) checksum, the
    same (c) images. Returns (the main path's forward launches per rank,
    the ring backward's (dQ, dK/dV) launches per rank)."""
    torch.cuda.empty_cache()  # the ranks need the card's memory that the earlier phases cached here
    root = scratch_base(1, "cp_disk")
    results = {world: cp_group(world, root) for world in (4, 2)}
    lines = {}
    for world, ranks in results.items():
        first = ranks[0]
        for res in ranks[1:]:
            if [row["launches"] for row in res["kernels"]["forward"]] != [
                    row["launches"] for row in first["kernels"]["forward"]]:
                raise AssertionError(f"cp ranks launched unequal counts: {res['kernels']['forward']}")
        lines[world] = first
        emit("cp_kernels", world=world, backend=first["backend"], forward=first["kernels"]["forward"],
             backward=first["kernels"]["backward"], times=first["kernels"]["times"],
             times_by_rank=[res["kernels"]["times"] for res in ranks], seconds=first["kernels_s"], card=card_line())
    two = results[2]
    if two[0]["unet"]["checksum"] != two[1]["unet"]["checksum"]:
        raise AssertionError("the two ranks' UNet checksums differ")
    hashes = [res["main"]["image_sha256"] for res in two]
    if hashes[0] != hashes[1]:
        raise AssertionError(f"the main path under the ring gave other images on the two ranks: {hashes}")
    emit("cp_unet", model="SDXL base UNet (random weights, seed 0)", resolution=1024, dtype="float32", batch=4,
         world=2, backend=two[0]["backend"], **{k: v for k, v in two[0]["unet"].items()},
         rank1={k: two[1]["unet"][k] for k in ("ring", "ulysses")}, seconds=two[0]["unet_s"], card=card_line())
    main = two[0]["main"]
    emit("cp_main_path", model="SDXL base (random weights, seed 0)", resolution=1024, dtype="bfloat16", world=2,
         backend=two[0]["backend"], mode="ring", **main, rank1_image_s=two[1]["main"]["image_s"],
         images_equal_across_ranks=True, xl_main_path_image_s=EMITTED.get("xl_main_path", {}).get("image_s"),
         note="one card: both ranks share it and gloo copies every rotation through host memory; these seconds "
              "say nothing about scaling over several cards", card=card_line())
    bwd = sum(row["launches"][0] for row in results[2][0]["kernels"]["backward"])
    return main["launches"], (bwd, bwd), tp_line(two), cp_grad_line(two)


def cp_grad_line(ranks):
    """Holds the two ranks' part (e) to each other (the f32 gradients', the
    NTI embeddings' and stops' and the pix2pix-zero images' digests, the
    launches), emits the ``cp_grad`` line, and returns rank 0's (forward,
    dQ, dK/dV) launches of (e)."""
    first, second = ({**res["unet"]["grad"], **res["ring_grads"]} for res in ranks)
    differ = {f"{key} {field}": (mine.get(field), second[key].get(field)) for key, mine in first.items()
              for field in ("digest", "stops", "image_sha256", "launches") if mine.get(field) != second[key].get(field)}
    if differ:
        raise AssertionError(f"cp (e): the ranks differ in {differ}; rank 0's results {first}")
    stops = first["nti"]["stops"]
    emit("cp_grad", model="SDXL base (random weights, seed 0)", resolution=1024, world=2, backend=ranks[0]["backend"],
         mode="ring", unet_gradients=dict(dtype="float32", remat=True, **{k: first[k] for k in ("batch1", "batch2")}),
         nti=dict(dtype="bfloat16", stops_mixed=min(stops) < max(stops), **first["nti"]),
         p2z=dict(dtype="bfloat16", **first["p2z"]), ranks_equal=True,
         seconds=ranks[0]["ring_grads_s"] + sum(first[k]["seconds"] for k in ("batch1", "batch2")),
         note="two ranks on one card over gloo: the ring's collectives go through host memory", card=card_line())
    return tuple(map(sum, zip(*(first[k]["launches"] for k in first))))


def tp_line(ranks):
    """Holds the two ranks' tensor-parallel results (part (d)) to each
    other, emits the ``tp`` line, and returns rank 0's (forward, dQ, dK/dV)
    launches of the three checks."""
    first, second = (res["tp"] for res in ranks)
    for key in ("unet", "control", "train", "p2z_step", "nti", "p2z"):
        mine, other = first[key], second[key]
        for field in ("digest", "blend_digest", "replicated_digest", "loss", "launches", "stops"):
            if mine.get(field) != other.get(field):
                raise AssertionError(f"tp {key}: the ranks' {field} differ: {mine.get(field)} / {other.get(field)}")
    fwd = first["unet"]["launches"] + first["control"]["launches"]
    grads = [first[key]["launches"] for key in ("train", "p2z_step", "nti", "p2z")]
    emit("tp", world=2, mesh={"data": 1, "tensor": 2}, backend=ranks[0]["backend"],
         unet=dict(model="SDXL base UNet (random weights, seed 0; (b)'s module, split in place)", resolution=1024,
                   dtype="float32", batch=4, **first["unet"]),
         control=dict(model="SD1.5 (random weights, seed 0)", resolution=512, dtype="float32", batch=4,
                      control="P2P refine with LocalBlend, step 1", **first["control"]),
         train=dict(model="SD1.5 UNet (random weights, seed 1)", resolution=512, dtype="float32",
                    batch=TP_TRAIN_BATCH, optimizer="Adam, lr 1e-4", **first["train"]),
         p2z_step=dict(model="SD1.5 (random weights, seed 0)", resolution=512, dtype="float32", batch=P2Z_BATCH,
                       **first["p2z_step"]),
         nti=dict(model="SD1.5 (random weights, seed 0; (d)'s pipe, split, cast to bf16)", resolution=512,
                  dtype="bfloat16", stops_mixed=min(first["nti"]["stops"]) < max(first["nti"]["stops"]),
                  **first["nti"]),
         p2z=dict(model="SD1.5 (random weights, seed 0; (d)'s pipe, split, cast to bf16)", resolution=512,
                  dtype="bfloat16", **first["p2z"]),
         ranks_equal=True, seconds=ranks[0]["tp_s"] + first["unet"]["seconds"],
         seconds_by_rank=[res["tp_s"] for res in ranks],
         note="two ranks on one card over gloo: every all-reduce goes through host memory, so these seconds say "
              "nothing about tensor parallelism's speed over cards", card=card_line())
    return tuple(a + b for a, b in zip((fwd, 0, 0), map(sum, zip(*grads))))


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
            with tempfile.TemporaryDirectory(prefix="ief_checkpoint_", dir=scratch_base(8, "checkpoint_disk")) as tmp:
                launches["checkpoint"], snapshot = run("checkpoint_path", phase_checkpoint_path, profile_args[0], tmp)
                launches["sweep"], sweep_runs = run("sweep_path", phase_sweep_path, tmp, snapshot)
                launches["serve"] = run("serve_path", phase_serve_path, tmp, snapshot)
                grad_groups = run("grad_groups_path", phase_grad_groups_path, tmp, snapshot)
                run("launcher_path", phase_launcher_path, tmp)
                validation = run("validation_path", phase_validation_path, tmp, snapshot)
                launches["validation"], launches["validation_rerun"] = (counts[0] for counts in validation)
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
        if model == "xl":  # on the XL pipe while it is loaded: a group from two of its inverted latents
            xl_group = run("xl_p2z_group_path", phase_xl_p2z_group_path, profile_args[0], (nti[0], inversion[0]))
        del profile_args, nti, inversion  # the next model needs the card's memory
        torch.cuda.empty_cache()
    launches["sd21"], unet_ms["sd21"], pipe21 = run("sd21_path", phase_sd21_path,
                                                    scratch_base(SD21_DISK_GIB, "sd21_disk"))
    sd21_nti, _ = run("sd21_nti_path", phase_nti_path, "sd21", pipe21)
    launches["sd21_nti"], bwd_launches["sd21"] = sd21_nti[0], sd21_nti[1:]
    del pipe21
    torch.cuda.empty_cache()
    launches["refiner"] = run("refiner", phase_refiner)
    launches["cp"], cp_bwd, tp_launches, cp_grad = run("cp_path", phase_cp_path)
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
    fwd, bwd = sums["sd21"], bwd_sums["sd21"]["all"]
    emit("share", model="sd21", flash_ms_per_cfg4_forward=fwd["ms"], unet_forward_cfg4_ms=unet_ms["sd21"],
         flash_share=fwd["ms"] / unet_ms["sd21"], flash_bound_ms_per_cfg4_forward=fwd["bound_ms"],
         flash_plain_ms_per_cfg4_forward=fwd["plain_ms"], sdpa_ms_per_cfg4_forward=fwd["library_ms"],
         bwd_ms_per_inner_iteration=bwd["ms"], bwd_bound_ms_per_inner_iteration=bwd["bound_ms"],
         bwd_bound_by=bwd["bound_by"], sdpa_bwd_ms_per_inner_iteration=bwd["library_ms"],
         bwd_device_ms_per_inner_iteration=bwd["device_ms"],
         sdpa_bwd_device_ms_per_inner_iteration=bwd["library_device_ms"])

    def at(part, *more):
        return {key: part[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms") + more}

    device = ("device_ms", "library_device_ms")  # the backward's, from CUDA-graph replays and the profiler

    tpu = "image_editing_framework_tpu/ops/flash_attention.py"
    work = {"sd": "the 15 self-attention sites an SD1.5 512² NTI gradient flows through, batch 1, bf16 (one inner "
                  "iteration)",
            "xl": "the 69 sites an SDXL 1024² NTI gradient flows through, batch 1, bf16 (one inner iteration)",
            "sd21": "the 15 sites an SD2.1 768² NTI gradient flows through, batch 1, bf16 (one inner iteration)"}
    p2z_work = {"sd": "all 16 self-attention sites of SD1.5 512², CFG batch 2, bf16 (one p2z guided step)",
                "xl": "all 70 sites of SDXL 1024², CFG batch 2, bf16 (one p2z guided step)"}
    bwd = [{
        "name": f"flash_bwd_{kernel}", "route": "cuda", "source": "image_editing_framework_torch/csrc/flash_bwd.cu",
        "replaces": f"{tpu}:{line}", "also_replaces": f"{tpu}:{line_t}",
        "launches": sum(counts[i] for counts in bwd_launches.values())
        + sum(counts[i + 1] for runs in p2z_runs.values() for counts in runs.values())
        + sum(counts[i + 1] for counts in validation) + cp_bwd[i] + tp_launches[i + 1]
        + grad_groups[i + 1] + xl_group[i + 1] + cp_grad[i + 1],
        "launches_by_path": {"nti_path": bwd_launches["sd"][i], "xl_nti_path": bwd_launches["xl"][i],
                             "sd21_nti_path": bwd_launches["sd21"][i],
                             "masactrl_path": 0, "xl_masactrl_path": 0, "pnp_path": 0, "xl_pnp_path": 0,
                             "p2z_path": sum(counts[i + 1] for counts in p2z_runs["sd"].values()),
                             "xl_p2z_path": sum(counts[i + 1] for counts in p2z_runs["xl"].values()),
                             "validation_path": validation[0][i + 1], "validation_rerun": validation[1][i + 1],
                             "cp_path": cp_bwd[i], "tp_path": tp_launches[i + 1],
                             "grad_groups_path": grad_groups[i + 1], "xl_p2z_group_path": xl_group[i + 1],
                             "cp_grad_path": cp_grad[i + 1]},
        "cp_path_launches": "rank 0's: the ring's backward at SDXL's 4096-token site, batch 1 and 2, bf16 and f32, "
                            "on 2 ranks (2 of each kernel per call)",
        "tp_path_launches": "rank 0's under tensor parallelism on 2 ranks at SD1.5 512²: the f32 train step and "
                            "p2z guided step (16 each), NTI and p2z on 10 steps in bf16",
        "cp_grad_path_launches": "rank 0's under the ring on 2 ranks at SDXL 1024²: the f32 UNet gradients at "
                                 "batch 1 and 2, NTI on 5 steps and p2z on 10 in bf16",
        "max_abs_err": bwd_worst[torch.bfloat16][kernel], "max_abs_err_f32": bwd_worst[torch.float32][kernel],
        **at(bwd_sums["sd"][kernel], *device), "work": work["sd"],
        "at_xl": dict(at(bwd_sums["xl"][kernel], *device), work=work["xl"]),
        "at_sd21": dict(at(bwd_sums["sd21"][kernel], *device), work=work["sd21"]),
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
        "launches": sum(launches.values()) + tp_launches[0] + grad_groups[0] + xl_group[0] + cp_grad[0],
        "launches_by_path": {"main_path": launches["sd"], "checkpoint_path": launches["checkpoint"],
                             "sweep_path": launches["sweep"], "serve_path": launches["serve"],
                             "validation_path": launches["validation"],
                             "validation_rerun": launches["validation_rerun"],
                             "sweep_batched_run": sweep_runs["d"], "xl_main_path": launches["xl"],
                             "xl_checkpoint_path": launches["xl_checkpoint"],
                             "masactrl_path": launches["masactrl"], "xl_masactrl_path": launches["xl_masactrl"],
                             "pnp_path": launches["pnp"], "xl_pnp_path": launches["xl_pnp"],
                             "p2z_path": launches["p2z"], "xl_p2z_path": launches["xl_p2z"],
                             "sd21_path": launches["sd21"], "sd21_nti_path": launches["sd21_nti"],
                             "refiner": launches["refiner"], "cp_path": launches["cp"], "tp_path": tp_launches[0],
                             "grad_groups_path": grad_groups[0], "xl_p2z_group_path": xl_group[0],
                             "cp_grad_path": cp_grad[0]},
        "cp_path_launches": "rank 0's: the SDXL 1024² main path under the ring on 2 ranks (80 per UNet forward)",
        "tp_path_launches": "rank 0's under tensor parallelism on 2 ranks: the f32 SDXL 1024² UNet forward (70), "
                            "the SD1.5 512² control forward (16), train step (16) and p2z guided step (16), NTI "
                            "and p2z on 10 steps in bf16",
        "cp_grad_path_launches": "rank 0's under the ring on 2 ranks at SDXL 1024²: the f32 UNet gradients at batch "
                                 "1 and 2, NTI on 5 steps and p2z on 10 in bf16",
        "p2z_launches_by_run": p2z_runs,
        "sweep_launches_by_run": sweep_runs,
        "masactrl_launches_by_run": masa_runs,
        "max_abs_err": worst[torch.bfloat16], "max_abs_err_f32": worst[torch.float32],
        **at(sums["sd"]), "work": "the 16 self-attention sites of one SD1.5 512² UNet forward at CFG batch 4, bf16",
        "at_xl": dict(at(sums["xl"]), work="the 70 sites of one SDXL 1024² UNet forward at CFG batch 4, bf16"),
        "at_sd21": dict(at(sums["sd21"]), work="the 16 self-attention sites of one SD2.1 768² UNet forward at CFG "
                                               "batch 4 (9216/2304/576/144 tokens, d = 64), bf16"),
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

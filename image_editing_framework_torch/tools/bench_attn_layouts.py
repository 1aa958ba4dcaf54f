"""Tensor-core cost of the attention products' operand layouts at the SD/XL
head dims, measured on the card by a hand-written probe kernel.

Counterpart of ``tools/bench_attn_layouts.py`` (``_probe_kernel:57``,
``_probe:83``, ``probe_layout:102``, ``main:111``). The TPU question was
whether head dims 40 and 64 pay for the 128-lane padding; the card's question
is what one 512 x 512 product costs through ``wgmma`` on TMA-fed
shared-memory tiles at d = 40, 64 and 128, with the contraction dim
contiguous in memory (a K-major operand) or strided (MN-major, the
instruction's transpose bit):

  scores:   S = Q K^T       contraction over d
     s_lane:  dot((512, d), (512, d))   d contiguous
     s_sub:   dot((d, 512), (d, 512))   d strided
  weighted: O = P V         d is an output dim, contraction over 512 keys
     pv_lane: dot((512, 512), (512, d))  V's keys strided, as the forward reads V
     pv_sub:  dot((d, 512), (512, 512))  keys contiguous in both, O^T = V^T P^T

``probe`` computes ``acc = sum_i sum(dot(a_i, b_i))`` where the smaller
operand is rescaled every iteration (``x_i = bf16(f32(x) * (1 + 1e-9 * i))``)
so no product can be hoisted, and the running sum keeps every product live.
On CUDA tensors it launches ``csrc/mma_probe.cu``, in which every block
computes the whole sum on its own (one block per SM loads the whole card), or
raises; on CPU tensors it takes ``probe_reference``, the plain PyTorch loop
with the same rounding points. No library call computes this function (a
looped product that stores nothing), so there is no library yardstick.
``plan`` says how the kernel lays each layout onto ``wgmma`` (which operand
is A, which is B, their major-ness, padding, ring depth, shared memory and
the bytes each SM reads from the L2 per iteration); the C entry point
``mma_probe_plan`` computes the same.

Timing is the slope between two iteration counts by CUDA events, which
cancels the launch and the final reduction. Run on the card, from the
repository root:

  python3 -m image_editing_framework_torch.tools.bench_attn_layouts [--root DIR] [--label NAME]

``--root`` times the probe of another checkout of the package (for example
the parent commit's, unpacked under ``_local/parent``) in a process of its
own, so that two versions are compared in one call, in turns.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from typing import Dict, Tuple

import numpy as np
import torch

BQ = BK = 512  # the probe's tile: 512 queries x 512 keys
HEAD_DIMS = (40, 64, 128)
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)

Contract = Tuple[Tuple[int], Tuple[int]]  # JAX dimension numbers: ((lhs dim,), (rhs dim,))

# name -> (contraction, lhs shape, rhs shape) at head dim d
LAYOUTS = {
    "s_lane": (((1,), (1,)), lambda d: (BQ, d), lambda d: (BK, d)),
    "s_sub": (((0,), (0,)), lambda d: (d, BQ), lambda d: (d, BK)),
    "pv_lane": (((1,), (0,)), lambda d: (BQ, BK), lambda d: (BK, d)),
    "pv_sub": (((1,), (1,)), lambda d: (d, BK), lambda d: (BQ, BK)),
}


def _scale(i: int) -> float:
    """``1 + 1e-9 * i`` as JAX forms it from an int32 ``i``: f32 arithmetic."""
    return float(np.float32(1.0) + np.float32(1e-9) * np.float32(i))


def _rows_by_k(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The operand as (rows, contraction) whatever its storage."""
    return x if dim == 1 else x.transpose(0, 1)


def probe_reference(a: torch.Tensor, b: torch.Tensor, contract: Contract, iters: int,
                    blocks: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the probe kernel: a Python loop with its
    rounding points (the smaller operand, ``a`` on a tie, scaled in f32 and
    rounded to bf16 once per iteration; f32 products of bf16 values, which
    are exact, summed in f32; one running f32 sum). Returns (blocks,) f32,
    every block's value the same."""
    (ca,), (cb,) = contract
    perturb_a = a.numel() <= b.numel()
    acc = torch.zeros((), dtype=torch.float32, device=a.device)
    for i in range(iters):
        s = _scale(i)
        ai = (a.float() * s).to(a.dtype) if perturb_a else a
        bi = b if perturb_a else (b.float() * s).to(b.dtype)
        prod = torch.matmul(_rows_by_k(ai, ca).float(), _rows_by_k(bi, cb).float().transpose(0, 1))
        acc = acc + prod.sum()
    return acc.expand(blocks).clone()


def _check(a: torch.Tensor, b: torch.Tensor, contract: Contract, iters: int, blocks: int):
    (ca,), (cb,) = contract
    if a.dim() != 2 or b.dim() != 2 or ca not in (0, 1) or cb not in (0, 1):
        raise ValueError("probe takes two matrices and one contraction dim (0 or 1) of each")
    if a.shape[ca] != b.shape[cb]:
        raise ValueError(f"contraction dims differ: {tuple(a.shape)}[{ca}] vs {tuple(b.shape)}[{cb}]")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"probe takes bf16 operands, got {a.dtype} and {b.dtype}")
    if iters < 0 or blocks < 1:
        raise ValueError(f"iters >= 0 and blocks >= 1, got {iters} and {blocks}")


# The kernel's plan constants (csrc/mma_probe.cu): rows of A per S-plan slot
# and depth of K per PV-plan slot; product columns per S-plan wgmma; ring
# depths; the dynamic shared memory a block may use; the PV plan's wgmma
# widths (the kernel's instantiations).
CHUNK, PIECE, RING_S, MAX_RING_PV = 64, 128, 4, 4
MAX_SMEM = 232448 - 64
PV_WIDTHS = (32, 40, 48, 64, 128)
PLAN_FIELDS = ("cls", "a_is_b", "ta", "tb", "m", "n", "k", "kp", "np", "ring", "smem")


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def barrier_bytes(ring: int) -> int:
    """Shared memory of the kernel's mbarriers: B resident, then for each
    slot the rescaled piece copied, A copied, the piece rescaled, the slot
    free."""
    return 8 * (1 + 4 * ring)


def plan(a_trans: bool, b_trans: bool, m: int, n: int, k: int):
    """How the probe kernel lays ``sum_k A(m, k) B(n, k)`` onto ``wgmma``
    for a stored (m, k) [(k, m) with ``a_trans``] and b stored (n, k)
    [(k, n) with ``b_trans``], as ``probe_plan`` in csrc/mma_probe.cu does;
    None for what the kernel refuses.

    ``cls`` "s": a (rescaled) is the wgmma's A, streamed in 64-row chunks,
    and b its B, resident; the pieces are K-major as stored plain, MN-major
    as stored transposed. ``cls`` "pv" (when b does not fit resident, or a
    is plain and b transposed): the unscaled operand is A, K-major, streamed
    in 64-deep K chunks by TMA, and the rescaled one is B; ``a_is_b`` (both
    plain) takes the sum of the transposed product, A = b and B = a, so that
    the 64-row side is the larger operand. ``m``, ``n``, ``k`` are the
    wgmma product's, ``kp`` its padded K, ``np`` B's padded rows (the wgmma
    width in the PV plan), ``ring`` the slots, ``smem`` the dynamic shared
    memory. ``rescaled`` names the stored operand that is rescaled, and
    ``l2_bytes_per_iter`` what one block reads per iteration from device
    memory (the L2): the rescaled operand's original values, and in the PV
    plan all of A besides."""
    if min(m, n, k) <= 0 or m % 8 or n % 8 or k % 8:
        return None
    a_res = m <= n
    if (n if a_res else m) % 64:
        return None
    if a_trans == b_trans:
        if not a_res:
            return None
        kp, np_ = _round_up(k, 16), _round_up(n, PIECE)
        kw = kp if a_trans else _round_up(kp, 64)  # K-major tiles hold whole 64-wide blocks of K
        smem = 1024 + np_ * kw * 2 + RING_S * CHUNK * kw * 2 + barrier_bytes(RING_S)
        if smem <= MAX_SMEM and kp <= 256:
            q = dict(cls="s", a_is_b=0, ta=int(a_trans), tb=int(b_trans), m=m, n=n, k=k, kp=kp, np=np_,
                     ring=RING_S, smem=smem)
        elif a_trans:
            return None
        else:
            q = dict(cls="pv", a_is_b=1, ta=0, tb=0, m=n, n=m, k=k, kp=_round_up(k, CHUNK),
                     np=next((w for w in PV_WIDTHS if w >= m), 0))
    else:
        if a_trans or a_res:
            return None
        q = dict(cls="pv", a_is_b=0, ta=0, tb=1, m=m, n=n, k=k, kp=_round_up(k, CHUNK),
                 np=next((w for w in PV_WIDTHS if w >= n), 0))
    if q["cls"] == "pv":
        if not q["np"]:
            return None
        # an MN-major B holds whole 64-wide blocks of its columns
        slot = (q["m"] + (_round_up(q["np"], 64) if q["tb"] else q["np"])) * CHUNK * 2
        ring = min(MAX_RING_PV, (MAX_SMEM - 1024 - barrier_bytes(MAX_RING_PV)) // slot)
        if ring < 2:
            return None
        q.update(ring=ring, smem=1024 + ring * slot + barrier_bytes(ring))
    q["rescaled"] = "a" if a_res else "b"
    rescaled_bytes = (m if a_res else n) * k * 2
    q["l2_bytes_per_iter"] = rescaled_bytes + (q["m"] * k * 2 if q["cls"] == "pv" else 0)
    return q


def plan_for(a: torch.Tensor, b: torch.Tensor, contract: Contract):
    """``plan`` for the operands and contraction ``probe`` takes."""
    (ca,), (cb,) = contract
    return plan(ca == 0, cb == 0, a.shape[1 - ca], b.shape[1 - cb], a.shape[ca])


def probe(a: torch.Tensor, b: torch.Tensor, contract: Contract, iters: int, blocks: int = 1) -> torch.Tensor:
    """``sum_{i < iters} sum(dot(a_i, b_i))`` per block, (blocks,) f32.

    ``contract`` names the contracted dim of each operand as JAX dimension
    numbers, ``((1,), (1,))`` for ``a @ b.T``. CUDA tensors launch the
    kernel, which takes the four attention layouts (both operands stored
    rows x k, both k x rows, or a rows x k with b k x rows and fewer rows in
    b; extents multiples of 8; the larger operand's rows a multiple of 64;
    what ``plan`` fits into one SM's shared memory) and raises on anything
    else.
    CPU tensors take ``probe_reference``.
    """
    _check(a, b, contract, iters, blocks)
    if a.device.type == "cpu":
        return probe_reference(a, b, contract, iters, blocks)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"probe runs on cuda or cpu tensors, got {a.device} and {b.device}")
    from image_editing_framework_torch.ops import _cuda

    lib = _cuda.load("mma_probe")
    fn = lib.mma_probe
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    (ca,), (cb,) = contract
    if not (a.is_contiguous() and b.is_contiguous() and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0):
        raise ValueError("probe operands must be contiguous and 16-byte aligned")
    out = torch.empty((blocks,), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), int(ca == 0), int(cb == 0),
             a.shape[1 - ca], b.shape[1 - cb], a.shape[ca], iters, blocks, stream)
    if err == 1:
        raise ValueError(f"the probe kernel does not take {tuple(a.shape)} x {tuple(b.shape)} with {contract}")
    if err != 0:
        raise RuntimeError(f"mma_probe launch failed: CUDA error {err}")
    probe.launches += 1
    return out


# Probe kernel launches since the count was last set to 0.
probe.launches = 0


def kernel_plan(a_trans: bool, b_trans: bool, m: int, n: int, k: int):
    """The plan the built kernel computes (``mma_probe_plan``), in
    ``plan``'s fields without the derived ones; None where it refuses.
    Needs the CUDA toolkit to build the library, not a card."""
    from image_editing_framework_torch.ops import _cuda

    fn = _cuda.load("mma_probe").mma_probe_plan
    fn.argtypes, fn.restype = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    if not fn(int(a_trans), int(b_trans), m, n, k, out):
        return None
    q = dict(zip(PLAN_FIELDS, out))
    q["cls"] = ("s", "pv")[q["cls"]]
    return q


def operands(d: int, rng: np.random.RandomState, device) -> Dict[str, Tuple[torch.Tensor, torch.Tensor, Contract]]:
    """The four layouts' bf16 operands at head dim ``d`` from one numpy
    stream (q, k, p, v as the JAX tool draws them; the transposed copies are
    made contiguous)."""
    def bf16(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(torch.bfloat16).to(device)

    q, k = rng.randn(BQ, d), rng.randn(BK, d)
    p, v = rng.randn(BQ, BK), rng.randn(BK, d)
    pairs = {"s_lane": (q, k), "s_sub": (q.T, k.T), "pv_lane": (p, v), "pv_sub": (v.T, p)}
    out = {}
    for name, (a, b) in pairs.items():
        contract, a_shape, b_shape = LAYOUTS[name]
        assert a.shape == a_shape(d) and b.shape == b_shape(d)
        out[name] = (bf16(a), bf16(b), contract)
    return out


def _event_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def probe_layout(a, b, contract, blocks: int, lo: int = 512, hi: int = 2560, reps: int = 3) -> Dict[str, float]:
    """Per-iteration time of one layout by the slope between two iteration
    counts (the best of ``reps`` launches each, CUDA events), with a third
    count in the middle to show the time is linear in ``iters``: a compiler
    that hoisted the product out of the loop would give a flat line.

    Returns us per iteration, TFLOP/s of the whole card (``blocks`` blocks
    at once, 2*M*N*K operations per iteration and block), the share of the
    bf16 peak when ``blocks`` is the SM count, the bytes one block reads
    from the L2 per iteration (``plan``), and ``linearity``, the first
    half's slope over the whole slope."""
    if a.device.type != "cuda":
        raise RuntimeError("probe_layout times the kernel on the card; it needs CUDA tensors")
    (ca,), (cb,) = contract
    flops = 2.0 * a.shape[1 - ca] * b.shape[1 - cb] * a.shape[ca]
    mid = (lo + hi) // 2
    probe(a, b, contract, lo, blocks)  # build, load, warm up
    t = {n: min(_event_ms(lambda: probe(a, b, contract, n, blocks)) for _ in range(reps)) for n in (lo, mid, hi)}
    per_iter_ms = (t[hi] - t[lo]) / (hi - lo)
    if not per_iter_ms > 0:
        raise RuntimeError(f"the probe's time does not grow with iters: {t}")
    tflops = blocks * flops / (per_iter_ms * 1e-3) / 1e12
    return {"us_per_iter": per_iter_ms * 1e3, "tflops": tflops, "share_of_bf16_peak": tflops * 1e12 / PEAK_BF16,
            "l2_bytes_per_iter": plan_for(a, b, contract)["l2_bytes_per_iter"],
            "linearity": (t[mid] - t[lo]) / (mid - lo) / per_iter_ms,
            "bound_us_per_iter": flops * blocks / PEAK_BF16 * 1e6, "ms_lo": t[lo], "ms_hi": t[hi]}


def main(argv=()) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Time the 12 layout x head-dim cases and print the table, then one
    JSON line with the card's name and power limit. With ``--root`` naming
    another checkout, that checkout's tool runs in a process of its own
    (its package imported from its root, its kernel built there) and its
    JSON line is printed with ``--label``."""
    parser = argparse.ArgumentParser(description="the tile-shape probe's table on the card")
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--root", default=here, help="checkout to time the probe of (default: this one)")
    parser.add_argument("--label", default="", help="name printed with the JSON line")
    args = parser.parse_args(list(argv))
    if os.path.realpath(args.root) != os.path.realpath(here):
        root = os.path.abspath(args.root)
        proc = subprocess.run([sys.executable, "-m", "image_editing_framework_torch.tools.bench_attn_layouts"],
                              cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            raise SystemExit(f"bench_attn_layouts under {root} failed:\n{proc.stderr}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"label": args.label, "root": root, **line}), flush=True)
        return line["results"]
    if not torch.cuda.is_available():
        raise SystemExit("bench_attn_layouts: no CUDA device available (the probe kernel runs on the card only)")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.RandomState(0)
    results = {}
    for d in HEAD_DIMS:
        results[d] = {name: probe_layout(a, b, contract, blocks)
                      for name, (a, b, contract) in operands(d, rng, "cuda").items()}
        print(f"d={d:4d}  " + "  ".join(
            f"{name} {r['us_per_iter']:7.3f} us ({r['tflops']:6.1f} TF/s, {100 * r['share_of_bf16_peak']:4.1f}%)"
            for name, r in results[d].items()), flush=True)
    print(json.dumps({"label": args.label, "card": card, "blocks": blocks, "results": results}), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])

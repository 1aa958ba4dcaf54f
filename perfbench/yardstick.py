"""The benchmark's arithmetic: the card's published peaks, the work and
least time of an attention call, and the model FLOPs of a group.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at
its full 700 W limit: 989 TFLOP/s in bf16, 3.35 TB/s of HBM. The attention
work functions count what the algorithm needs (two products forward, five
backward; each input read once and each output written once), whatever a
kernel computes again.
"""

from __future__ import annotations

from typing import Callable

PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def attn_work(b, h, nq, nk, d):
    """(FLOPs, bytes) of a bf16 attention forward: q k^T and p v; q, k, v
    read once and o written once."""
    return 4.0 * b * h * nq * nk * d, (2 * b * h * nq * d + 2 * b * h * nk * d) * BF16_BYTES


def bwd_work(b, h, nq, nk, d):
    """(FLOPs, bytes) of a bf16 attention backward: S, dP, dV, dQ and dK
    (five products); q, k, v, o, dO read and dq, dk, dv written."""
    return 10.0 * b * h * nq * nk * d, (4 * nq + 4 * nk) * b * h * d * BF16_BYTES


def bound_s(flops, nbytes):
    """Least time on the card: the larger of operations over the bf16 peak
    and bytes over the memory rate."""
    return max(flops / PEAK_BF16, nbytes / HBM_BYTES_PER_S)


def count_flops(fn: Callable[[], object]) -> float:
    """FLOPs of the products (matmul, convolution, their backward) ``fn``
    runs, by ``torch.utils.flop_counter.FlopCounterMode``; run it on
    ``meta`` tensors and it costs no compute."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())

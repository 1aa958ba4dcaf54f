"""The flash forward's share of its roofline at self-attention sites over
4096 query tokens: the least time of those calls (their shapes,
``perfbench/yardstick.py``) over their ``flash_fwd_bf16`` kernels' device
time, in %. Kernels are matched to calls by launch order
(``perfbench/long_attention.py``)."""

from perfbench.long_attention import long_calls
from perfbench.yardstick import attn_work, bound_s


def read(run):
    found = long_calls(run)
    if found is None:
        return None
    device_s = sum(s for _, s in found)
    if device_s <= 0:
        return None
    return 100.0 * sum(bound_s(*attn_work(b, h, nq, nk, d)) for (b, h, nq, nk, d, _), _ in found) / device_s

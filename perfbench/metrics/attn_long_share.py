"""The share of the profiled group's device time that the flash forward
takes at self-attention sites over 4096 query tokens (SD2.1's 9216-token
first level at 768²): those calls' ``flash_fwd_bf16`` kernel time over the
capture's busy time, in %. Kernels are matched to calls by launch order
(``perfbench/long_attention.py``)."""

from perfbench.long_attention import long_calls


def read(run):
    found = long_calls(run)
    if found is None or run.capture.busy_s <= 0:
        return None
    return 100.0 * sum(s for _, s in found) / run.capture.busy_s

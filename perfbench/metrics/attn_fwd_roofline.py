"""The flash forward's share of its roofline over the profiled group: the
least time of every self-attention call at the UNet's boundary (its shapes,
``perfbench/yardstick.py``) over the device time of the ``flash_fwd_bf16``
kernels, in %."""

from perfbench.yardstick import attn_work, bound_s


def read(run):
    if run.capture is None or not run.attn_calls:
        return None
    device_s = run.capture.device_time("flash_fwd_bf16")
    if device_s <= 0:
        return None
    return 100.0 * sum(bound_s(*attn_work(b, h, nq, nk, d)) for b, h, nq, nk, d, _ in run.attn_calls) / device_s

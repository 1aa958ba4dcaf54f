"""The flash backward's share of its roofline over the profiled group: the
least time of the backward of every differentiated self-attention call
(five products; ``perfbench/yardstick.py``) over the device time of the
``bwd_dq_bf16`` and ``bwd_dkv_bf16`` kernels, in %. The small ``_bwd_di``
reduction outside them is not in the time."""

from perfbench.yardstick import bound_s, bwd_work


def read(run):
    calls = [c for c in run.attn_calls if c[5]]
    if run.capture is None or not calls:
        return None
    device_s = run.capture.device_time("bwd_dq_bf16", "bwd_dkv_bf16")
    if device_s <= 0:
        return None
    return 100.0 * sum(bound_s(*bwd_work(b, h, nq, nk, d)) for b, h, nq, nk, d, _ in calls) / device_s

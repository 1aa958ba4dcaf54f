"""The profiled group's self-attention calls over 4096 query tokens, each
with the device time of its flash forward kernel.

The harness notes every call at ``models/unet.py``'s ``self_attention``
boundary in order (``run.attn_calls``: B, H, Nq, Nk, D, differentiated),
and each call launches one ``flash_fwd_bf16`` kernel on the one stream, so
the k-th kernel of the capture, by start, is the k-th call's. The program
counts ``attn_long_calls`` (``ops/attention.py self_attention``) under its
innermost open span; the calls the harness saw over 4096 tokens have to be
as many as that counter holds under the profiled group's ``group`` span,
and the kernels as many as the calls, or the match is not trusted and the
readers return None. A program without the counter gives None too.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from perfbench.program_spans import below, in_capture, of

LONG_SEQ = 4096  # the longest site of SD1.5 and SDXL
KERNEL = "flash_fwd_bf16"
COUNTER = "attn_long_calls"


def long_calls(run) -> Optional[List[Tuple[tuple, float]]]:
    """[(call, kernel seconds)] of the profiled group's self-attention calls
    whose query is longer than ``LONG_SEQ``, in order; None where there is
    no capture, no such call, or the kernels, the calls and the program's
    counter disagree."""
    if run.capture is None or not run.attn_calls:
        return None
    kernels = sorted((s, e) for n, s, e in run.capture.kernels if KERNEL in n)
    if len(kernels) != len(run.attn_calls):
        return None
    found = [(call, (e - s) / 1e9) for call, (s, e) in zip(run.attn_calls, kernels) if call[2] > LONG_SEQ]
    if not found:
        return None
    spans = of(run)
    idx = in_capture(run.capture, spans)
    groups = [i for i in idx if spans[i][0] == "group"]
    counted = sum(spans[i][4].get(COUNTER, 0) for i in groups + below(spans, "group", idx))
    return found if counted == len(found) else None

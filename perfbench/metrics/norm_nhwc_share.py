"""The share of the UNet's and the VAE's GroupNorm calls on the card that
launched the NHWC GroupNorm kernel (``ops/group_norm.py``,
``csrc/group_norm_nhwc.cu``): the program's ``norm_nhwc`` counter over its
``norm_calls`` counter, both summed over the profiled group's ``group`` span
and the spans below it, in %. Both count eager calls and a CUDA graph's
capture, a replay neither, so their ratio holds where the inversion replays
its graphs. A program without the counters gives no value."""

from perfbench.program_spans import below, in_capture, of


def read(run):
    if run.capture is None:
        return None
    spans = of(run)
    idx = in_capture(run.capture, spans)
    groups = [i for i in idx if spans[i][0] == "group"]
    if not groups:
        return None
    among = groups + below(spans, "group", idx)
    calls = sum(spans[i][4].get("norm_calls", 0) for i in among)
    if not calls:
        return None
    return 100.0 * sum(spans[i][4].get("norm_nhwc", 0) for i in among) / calls

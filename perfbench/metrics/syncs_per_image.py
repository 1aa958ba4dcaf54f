"""Host waits for the device per image: the program's ``syncs`` counter
(``torch.cuda.set_sync_debug_mode("warn")``'s reports, counted under the
innermost open span) summed over the spans below the profiled group's
``group`` span (``eval/sweep.py _edit_group``), over the group's images.
The harness's own syncs fall outside those spans, as does the wait that
ends each ``invert`` and ``edit`` span of the tracer's."""

from perfbench.program_spans import below, in_capture, of


def read(run):
    if run.capture is None:
        return None
    spans = of(run)
    idx = in_capture(run.capture, spans)
    groups = [i for i in idx if spans[i][0] == "group"]
    if not groups:
        return None
    return sum(spans[i][4].get("syncs", 0) for i in below(spans, "group", idx)) / (len(groups) * run.group)

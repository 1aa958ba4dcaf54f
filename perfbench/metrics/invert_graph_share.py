"""The share of the inversion's steps that replayed the captured UNet
forward (``inversion/graphs.py``): the program's ``graph_replays`` counter
summed over the profiled group's ``invert`` spans and the spans below them,
over their ``step`` spans, in %. A step that captures (a shape's first,
counted as ``graph_captures``) or runs the forward eagerly adds no replay;
the cells warm every shape up before the window, so there it reads 100."""

from perfbench.program_spans import below, in_capture, inversion_steps


def read(run):
    found = inversion_steps(run)
    if found is None:
        return None
    spans, invert, steps = found
    under = invert + below(spans, "invert", in_capture(run.capture, spans))
    return 100.0 * sum(spans[i][4].get("graph_replays", 0) for i in under) / len(steps)

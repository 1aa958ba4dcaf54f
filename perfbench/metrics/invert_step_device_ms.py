"""The device's time for one inversion step: the busy device time inside
the program's ``invert`` spans of the profiled group over the number of
their ``step`` spans, in ms. Against ``invert_step_host_ms``: a host figure
above it means the host's issue paces the inversion."""

from perfbench.program_spans import Busy, inversion_steps


def read(run):
    found = inversion_steps(run)
    if found is None:
        return None
    spans, invert, steps = found
    busy = Busy(run.capture)
    return sum(busy.within(spans[i][1], spans[i][2]) for i in invert) / len(steps) / 1e6

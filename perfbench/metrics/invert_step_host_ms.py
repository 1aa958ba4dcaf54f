"""The host's time to issue one inversion step: the mean length of the
program's ``step`` spans under its ``invert`` spans
(``inversion/ddim.py _invert_scan``) in the profiled group, in ms."""

from perfbench.program_spans import inversion_steps


def read(run):
    found = inversion_steps(run)
    if found is None:
        return None
    spans, _, steps = found
    return sum(spans[i][2] - spans[i][1] for i in steps) / len(steps) / 1e6

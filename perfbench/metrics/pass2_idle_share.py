"""The device's idle share inside the program's ``pass2`` spans
(``methods/p2z.py _guided_scan_group``: pix2pix-zero's guided steps) of the
profiled group, in %, as ``invert_idle_share``."""

from perfbench.program_spans import idle_share


def read(run):
    return idle_share(run, "pass2")

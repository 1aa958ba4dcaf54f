"""The device's idle share inside the program's ``invert`` spans
(``eval/batched.py ddim_invert_batch``, ending in a device sync) of the
profiled group: their length not covered by any kernel over their summed
length, in %. The spans and the kernels share the host clock
(``perfbench/program_spans.py``)."""

from perfbench.program_spans import idle_share


def read(run):
    return idle_share(run, "invert")

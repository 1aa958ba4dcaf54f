"""Seconds per image inside ``eval/batched.py ddim_invert_batch`` (DDIM
inversion of a group; the span ends in a device sync), host spans over the
traced window."""


def read(run):
    return sum(e - s for name, s, e in run.spans if name == "invert") / 1e9 / run.images

"""Seconds per image inside ``eval/batched.py edit_batch`` (the method's
denoising loops and the decode; the span ends in a device sync), host spans
over the traced window."""


def read(run):
    return sum(e - s for name, s, e in run.spans if name == "edit") / 1e9 / run.images

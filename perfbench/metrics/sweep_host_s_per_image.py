"""Seconds per image of the traced window outside the inversion and the
edit (``eval/sweep.py``: encodes, decode ahead, saves, metric threads, the
calling thread between groups), from the harness's host spans."""


def read(run):
    inner = sum(e - s for name, s, e in run.spans if name in ("invert", "edit")) / 1e9
    return (run.window_s - inner) / run.images

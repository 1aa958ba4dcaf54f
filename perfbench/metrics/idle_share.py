"""The device's idle share of the profiled group: 1 - (union of its
operations' intervals / the group's wall time), both from one capture, in %."""


def read(run):
    if run.capture is None or run.capture.wall_s <= 0:
        return None
    return 100.0 * (1.0 - run.capture.busy_s / run.capture.wall_s)

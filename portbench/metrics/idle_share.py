"""Device: the share of the traced slice's wall time in which no operation
ran on the card, 1 - (union of the device activity intervals) / (the
slice's host-clock seconds), from the profiler's CUDA events."""

UNIT = "%"


def read(run):
    t = run.trace
    if t is None or not t["busy_s"] or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

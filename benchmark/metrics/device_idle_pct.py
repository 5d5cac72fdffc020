"""Share of the traced window in which no operation ran on the device:
100 x (1 - union of the device operations' intervals / window)."""

from benchmark.profile_events import busy_ns


def read(w):
    if w.trace is None or not w.trace.ops:
        return None
    span = w.trace.t1 - w.trace.t0
    return 100.0 * (1.0 - busy_ns(w.trace) / span)

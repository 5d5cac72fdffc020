"""Device operations (kernels, copies, fills) the profiler saw in the
traced window, over the statements answered in it."""

from benchmark.profile_events import ops_in_window


def read(w):
    if w.trace is None or not w.stmts:
        return None
    return len(ops_in_window(w.trace)) / len(w.stmts)

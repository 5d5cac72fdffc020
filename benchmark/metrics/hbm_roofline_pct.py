"""The least device time the window's statements need, as a share of
the device's busy time.  Least time: each statement's scanned columns at
their packed width (the configuration's `packed_bits`: ceil(log2 of the
values its generator can draw), whatever implements the scan) times the
table's rows, read once from device memory at the card's published
bandwidth (`peaks.json`)."""

from benchmark.profile_events import busy_ns


def read(w):
    if w.trace is None or not w.stmts or w.peaks is None:
        return None
    busy = busy_ns(w.trace) / 1e9
    if busy <= 0:
        return None
    least = sum(s["bytes_least"] for s in w.stmts) / w.peaks["hbm_bytes_per_s"]
    return 100.0 * least / busy

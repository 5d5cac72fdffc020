"""Plan-cache hits over hits and misses, from the program's counters'
moves over the window."""


def read(w):
    hits = w.counters.get("plan_cache_hits_total", 0)
    misses = w.counters.get("plan_cache_misses_total", 0)
    if hits + misses <= 0:
        return None
    return 100.0 * hits / (hits + misses)

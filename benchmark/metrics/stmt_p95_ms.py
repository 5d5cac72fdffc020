"""95th percentile (nearest rank) of the client-side latency of every
statement sent in the window and answered, from its send to its last
row."""

import math


def read(w):
    lat = sorted(s["t_done"] - s["t_send"] for s in w.stmts)
    if not lat:
        return None
    return lat[max(math.ceil(0.95 * len(lat)) - 1, 0)] * 1e3

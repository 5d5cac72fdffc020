"""Chunk budgets for interruptible device dispatch.

An in-flight XLA dispatch cannot be interrupted — the host only regains
control between launches.  So the dispatcher splits any fragment whose
estimated device time exceeds ``tidb_tpu_dispatch_chunk_ms`` into a
sequence of range-slot sub-dispatches over the SAME compiled program:
range bounds already ride the program as runtime scalar operands
(`MESH_RANGE_SLOTS` in copr/parallel.py), so chunking changes only the
operand VALUES — never the jaxpr, never the fingerprint, never a
recompile.  Between chunks the dispatcher checks the statement's
QueryScope and re-acquires resource-group admission, which bounds
KILL/timeout/quota latency by one chunk budget and lets a depleted
group's monster scan yield the device at every boundary.

The rows-per-chunk budget is derived from the measured per-kind chunk
latency histograms (`dispatch_chunk_<kind>_ms` / `_rows`, fed back by
`observe_chunk` after every dispatch — the same log2 histograms the SLO
plane uses), falling back to a flat rows-per-ms heuristic until the
first observations land.

A fragment that carries a float SUM or AVG takes the fixed budget
FLOAT_CHUNK_ROWS instead: the host adds the chunks' float partials in
chunk order, so chunk edges learned from the statements the process ran
before would move the sum's bits.  With a fixed budget its edges, and
so its float sums, depend on the statement, the table and its regions
alone (the JAX package keeps the learned budget for every fragment).

Knobs:

- ``tidb_tpu_dispatch_chunk_ms`` sysvar / ``TIDB_TPU_DISPATCH_CHUNK``
  env: target device ms per chunk; 0 disables chunking entirely (the
  bench comparator: one dispatch per fragment).
- ``TIDB_TPU_DISPATCH_CHUNK_ROWS``: direct rows-per-chunk override for
  deterministic tests (bypasses the latency estimate and the fixed
  float budget).
- ``TIDB_TPU_CHUNK_ROWS_PER_MS``: the cold-start throughput guess.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

from ..metrics import REGISTRY

#: chunk kinds with their own latency/row histograms
CHUNK_KINDS = ("filter", "agg", "topn", "tile", "mpp", "batch")

#: never chunk below this many rows: a mis-estimated throughput must
#: degrade into a few extra launches, not thousands of tiny ones
MIN_CHUNK_ROWS = 1024

#: rows per dispatch chunk of a fragment with a float SUM or AVG.  At the
#: H100's measured scan rate (TPC-H Q1 at SF10: 60 M rows in ~66 ms on
#: the card) a chunk is ~18 ms of device time, inside the default
#: 100 ms target; its widened f64 column is 128 MiB on the card.
FLOAT_CHUNK_ROWS = 1 << 24

# process-wide override installed by `SET tidb_tpu_dispatch_chunk_ms`
# (None = fall through to the env / default)
_CHUNK_MS: Optional[float] = None
_DEFAULT_CHUNK_MS = 100.0


def dispatch_chunk_ms() -> float:
    """Target device milliseconds per chunk; <= 0 disables chunking."""
    if _CHUNK_MS is not None:
        return _CHUNK_MS
    try:
        return float(os.environ.get("TIDB_TPU_DISPATCH_CHUNK",
                                    str(_DEFAULT_CHUNK_MS)))
    except ValueError:
        return _DEFAULT_CHUNK_MS


def set_dispatch_chunk_ms(ms: Optional[float]):
    """Sysvar hook (session/_run_set): GLOBAL-scope SET retargets the
    process knob, mirroring the serving sysvars."""
    global _CHUNK_MS
    _CHUNK_MS = None if ms is None else float(ms)


def _rows_per_ms(kind: str) -> float:
    """Measured rows/ms for `kind` from the chunk histograms' medians,
    or the cold-start heuristic.  Median-of-log2-buckets is within one
    bucket of truth — plenty for a budget that only has to land the
    chunk near the ms target, not exactly on it."""
    med_ms = REGISTRY.quantile(f"dispatch_chunk_{kind}_ms", 0.5, 0.0)
    med_rows = REGISTRY.quantile(f"dispatch_chunk_{kind}_rows", 0.5, 0.0)
    if med_ms > 0.0 and med_rows > 0.0:
        return med_rows / med_ms
    try:
        return float(os.environ.get("TIDB_TPU_CHUNK_ROWS_PER_MS", "8192"))
    except ValueError:
        return 8192.0


def chunk_budget_rows(kind: str, fixed: bool = False) -> int:
    """Rows per chunk for `kind`; 0 = chunking disabled.  `fixed` (a
    fragment with a float SUM or AVG) takes FLOAT_CHUNK_ROWS instead of
    the learned rows/ms."""
    rows_env = os.environ.get("TIDB_TPU_DISPATCH_CHUNK_ROWS")
    if rows_env:
        try:
            n = int(rows_env)
            return max(n, 0)
        except ValueError:
            pass
    ms = dispatch_chunk_ms()
    if ms <= 0:
        return 0
    if fixed:
        return FLOAT_CHUNK_ROWS
    return max(int(ms * _rows_per_ms(kind)), MIN_CHUNK_ROWS)


def chunk_bounds(bounds: Sequence[Tuple[int, int]], budget_rows: int,
                 max_slots: int = 4) -> List[List[Tuple[int, int]]]:
    """Split [(lo, hi), ...] into per-chunk bound lists: each chunk
    covers at most `budget_rows` rows across at most `max_slots` ranges
    (the program's range-slot count).  budget 0 → one chunk, verbatim —
    the disabled path MUST be byte-identical to the old single
    dispatch.  Ranges stay ascending and disjoint, so rows-path
    concatenation preserves order."""
    if not bounds:
        return []
    if budget_rows <= 0:
        return [list(bounds)]
    out: List[List[Tuple[int, int]]] = []
    cur: List[Tuple[int, int]] = []
    cur_rows = 0
    for lo, hi in bounds:
        pos = lo
        while pos < hi:
            if cur and (cur_rows >= budget_rows or len(cur) >= max_slots):
                out.append(cur)
                cur, cur_rows = [], 0
            take = min(hi - pos, budget_rows - cur_rows)
            cur.append((pos, pos + take))
            cur_rows += take
            pos += take
    if cur:
        out.append(cur)
    return out


def observe_chunk(kind: str, ms: float, rows: int):
    """Feed one completed chunk back into the budget estimate and the
    chunk telemetry (/metrics, EXPLAIN ANALYZE `chunks: N`)."""
    REGISTRY.inc("dispatch_chunks_total")
    REGISTRY.observe_hist(f"dispatch_chunk_{kind}_ms", ms)
    REGISTRY.observe_hist(f"dispatch_chunk_{kind}_rows", float(rows))

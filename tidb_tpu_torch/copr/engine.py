"""Region-level coprocessor dispatch.

Reference: the storage-node side of the cop request (TiKV's coprocessor;
simulated in-process by mocktikv/cop_handler_dag.go:56-97).  Per region:

1. read the MVCC delta overlay at the snapshot ts (deleted base rows +
   committed inserted/updated rows) — the UnionScan merge, done store-side
2. run the DAG over base rows on the requested engine (tpu via torch, falling
   back to cpu on DeviceUnsupported), with deleted rows masked out
3. run the DAG over delta rows on the cpu engine
4. merge the two result streams per DAG tail (agg partials: concat;
   topn: re-topn; limit: slice; plain rows: concat)
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..chunk import Chunk, Column
from ..store.kv import CopRequest, CopResponse
from ..types import TypeKind
from .cpu_engine import run_dag_on_chunk, run_topn
from .ir import DAG, AggregationIR, LimitIR, TopNIR
from .torch_eval import DeviceUnsupported


def run_dag_on_region(storage, req: CopRequest, region, clipped) -> CopResponse:
    table = storage.table(region.table_id)
    dag = DAG.from_dict(req.dag)
    aux = req.aux
    ts = req.ts
    deleted, inserted = table.delta_overlay(ts, clipped.start, clipped.end)

    chunks: List[Chunk] = []
    base_end = min(clipped.end, table.base_rows)
    table.check_read_horizon(ts)
    if table.base_ts <= ts and clipped.start < base_end:
        if req.engine == "tpu":
            try:
                # fused-region execution with the per-phase fallback
                # ladder (copr/fusion.py): an unfusable suffix runs as a
                # host tail over the fused region's output; only a
                # fragment with no device-eligible region at all steps
                # down to the CPU interpreter
                from .fusion import run_fragment

                chunks.extend(
                    run_fragment(table, dag, clipped.start, base_end,
                                 deleted, aux=aux)
                )
            except DeviceUnsupported:
                chunks.extend(
                    _run_base_cpu(table, dag, clipped.start, base_end,
                                  deleted, aux)
                )
        else:
            chunks.extend(
                _run_base_cpu(table, dag, clipped.start, base_end, deleted,
                              aux)
            )
    if inserted:
        handles = sorted(inserted)
        scan = dag.scan
        cols = []
        for out_i, store_ci in enumerate(scan.columns):
            ft = scan.ftypes[out_i]
            vals = [inserted[h][store_ci] for h in handles]
            cols.append(Column.from_values(ft, vals))
        delta_chunk = Chunk(cols)
        res = run_dag_on_chunk(dag, delta_chunk, aux)
        if res.num_rows:
            chunks.append(res)

    chunks = _merge_tail(dag, chunks)
    return CopResponse(chunks=[c for c in chunks if c.num_rows > 0])


def _run_base_cpu(table, dag: DAG, start: int, end: int,
                  deleted, aux=None) -> List[Chunk]:
    """CPU path over base rows, tile by tile (bounded memory).  Each
    call counts on `cop_region_cpu_runs_total`, so a route check can
    tell a region the device served from one the host engine did."""
    from ..metrics import REGISTRY

    REGISTRY.inc("cop_region_cpu_runs_total")
    TILE = 1 << 18
    del_arr = np.asarray(sorted(deleted), dtype=np.int64)
    out: List[Chunk] = []
    scan = dag.scan
    for t0 in range(start, end, TILE):
        t1 = min(t0 + TILE, end)
        chunk = table.base_chunk(scan.columns, t0, t1)
        if len(del_arr):
            dd = del_arr[(del_arr >= t0) & (del_arr < t1)] - t0
            if len(dd):
                keep = np.ones(chunk.num_rows, dtype=np.bool_)
                keep[dd] = False
                chunk = chunk.filter(keep)
        res = run_dag_on_chunk(dag, chunk, aux)
        if res.num_rows:
            out.append(res)
    return out


def _merge_tail(dag: DAG, chunks: List[Chunk]) -> List[Chunk]:
    """Per-region merge of per-tile results according to the DAG tail."""
    if len(chunks) <= 1:
        return chunks
    tail = dag.executors[-1]
    if isinstance(tail, TopNIR):
        merged = chunks[0]
        for c in chunks[1:]:
            merged = merged.append(c)
        return [run_topn(tail.order_by, tail.limit, merged)]
    if isinstance(tail, LimitIR):
        out: List[Chunk] = []
        left = tail.limit
        for c in chunks:
            if left <= 0:
                break
            take = c.slice(0, min(left, c.num_rows))
            out.append(take)
            left -= take.num_rows
        return out
    # aggregation partials and plain row streams: pass through, the root
    # executor merges
    return chunks

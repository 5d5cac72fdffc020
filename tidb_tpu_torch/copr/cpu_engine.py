"""CPU coprocessor engine: the DAG interpreter over host chunks.

Two roles (SURVEY.md §7): the correctness oracle the jax engine is diffed
against, and the real execution path for delta rows / non-pushable regions —
the moral successor of mocktikv's row-based DAG interpreter
(mocktikv/cop_handler_dag.go:56-177), but columnar/vectorized.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from ..chunk import Chunk, Column
from ..errors import ExecutorError
from ..expr.expression import eval_bool_mask
from ..expr.vec import Vec
from ..types import TypeKind
from . import aggstate
from .ir import (
    DAG,
    AggregationIR,
    JoinLookupIR,
    JoinProbeIR,
    LimitIR,
    ProjectionIR,
    SelectionIR,
    TableScanIR,
    TopNIR,
    key_bits_int64,
)


def run_dag_on_chunk(dag: DAG, chunk: Chunk, aux: Optional[dict] = None) -> Chunk:
    """Interpret the post-scan part of `dag` over one scan-output chunk."""
    for ex in dag.executors[1:]:
        if isinstance(ex, SelectionIR):
            mask = eval_bool_mask(ex.conditions, chunk)
            chunk = chunk.filter(mask)
        elif isinstance(ex, JoinProbeIR):
            keys = (aux or {}).get(f"probe_keys_{ex.filter_id}")
            if keys is None:
                raise ExecutorError(
                    f"missing runtime probe keys {ex.filter_id}"
                )
            v = ex.key.eval(chunk)
            bits = key_bits_int64(v.data)
            pos = np.searchsorted(keys, bits)
            pos_c = np.clip(pos, 0, max(len(keys) - 1, 0))
            member = (
                (keys[pos_c] == bits) & v.validity()
                if len(keys) else np.zeros(chunk.num_rows, dtype=np.bool_)
            )
            chunk = chunk.filter(member)
        elif isinstance(ex, JoinLookupIR):
            keys = (aux or {}).get(f"probe_keys_{ex.filter_id}")
            payload = (aux or {}).get(f"payload_{ex.filter_id}")
            pvalids = (aux or {}).get(f"payload_valid_{ex.filter_id}")
            if keys is None or payload is None:
                raise ExecutorError(
                    f"missing join lookup aux {ex.filter_id}")
            v = ex.key.eval(chunk)
            bits = key_bits_int64(v.data)
            if len(keys):
                pos = np.searchsorted(keys, bits)
                pos_c = np.clip(pos, 0, len(keys) - 1)
                member = (keys[pos_c] == bits) & v.validity()
            else:
                pos_c = np.zeros(chunk.num_rows, dtype=np.int64)
                member = np.zeros(chunk.num_rows, dtype=np.bool_)
            chunk = chunk.filter(member)
            hit_pos = pos_c[member]
            cols = list(chunk.columns)
            for j, ft in enumerate(ex.payload_ftypes):
                data = payload[j][hit_pos] if len(keys) else \
                    payload[j][:0]
                pv = None
                if pvalids is not None and pvalids[j] is not None:
                    pv = pvalids[j][hit_pos] if len(keys) else \
                        pvalids[j][:0]
                cols.append(Column(ft, data, pv))
            chunk = Chunk(cols)
        elif isinstance(ex, ProjectionIR):
            chunk = Chunk([e.eval(chunk).to_column() for e in ex.exprs])
        elif isinstance(ex, AggregationIR):
            chunk = _run_agg(ex, chunk)
        elif isinstance(ex, TopNIR):
            chunk = run_topn(ex.order_by, ex.limit, chunk)
        elif isinstance(ex, LimitIR):
            chunk = chunk.slice(0, min(ex.limit, chunk.num_rows))
        else:
            raise ExecutorError(f"cpu engine: unknown executor {ex!r}")
    return chunk


def grouped_partial_chunks(group_by, aggs, chunks) -> List[Chunk]:
    """Grouped PARTIAL aggregation over row chunks, one partial chunk
    ([keys..., states...] layout) per non-empty input chunk — the shared
    host-tail recipe of the MPP agg-peel rung and the MPP host fallback
    (a FINAL HashAgg upstream merges groups across chunks)."""
    agg_ir = AggregationIR(list(group_by), list(aggs), mode="partial")
    out: List[Chunk] = []
    for c in chunks:
        if not c.num_rows:
            continue
        r = _run_agg(agg_ir, c)
        if r.num_rows:
            out.append(r)
    return out


def _run_agg(agg_ir: AggregationIR, chunk: Chunk) -> Chunk:
    gcols = [g.eval(chunk).to_column() for g in agg_ir.group_by]
    if gcols:
        gidx, first, G = aggstate.group_indices(gcols)
    else:
        # scalar aggregation: one group, one output row
        gidx, first, G = np.zeros(chunk.num_rows, dtype=np.int64), None, 1
    # group-key output columns (one row per group)
    out_cols: List[Column] = (aggstate.key_columns(
        [Column(g.ftype, c.data, c.valid)
         for g, c in zip(agg_ir.group_by, gcols)], first) if gcols else [])
    for a in agg_ir.aggs:
        if a.distinct:
            cols = _distinct_states(a, chunk, gidx, G)
        else:
            arg_vecs = [x.eval(chunk) for x in a.args]
            cols = aggstate.partial_states(a, arg_vecs, gidx, G)
        if agg_ir.mode == "complete":
            out_cols.append(aggstate.finalize(a, cols))
        else:
            out_cols.extend(cols)
    return Chunk(out_cols)


def _distinct_states(a, chunk: Chunk, gidx: np.ndarray, G: int):
    """COUNT/SUM/AVG(DISTINCT x): dedup (group, value) pairs first."""
    arg_vecs = [x.eval(chunk) for x in a.args]
    n = chunk.num_rows
    seen = set()
    keep = np.zeros(n, dtype=np.bool_)
    cols = [v.to_column() for v in arg_vecs]
    for i in range(n):
        key = (int(gidx[i]),) + tuple(c.get(i) for c in cols)
        if key not in seen:
            seen.add(key)
            keep[i] = True
    sub_vecs = [Vec.from_column(c.filter(keep)) for c in cols]
    return aggstate.partial_states(a, sub_vecs, gidx[keep], G)


def run_topn(order_by, limit: int, chunk: Chunk) -> Chunk:
    """Stable multi-key sort + head(limit).  NULLs sort first ascending
    (MySQL semantics), last descending."""
    if chunk.num_rows == 0 or limit == 0:
        return chunk.slice(0, 0)
    idx = sort_indices(order_by, chunk)
    return chunk.take(idx[: limit if limit >= 0 else len(idx)])


def sort_indices(order_by, chunk: Chunk) -> np.ndarray:
    n = chunk.num_rows
    keys = []  # np.lexsort takes last key as primary -> reverse order
    for e, desc in reversed(list(order_by)):
        v = e.eval(chunk)
        data = v.data
        valid = v.validity()
        if data.dtype == object:
            if e.ftype.kind == TypeKind.DECIMAL:
                # wide decimals (e.g. DECIMAL(38, s) sums) hold Python
                # ints: rank them by value, not by their digits
                vals = [x if ok else 0 for x, ok in zip(data, valid)]
            else:
                # strings: rank via sorted unique values
                vals = [str(x) for x in data]
            rank = {s: i for i, s in enumerate(sorted(set(vals)))}
            data = np.fromiter(
                (rank[x] for x in vals), dtype=np.int64, count=n
            )
        else:
            data = data.astype(np.float64) if data.dtype == np.float64 else data
        if desc:
            if data.dtype == np.float64:
                key = np.where(valid, -data, np.inf)
            else:
                key = np.where(valid, -data.astype(np.int64), np.iinfo(np.int64).max)
        else:
            if data.dtype == np.float64:
                key = np.where(valid, data, -np.inf)
            else:
                key = np.where(
                    valid, data.astype(np.int64), np.iinfo(np.int64).min
                )
        keys.append(key)
    if not keys:
        return np.arange(n)
    return np.lexsort(keys)

"""Index lookup joins: batched probes into the inner table's sorted index.

Reference: executor/index_lookup_join.go:1-687 (outer worker batches outer
rows, inner worker turns join keys into index lookups and joins the fetched
rows), executor/index_lookup_hash_join.go (concurrent unordered variant),
executor/index_lookup_merge_join.go (key-ordered variant).

TPU-first redesign: the reference runs a goroutine pipeline with
row-at-a-time inner hash tables.  Here the matcher is one vectorized pass
per outer chunk — join keys are mapped into the index's native key domain
(sorted-dict codes for strings), two np.searchsorted calls expand the match
ranges exactly like the sort-merge join, and the matched inner rows arrive
via one sparse block gather.  The three reference variants collapse onto
the same matcher with different scheduling:

- lookup: sequential batches, output preserves outer-row order
- hash:   OrderedPipeline workers probe batches concurrently
          (tidb_index_lookup_join_concurrency)
- merge:  each outer batch is pre-sorted on the join key, so probes walk
          the index monotonically and output is key-ordered

MVCC/txn correctness mirrors IndexLookUpExec: handles with a delta chain or
txn-buffer entry are dropped from the (base-snapshot) index result and
re-matched on materialized row values instead.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..catalog import TableInfo
from ..chunk import Chunk, Column, concat_chunks
from ..errors import ExecutorError
from ..expr.expression import Expression, eval_bool_mask
from ..types import TypeKind
from .base import Executor, OrderedPipeline
from .index_reader import _overlay_sets
from .join import count_host_join_rows


class IndexLookUpJoinExec(Executor):
    """children = [outer].  The inner side is not an executor: it is a
    (table, index) pair probed per outer batch.

    outer_keys: exprs over the outer child's layout, one per used index
    column (in index-column order).  fetch_offsets: inner store columns
    materialized (inner schema ∪ inner cond columns); out_pick: positions
    within the fetch layout forming the inner output columns.
    """

    def __init__(self, ctx, outer: Executor, table: TableInfo,
                 index_offsets: List[int], outer_keys: List[Expression],
                 fetch_offsets: List[int], out_pick: List[int],
                 inner_conds: List[Expression],
                 other_conds: List[Expression], kind: str,
                 outer_is_left: bool = True, variant: str = "lookup",
                 plan_id: int = -1):
        fetch_ftypes = [table.columns[o].ftype for o in fetch_offsets]
        inner_out = [fetch_ftypes[i] for i in out_pick]
        if kind in ("semi", "anti_semi"):
            ftypes = list(outer.ftypes)
        elif kind == "left_outer":
            ftypes = list(outer.ftypes) + [
                ft.with_nullable(True) for ft in inner_out]
        elif outer_is_left:
            ftypes = list(outer.ftypes) + inner_out
        else:
            ftypes = inner_out + list(outer.ftypes)
        super().__init__(ctx, ftypes, [outer], plan_id)
        self.table = table
        self.index_offsets = index_offsets
        self.outer_keys = outer_keys
        self.fetch_offsets = fetch_offsets
        self.fetch_ftypes = fetch_ftypes
        self.out_pick = out_pick
        self.inner_conds = inner_conds
        self.other_conds = other_conds
        self.kind = kind
        self.outer_is_left = outer_is_left
        self.variant = variant
        self._pipe: Optional[OrderedPipeline] = None
        self._buf: List[Chunk] = []

    # ------------------------------------------------------------------
    def _open(self):
        self._buf = []
        workers = 1
        if self.variant == "hash":
            workers = max(1, self.ctx.vars.get_int(
                "tidb_index_lookup_join_concurrency", 4)
                if self.ctx.vars else 4)
        self._pipe = OrderedPipeline(
            workers, lambda: self.child(0).next(), self._match_batch)

    def _close(self):
        if self._pipe is not None:
            self._pipe.close()
            self._pipe = None
        self._buf = []

    def _next(self) -> Optional[Chunk]:
        while not self._buf:
            out = self._pipe.next()
            if out is None:
                return None
            self._buf = [c for c in out.split(self.ctx.chunk_size)
                         if c.num_rows]
        return count_host_join_rows(self._buf.pop(0))

    # ------------------------------------------------------------------
    # one outer batch -> joined output chunk
    # ------------------------------------------------------------------
    def _match_batch(self, oc: Chunk) -> Optional[Chunk]:
        store = self.ctx.storage.table(self.table.id)
        n = oc.num_rows
        if self.variant == "merge":
            oc = self._sort_outer(oc)

        # ---- outer join keys: value domain + index-native domain ------
        valid = np.ones(n, dtype=np.bool_)
        raw: List[np.ndarray] = []     # value domain (overlay matching)
        native: List[np.ndarray] = []  # index key domain (base matching)
        dict_cols = store.dict_encoded_cols()
        for j, e in enumerate(self.outer_keys):
            v = e.eval(oc)
            valid &= v.validity()
            data = v.data
            raw.append(data)
            off = self.index_offsets[j]
            if v.ftype.kind == TypeKind.STRING:
                if off in dict_cols:
                    uniq, inv = np.unique(data.astype(object, copy=False),
                                          return_inverse=True)
                    lut = np.array(
                        [store.encode_dict_const(off, str(s)) for s in uniq],
                        dtype=np.int64)
                    native.append(lut[inv])
                else:
                    # no dictionary -> no base rows; codes never match
                    native.append(np.full(n, -1, dtype=np.int64))
            elif v.ftype.kind == TypeKind.FLOAT:
                native.append(data.astype(np.float64, copy=False))
            else:
                native.append(data.astype(np.int64, copy=False))

        # ---- base-snapshot index probe --------------------------------
        idx = store.indexes.get(store, self.index_offsets)
        outer_idx = np.zeros(0, dtype=np.int64)
        handles = np.zeros(0, dtype=np.int64)
        if len(idx.handles) and n:
            if len(native) == 1:
                k0 = native[0]
                lo = np.searchsorted(idx.cols[0], k0, side="left")
                hi = np.searchsorted(idx.cols[0], k0, side="right")
            else:
                # composite key: narrow the run per trailing column BEFORE
                # expanding — a low-cardinality leading column would
                # otherwise blow up outer_batch x run_length intermediates
                lo = np.zeros(n, dtype=np.int64)
                hi = np.zeros(n, dtype=np.int64)
                for i in np.flatnonzero(valid):
                    key = tuple(nat[i] for nat in native)
                    lo[i], hi[i] = idx.search_slice(key, key)
            counts = np.where(valid, np.maximum(hi - lo, 0), 0)
            total = int(counts.sum())
            if total:
                outer_idx = np.repeat(np.arange(n), counts)
                cum = np.concatenate([[0], np.cumsum(counts)[:-1]])
                pos = (np.arange(total) - np.repeat(cum, counts)
                       + np.repeat(lo, counts))
                handles = idx.handles[pos]

        # ---- MVCC overlay: drop versioned handles, rematch on values --
        deleted, inserted, buffer, overlay = _overlay_sets(
            self.ctx, store, self.table.id)
        if overlay and len(handles):
            mask = ~np.isin(handles, np.fromiter(
                overlay, dtype=np.int64, count=len(overlay)))
            outer_idx, handles = outer_idx[mask], handles[mask]

        d_outer: List[int] = []
        d_rows: List[tuple] = []
        if inserted or buffer:
            by_key: dict = {}
            for i in np.flatnonzero(valid):
                k = tuple(r[i] for r in raw)
                by_key.setdefault(k, []).append(int(i))
            for h in sorted(set(inserted) | set(buffer)):
                if h in buffer:
                    m = buffer[h]
                    if m.op != "put":
                        continue
                    vals = m.values
                else:
                    vals = inserted[h]
                key = tuple(vals[o] for o in self.index_offsets)
                if None in key:
                    continue
                hits = by_key.get(key)
                if hits:
                    row = tuple(vals[o] for o in self.fetch_offsets)
                    for i in hits:
                        d_outer.append(i)
                        d_rows.append(row)

        # ---- materialize inner rows & pair up -------------------------
        parts_outer: List[np.ndarray] = []
        parts_inner: List[Chunk] = []
        if len(handles):
            ic = store.gather_chunk(self.fetch_offsets, handles)
            parts_outer.append(outer_idx)
            parts_inner.append(ic)
        if d_rows:
            cols = [Column.from_values(ft, [r[i] for r in d_rows])
                    for i, ft in enumerate(self.fetch_ftypes)]
            parts_outer.append(np.asarray(d_outer, dtype=np.int64))
            parts_inner.append(Chunk(cols))
        if parts_outer:
            pair_outer = np.concatenate(parts_outer)
            inner = concat_chunks(parts_inner)
            # outer-order emission (and groups delta matches with their
            # outer row): the IndexLookUpJoin/Merge keep-order property
            order = np.argsort(pair_outer, kind="stable")
            pair_outer = pair_outer[order]
            inner = Chunk([c.take(order) for c in inner.columns])
            if self.inner_conds:
                keep = eval_bool_mask(self.inner_conds, inner)
                pair_outer = pair_outer[keep]
                inner = inner.filter(keep)
        else:
            pair_outer = np.zeros(0, dtype=np.int64)
            inner = Chunk([Column.from_values(ft, [])
                           for ft in self.fetch_ftypes])

        # semi/anti with no other_conds collapse straight to the matched
        # bitmap — materializing outer++inner pairs would be pure waste
        need_pairs = (self.kind in ("inner", "left_outer")
                      or bool(self.other_conds))
        pairs = None
        if need_pairs:
            inner_out = inner.select(self.out_pick)
            pairs = self._pair_chunk(oc, pair_outer, inner_out)
            if self.other_conds and pairs.num_rows:
                keep = eval_bool_mask(self.other_conds, pairs)
                pair_outer = pair_outer[keep]
                pairs = pairs.filter(keep)
        matched = np.zeros(n, dtype=np.bool_)
        if len(pair_outer):
            matched[pair_outer] = True

        k = self.kind
        if k == "inner":
            return pairs
        if k == "semi":
            return oc.filter(matched)
        if k == "anti_semi":
            return oc.filter(~matched)
        if k == "left_outer":
            unmatched = oc.filter(~matched)
            pad = Chunk([Column.nulls(ft.with_nullable(True), unmatched.num_rows)
                         for ft in (self.fetch_ftypes[i]
                                    for i in self.out_pick)])
            outer_rows = Chunk(unmatched.columns + pad.columns)
            if pairs.num_rows == 0:
                return outer_rows
            if outer_rows.num_rows == 0:
                return pairs
            combined = pairs.append(outer_rows)
            src = np.concatenate([pair_outer, np.flatnonzero(~matched)])
            order = np.argsort(src, kind="stable")
            return Chunk([c.take(order) for c in combined.columns])
        raise ExecutorError(f"index join kind {self.kind!r}")

    def _pair_chunk(self, oc: Chunk, pair_outer: np.ndarray,
                    inner_out: Chunk) -> Chunk:
        ocols = [c.take(pair_outer) for c in oc.columns]
        icols = list(inner_out.columns)
        if self.kind == "left_outer":
            icols = [Column(c.ftype.with_nullable(True), c.data, c.valid)
                     for c in icols]
        # semi/anti also build the full pair layout: other_conds (e.g. a
        # correlated non-eq predicate) evaluate over outer++inner before
        # the match collapses to an existence bit
        if self.outer_is_left:
            return Chunk(ocols + icols)
        return Chunk(icols + ocols)

    def _sort_outer(self, oc: Chunk) -> Chunk:
        """merge variant: probe in key order so index walks are monotone."""
        keys = []
        for e in self.outer_keys:
            v = e.eval(oc)
            d = v.data
            keys.append(d if d.dtype != object
                        else np.array([str(x) for x in d], dtype=object))
        if not keys:
            return oc
        order = np.lexsort(tuple(reversed(keys)))
        return Chunk([c.take(order) for c in oc.columns])

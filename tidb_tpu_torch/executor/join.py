"""Join executors.

Reference: executor/join.go (HashJoinExec: build-side fetch :232, concurrent
probe workers :307,414), executor/hash_table.go, executor/joiner.go (outer/
semi/anti variants), executor/merge_join.go.

TPU-first design note: the probe loop here is *vectorized, not threaded* —
key columns are factorized to dense int64 codes (np.unique over a stacked key
matrix, C-side lexsort) and match pairs come from searchsorted arithmetic, so
a probe chunk is one batch of numpy kernels instead of the reference's
row-at-a-time goroutine workers.  The same factorize-join shape is what a
future Pallas kernel implements device-side.

Join kinds (probe side is always "left"/outer in the executor; the planner
swaps children to arrange this): inner, left_outer, semi, anti_semi,
left_outer_semi (left cols + matched flag, for IN subqueries).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np

from ..chunk import Chunk, Column, concat_chunks
from ..errors import ExecutorError
from ..expr.builtins import cast_vec
from ..expr.expression import Expression, eval_bool_mask
from ..expr.vec import Vec
from ..metrics import REGISTRY
from ..types import TypeKind, ty_bool
from .base import ExecContext, Executor
from ..util_concurrency import make_lock


#: declared at 0, so a window in which no host join ran reads 0 rather
#: than nothing
REGISTRY.inc("host_join_rows_total", 0)


def count_host_join_rows(chunk: Optional[Chunk]) -> Optional[Chunk]:
    """`chunk`, its rows added to `host_join_rows_total`: every join the
    host executes (hash, index lookup, merge, the MPP engines' host
    rungs) counts what it emits."""
    if chunk is not None and chunk.num_rows:
        REGISTRY.inc("host_join_rows_total", chunk.num_rows)
    return chunk


_STR_DICT_MU = make_lock("executor.join:_STR_DICT_MU")


def _key_matrix(chunk: Chunk, keys: List[Expression],
                str_dict: dict) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate key exprs -> (int64 matrix [n,k], any-null mask [n]).

    Shared str_dict maps strings to stable codes across build+probe; the
    lock keeps code assignment consistent under concurrent probe workers
    (the encode loop is pure Python/GIL-bound, so the lock costs nothing)."""
    n = chunk.num_rows
    cols = []
    null = np.zeros(n, dtype=np.bool_)
    for e in keys:
        v = e.eval(chunk)
        null |= ~v.validity()
        data = v.data
        if v.ftype.kind == TypeKind.FLOAT:
            from ..copr.ir import key_bits_int64

            cols.append(key_bits_int64(data))
        elif v.ftype.kind == TypeKind.STRING or data.dtype == object:
            codes = np.empty(n, dtype=np.int64)
            with _STR_DICT_MU:
                for i, s in enumerate(data):
                    key = str(s)
                    c = str_dict.get(key)
                    if c is None:
                        c = str_dict[key] = len(str_dict)
                    codes[i] = c
            cols.append(codes)
        else:
            cols.append(data.astype(np.int64, copy=False))
    if not cols:
        return np.zeros((n, 0), dtype=np.int64), null
    return np.stack(cols, axis=1), null


def _hash_combine(mat: np.ndarray) -> np.ndarray:
    """Row hash over an int64 key matrix (vectorized splitmix chain).

    Collisions are resolved by exact-key verification after match
    expansion (hash-join-with-verification) — so multi-column probes cost
    one vectorized hash instead of an np.unique(axis=0) per chunk."""
    n = mat.shape[0]
    if mat.shape[1] == 1:
        return mat[:, 0]  # raw values are exact — no verification needed
    h = np.zeros(n, dtype=np.uint64)
    for j in range(mat.shape[1]):
        x = mat[:, j].astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15) + h
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        h = x ^ (x >> np.uint64(31))
    return h.view(np.int64)


def _expand_matches(sorted_codes: np.ndarray, order: np.ndarray,
                    probe_codes: np.ndarray, probe_ok: np.ndarray):
    """All (probe_idx, build_idx) match pairs, vectorized."""
    lo = np.searchsorted(sorted_codes, probe_codes, side="left")
    hi = np.searchsorted(sorted_codes, probe_codes, side="right")
    counts = np.where(probe_ok, hi - lo, 0)
    total = int(counts.sum())
    if total == 0:
        e = np.zeros(0, dtype=np.int64)
        return e, e, counts
    probe_idx = np.repeat(np.arange(len(probe_codes)), counts)
    starts = np.repeat(lo, counts)
    cum = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total) - np.repeat(cum, counts)
    build_idx = order[starts + within]
    return probe_idx, build_idx, counts


class HashJoinExec(Executor):
    def __init__(self, ctx, build: Executor, probe: Executor, kind: str,
                 build_keys: List[Expression], probe_keys: List[Expression],
                 other_conds: List[Expression], probe_is_left: bool,
                 plan_id: int = -1, rf_reader: Optional[Executor] = None,
                 rf_key_idx: int = 0, rf_filter_id: int = 0,
                 allow_spill: bool = True):
        if kind in ("semi", "anti_semi"):
            ftypes = list(probe.ftypes)
        elif kind == "left_outer_semi":
            ftypes = list(probe.ftypes) + [ty_bool(False)]
        elif probe_is_left:
            ftypes = list(probe.ftypes) + [
                ft.with_nullable(True) if kind == "left_outer" else ft
                for ft in build.ftypes
            ]
        else:
            ftypes = [
                ft.with_nullable(True) if kind == "left_outer" else ft
                for ft in build.ftypes
            ] + list(probe.ftypes)
        super().__init__(ctx, ftypes, [build, probe], plan_id)
        self.kind = kind
        self.build_keys = build_keys
        self.probe_keys = probe_keys
        self.other_conds = other_conds
        self.probe_is_left = probe_is_left
        self._built = False
        self._build_chunk: Optional[Chunk] = None
        self._sorted_codes = None
        self._order = None
        self._str_dict: dict = {}
        # runtime semi-join filter: after the build phase, ship the distinct
        # build keys of eq-pair rf_key_idx to this reader's device DAG
        # (JoinProbeIR) so the probe scan drops non-matching rows on device
        self._rf_reader = rf_reader
        self._rf_key_idx = rf_key_idx
        self._rf_filter_id = rf_filter_id
        self._probe_opened = False
        self._probe_pipe = None
        self._grace = False
        self._grace_iter = None
        self._build_buf: List[Chunk] = []
        self._build_lists = None
        self._rf_keys_acc = None
        self._build_consumed = 0
        # grace sub-joins must not re-spill: the same hash + same modulo
        # re-lands a skewed partition in one bucket forever (recursion
        # bomb); a sub-partition that still exceeds the quota cancels
        self._allow_spill = allow_spill

    def open(self):
        # the probe child opens lazily in _next(): its scan fan-out must not
        # start until the build side is drained and runtime-filter keys are
        # attached (index_lookup_join.go builds inner requests the same way)
        self.child(0).open()
        self._open()
        self._opened = True

    def _close(self):
        if self._probe_pipe is not None:
            self._probe_pipe.close()
            self._probe_pipe = None
        if self._grace_iter is not None:
            self._grace_iter.close()  # runs the generator's finally
            self._grace_iter = None
        if self._build_lists is not None:
            for lst in self._build_lists:
                lst.close()
            self._build_lists = None
        if self._build_consumed:
            # hand tracked build memory back so sibling operators (and
            # grace sub-joins) see real headroom
            self.ctx.mem_tracker.release(self._build_consumed)
            self._build_consumed = 0
        self._build_chunk = None

    def _ensure_probe_open(self):
        if self._probe_opened:
            return
        if self._rf_reader is not None:
            if self._grace:
                keys = (self._rf_keys_acc if self._rf_keys_acc is not None
                        else np.zeros(0, dtype=np.int64))
            else:
                mat, null = self._build_mat, self._build_any_null
                keys = np.unique(mat[~null, self._rf_key_idx]) \
                    if mat.shape[0] else np.zeros(0, dtype=np.int64)
            self._rf_reader.set_runtime_aux({
                f"probe_keys_{self._rf_filter_id}":
                    np.ascontiguousarray(keys, dtype=np.int64)
            })
        self.child(1).open()
        self._probe_opened = True

    # ---- build phase ---------------------------------------------------
    N_SPILL_PARTS = 8

    def _spill_build(self) -> int:
        """Memory-tracker hook: push buffered build chunks to disk,
        hash-partitioned by join key -> grace hash join
        (hash_table.go:148-179)."""
        if not self._allow_spill or not self._build_buf:
            return 0
        if self._build_lists is None:
            from ..chunk.disk import ListInDisk

            self._build_lists = [ListInDisk("gracejoin-build")
                                 for _ in range(self.N_SPILL_PARTS)]
        freed = 0
        for c in self._build_buf:
            freed += c.nbytes()
            self._partition_to(self._build_lists, c, self.build_keys,
                               collect_rf=self._rf_reader is not None)
        self._build_buf.clear()
        self.ctx.mem_tracker.release(freed)
        self._build_consumed = max(self._build_consumed - freed, 0)
        REGISTRY.inc("hashjoin_spills_total")
        return freed

    def _partition_to(self, lists, chunk: Chunk, keys, collect_rf=False):
        mat, null = _key_matrix(chunk, keys, self._str_dict)
        if chunk.num_rows == 0:
            return
        codes = (_hash_combine(mat) if mat.shape[1]
                 else np.zeros(chunk.num_rows, np.int64))
        part = codes.view(np.uint64) % np.uint64(len(lists))
        part[null] = 0  # NULL keys flow through partition 0 (never match)
        if collect_rf:
            ks = np.unique(mat[~null, self._rf_key_idx]) if mat.shape[0]                 else np.zeros(0, np.int64)
            self._rf_keys_acc = (ks if self._rf_keys_acc is None else
                                 np.union1d(self._rf_keys_acc, ks))
        for p in range(len(lists)):
            sel = part == p
            if sel.any():
                lists[p].add(chunk.filter(sel))

    def _build_table(self):
        self._build_buf: List[Chunk] = []
        self._build_lists = None
        self._rf_keys_acc = None
        self._grace = False
        if self._allow_spill:
            self.ctx.mem_tracker.register_spill(self._spill_build)
        while True:
            c = self.child(0).next()
            if c is None:
                break
            if c.num_rows == 0:
                continue
            # buffer BEFORE consuming: the spill hook can then shed this
            # very chunk when it alone exceeds the remaining quota (mesh
            # scans deliver the whole table as one chunk)
            self._build_buf.append(c)
            self._build_consumed += c.nbytes()
            self.ctx.mem_tracker.consume(c.nbytes())
        if self._build_lists is not None:
            self._spill_build()  # flush the in-memory remainder
            self._grace = True
            self._built = True
            return
        chunks = self._build_buf
        # ownership moves to _build_chunk: clear the buffer and disarm the
        # hook so a later quota trip elsewhere cannot "free" bytes that are
        # still live (nor leak never-read disk lists)
        self._build_buf = []
        self._allow_spill = False
        bc = concat_chunks(chunks)
        if bc is None:
            bc = self.child(0).empty_chunk()
        self._build_chunk = bc
        mat, null = _key_matrix(bc, self.build_keys, self._str_dict)
        codes = _hash_combine(mat) if bc.num_rows else np.zeros(0, np.int64)
        # null keys never match: drop them from the match structure entirely
        # (a sentinel code could collide with a legitimate probe value in the
        # single-column path, which skips exact verification)
        self._mat_multi = mat.shape[1] > 1
        self._build_mat = mat
        nonnull = np.flatnonzero(~null)
        local = np.argsort(codes[nonnull], kind="stable")
        self._order = nonnull[local]
        self._sorted_codes = codes[self._order]
        self._build_any_null = null
        self._built = True

    def _probe_codes(self, chunk: Chunk):
        """(codes, null, key_matrix) — mat returned (not stored) so probe
        workers can run concurrently (join.go:307-414 probe worker pool)."""
        mat, null = _key_matrix(chunk, self.probe_keys, self._str_dict)
        if mat.shape[1] == 0:
            return np.zeros(chunk.num_rows, dtype=np.int64), null, mat
        return _hash_combine(mat), null, mat

    # ---- probe phase ---------------------------------------------------
    def _next(self) -> Optional[Chunk]:
        if not self._built:
            self._build_table()
        self._ensure_probe_open()
        if self._grace:
            if self._grace_iter is None:
                self._grace_iter = self._run_grace()
            return count_host_join_rows(next(self._grace_iter, None))
        if self._probe_pipe is None:
            from .base import OrderedPipeline

            self._probe_pipe = OrderedPipeline(
                self.ctx.hash_join_concurrency, self.child(1).next,
                self._join_chunk,
            )
        return count_host_join_rows(self._probe_pipe.next())

    def _run_grace(self):
        """Grace hash join: the probe side partitions to disk by the same
        key hash, then each partition pair joins with a fresh in-memory
        join — peak memory ~ 1/N_SPILL_PARTS of the inputs per side."""
        from ..chunk.disk import ListInDisk

        P = len(self._build_lists)
        probe_lists = [ListInDisk("gracejoin-probe") for _ in range(P)]
        while True:
            pc = self.child(1).next()
            if pc is None:
                break
            if pc.num_rows:
                self._partition_to(probe_lists, pc, self.probe_keys)
        try:
            for p in range(P):
                pchunks = list(probe_lists[p])
                if not pchunks:
                    continue  # every join kind emits rows driven by probe
                bchunks = list(self._build_lists[p])
                sub = HashJoinExec(
                    self.ctx,
                    _ChunksExec(self.ctx, bchunks, self.child(0).ftypes),
                    _ChunksExec(self.ctx, pchunks, self.child(1).ftypes),
                    self.kind, self.build_keys, self.probe_keys,
                    self.other_conds, self.probe_is_left,
                    allow_spill=False,
                )
                sub.open()
                try:
                    while True:
                        c = sub.next()
                        if c is None:
                            break
                        yield c
                finally:
                    sub.close()
        finally:
            for lst in probe_lists + self._build_lists:
                lst.close()
            self._build_lists = None

    def _join_chunk(self, pc: Chunk) -> Optional[Chunk]:
        bc = self._build_chunk
        codes, null, probe_mat = self._probe_codes(pc)
        ok = ~null
        probe_idx, build_idx, _ = _expand_matches(
            self._sorted_codes, self._order, codes, ok
        )
        if self._mat_multi and len(probe_idx):
            # hash collisions: verify exact key equality per pair
            exact = np.ones(len(probe_idx), dtype=np.bool_)
            for j in range(self._build_mat.shape[1]):
                exact &= (self._build_mat[build_idx, j]
                          == probe_mat[probe_idx, j])
            probe_idx = probe_idx[exact]
            build_idx = build_idx[exact]
        matched = np.zeros(pc.num_rows, dtype=np.bool_)
        if len(probe_idx):
            pairs = self._pair_chunk(pc, probe_idx, bc, build_idx)
            if self.other_conds:
                keep = eval_bool_mask(self.other_conds, pairs)
                probe_idx = probe_idx[keep]
                build_idx = build_idx[keep]
                pairs = pairs.filter(keep)
            matched[probe_idx] = True
        else:
            pairs = None

        k = self.kind
        if k == "inner":
            return pairs
        if k == "semi":
            return pc.filter(matched)
        if k == "anti_semi":
            return pc.filter(~matched)
        if k == "left_outer_semi":
            flag = Column(ty_bool(False), matched.astype(np.int64))
            return Chunk(pc.columns + [flag])
        if k == "left_outer":
            unmatched = pc.filter(~matched)
            pad = Chunk([
                Column.nulls(ft, unmatched.num_rows)
                for ft in self.child(0).ftypes
            ])
            if self.probe_is_left:
                outer_rows = Chunk(unmatched.columns + pad.columns)
            else:
                outer_rows = Chunk(pad.columns + unmatched.columns)
            if pairs is None or pairs.num_rows == 0:
                return outer_rows
            return pairs.append(outer_rows) if outer_rows.num_rows else pairs
        raise ExecutorError(f"unknown join kind {self.kind!r}")

    def _pair_chunk(self, pc: Chunk, probe_idx, bc: Chunk, build_idx) -> Chunk:
        pcols = [c.take(probe_idx) for c in pc.columns]
        bcols = [c.take(build_idx) for c in bc.columns]
        if self.kind == "left_outer":
            bcols = [Column(c.ftype.with_nullable(True), c.data, c.valid)
                     for c in bcols]
        if self.probe_is_left:
            return Chunk(pcols + bcols)
        return Chunk(bcols + pcols)


class _ChunksExec(Executor):
    """Materialized chunk list as an executor (grace-join partitions)."""

    def __init__(self, ctx, chunks, ftypes):
        super().__init__(ctx, ftypes, [])
        self._chunks = chunks
        self._i = 0

    def _open(self):
        self._i = 0

    def _next(self):
        if self._i >= len(self._chunks):
            return None
        c = self._chunks[self._i]
        self._i += 1
        return c


class MergeJoinExec(Executor):
    """True sort-merge join: children arrive ordered on the join keys
    (Sort / keep-order readers); matching is a vectorized range merge.

    Reference: executor/merge_join.go.  Per left row, the matching right
    range comes from two searchsorted calls on the first key (O(n log m),
    no hash table); extra keys verify per candidate pair.  Output preserves
    the left side's order — the property hash join cannot give keep-order
    pipelines.
    """

    def __init__(self, ctx, left: Executor, right: Executor, kind: str,
                 left_keys, right_keys, other_conds, plan_id: int = -1):
        if kind in ("semi", "anti_semi"):
            ftypes = list(left.ftypes)
        elif kind == "left_outer":
            ftypes = list(left.ftypes) + [
                ft.with_nullable(True) for ft in right.ftypes
            ]
        else:
            ftypes = list(left.ftypes) + list(right.ftypes)
        super().__init__(ctx, ftypes, [left, right], plan_id)
        self.kind = kind
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.other_conds = other_conds
        self._out: Optional[List[Chunk]] = None
        self._pos = 0
        self._consumed = 0

    def _open(self):
        self._out = None
        self._pos = 0

    def _close(self):
        if self._consumed:
            self.ctx.mem_tracker.release(self._consumed)
            self._consumed = 0

    def _merge(self) -> List[Chunk]:
        lc = concat_chunks(self.drain_child(0))
        rc = concat_chunks(self.drain_child(1))
        if lc is None:
            lc = self.child(0).empty_chunk()
        if rc is None:
            rc = self.child(1).empty_chunk()
        self._consumed = lc.nbytes() + rc.nbytes()
        self.ctx.mem_tracker.consume(self._consumed)
        str_dict: dict = {}
        lmat, lnull = _key_matrix(lc, self.left_keys, str_dict)
        rmat, rnull = _key_matrix(rc, self.right_keys, str_dict)
        # key encodings must be ORDER-preserving for searchsorted, not just
        # equality-preserving: string codes are first-seen-ordered (re-rank
        # by value) and float bit patterns invert for negatives (monotone
        # IEEE transform: flip all bits when the sign bit is set)
        rank = None
        for j, k in enumerate(self.left_keys):
            if k.ftype.kind == TypeKind.STRING:
                if rank is None:
                    rank = np.zeros(max(len(str_dict), 1), dtype=np.int64)
                    for i, (_, c) in enumerate(sorted(str_dict.items())):
                        rank[c] = i
                lmat[:, j] = rank[lmat[:, j]]
                rmat[:, j] = rank[rmat[:, j]]
            elif k.ftype.kind == TypeKind.FLOAT:
                lmat[:, j] = _monotone_float_bits(lmat[:, j])
                rmat[:, j] = _monotone_float_bits(rmat[:, j])
        lkey = lmat[:, 0] if lmat.shape[1] else np.zeros(lc.num_rows, np.int64)
        rkey = rmat[:, 0] if rmat.shape[1] else np.zeros(rc.num_rows, np.int64)
        rok = np.flatnonzero(~rnull)
        rkey_ok = rkey[rok]
        starts = np.searchsorted(rkey_ok, lkey, "left")
        ends = np.searchsorted(rkey_ok, lkey, "right")
        counts = np.where(lnull, 0, ends - starts)
        total = int(counts.sum())
        left_idx = np.repeat(np.arange(lc.num_rows), counts)
        if total:
            offs = np.zeros(lc.num_rows + 1, dtype=np.int64)
            np.cumsum(counts, out=offs[1:])
            right_pos = (np.arange(total)
                         - np.repeat(offs[:-1], counts)
                         + np.repeat(starts, counts))
            right_idx = rok[right_pos]
            # verify remaining keys (first-key ranges are supersets)
            if lmat.shape[1] > 1:
                keep = np.ones(total, dtype=np.bool_)
                for j in range(1, lmat.shape[1]):
                    keep &= lmat[left_idx, j] == rmat[right_idx, j]
                left_idx, right_idx = left_idx[keep], right_idx[keep]
        else:
            right_idx = np.zeros(0, dtype=np.int64)

        pairs = None
        if len(left_idx):
            pcols = [c.take(left_idx) for c in lc.columns]
            bcols = [c.take(right_idx) for c in rc.columns]
            if self.kind == "left_outer":
                bcols = [Column(c.ftype.with_nullable(True), c.data, c.valid)
                         for c in bcols]
            pairs = Chunk(pcols + bcols)
            if self.other_conds:
                keep = eval_bool_mask(self.other_conds, pairs)
                left_idx = left_idx[keep]
                right_idx = right_idx[keep]
                pairs = pairs.filter(keep)
        matched = np.zeros(lc.num_rows, dtype=np.bool_)
        if len(left_idx):
            matched[left_idx] = True

        k = self.kind
        if k == "inner":
            out = pairs if pairs is not None else self.empty_chunk()
        elif k == "semi":
            out = lc.filter(matched)
        elif k == "anti_semi":
            out = lc.filter(~matched)
        elif k == "left_outer":
            unmatched = lc.filter(~matched)
            pad = Chunk([Column.nulls(ft.with_nullable(True), unmatched.num_rows)
                         for ft in self.child(1).ftypes])
            outer_rows = Chunk(unmatched.columns + pad.columns)
            if pairs is None or pairs.num_rows == 0:
                out = outer_rows
            elif outer_rows.num_rows:
                # interleave so the output keeps the LEFT side's order —
                # the whole point of a merge join for keep-order pipelines
                combined = pairs.append(outer_rows)
                src_left = np.concatenate([
                    left_idx, np.flatnonzero(~matched)])
                order = np.argsort(src_left, kind="stable")
                out = Chunk([c.take(order) for c in combined.columns])
            else:
                out = pairs
        else:
            raise ExecutorError(f"merge join kind {self.kind!r}")
        return [c for c in out.split(self.ctx.chunk_size) if c.num_rows]

    def _next(self):
        if self._out is None:
            self._out = self._merge()
        if self._pos >= len(self._out):
            return None
        c = self._out[self._pos]
        self._pos += 1
        return count_host_join_rows(c)


class NestedLoopApplyExec(Executor):
    """Correlated-subquery driver (executor Apply): for each outer row, bind
    correlated params and re-run the inner plan.

    Reference: executor/apply (IndexLookUpApply etc. collapse to this)."""

    def __init__(self, ctx, outer: Executor, inner_builder, kind: str,
                 output_ftypes, plan_id: int = -1):
        super().__init__(ctx, output_ftypes, [outer], plan_id)
        self.inner_builder = inner_builder  # fn(outer_row) -> Executor
        self.kind = kind
        self._buf: List[Chunk] = []
        self._pos = 0
        self._done = False

    def _open(self):
        self._buf, self._pos, self._done = [], 0, False

    def _next(self) -> Optional[Chunk]:
        from .base import collect_all

        while self._pos >= len(self._buf):
            if self._done:
                return None
            oc = self.child().next()
            if oc is None:
                self._done = True
                return None
            self._buf = []
            self._pos = 0
            for i in range(oc.num_rows):
                row = oc.row(i)
                inner_exe = self.inner_builder(row)
                inner_chunks = collect_all(inner_exe)
                ic = concat_chunks(inner_chunks)
                out = self._combine(oc.slice(i, i + 1), ic)
                if out is not None and out.num_rows:
                    self._buf.append(out)
        c = self._buf[self._pos]
        self._pos += 1
        return c

    def _combine(self, outer_row: Chunk, inner: Optional[Chunk]) -> Optional[Chunk]:
        k = self.kind
        n_inner = inner.num_rows if inner is not None else 0
        if k == "semi":
            return outer_row if n_inner else None
        if k == "anti_semi":
            return None if n_inner else outer_row
        if k == "inner":
            if not n_inner:
                return None
            rep = Chunk([c.take(np.zeros(n_inner, dtype=np.int64))
                         for c in outer_row.columns])
            return Chunk(rep.columns + inner.columns)
        if k == "left_outer":
            if not n_inner:
                pad = Chunk([
                    Column.nulls(ft, 1)
                    for ft in self.ftypes[outer_row.num_cols:]
                ])
                return Chunk(outer_row.columns + pad.columns)
            rep = Chunk([c.take(np.zeros(n_inner, dtype=np.int64))
                         for c in outer_row.columns])
            inner_cols = [Column(c.ftype.with_nullable(True), c.data, c.valid)
                          for c in inner.columns]
            return Chunk(rep.columns + inner_cols)
        raise ExecutorError(f"apply: unknown kind {k!r}")


def _monotone_float_bits(bits: np.ndarray) -> np.ndarray:
    """IEEE-754 bit pattern -> int64 that sorts in float value order:
    negative floats have the sign bit set and compare inverted as ints, so
    flip ALL bits when negative and only the sign bit when positive."""
    u = bits.view(np.uint64)
    # unsigned-order transform (neg: flip all, pos: flip sign) composed
    # with the unsigned->signed shift (flip top bit) = neg: flip low 63
    mask = np.where(bits < 0, np.uint64(0x7FFFFFFFFFFFFFFF), np.uint64(0))
    return (u ^ mask).view(np.int64)

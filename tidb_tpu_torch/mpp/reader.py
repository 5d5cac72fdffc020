"""MPPReaderExec: the root executor driving the MPP exchange engine.

The role of executor/table_reader.go for MPP fragments: own the two cop
DAGs (probe + build), hand them to the device engine, and stream joined
chunks (or one scalar-partial chunk) to the parent.  When the engine
declines for a STRUCTURAL cause (MPPIneligible: a shape or data layout
the card cannot serve, or partition overflow past the broadcast rung),
the SAME plan runs as a root HashJoinExec over two TableReaderExecs
(EXPLAIN ANALYZE shows which rung served it).  A device runtime
failure is no such cause: it reaches the statement.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..chunk import Chunk
from ..executor.base import ExecContext, Executor
from ..expr.expression import ColumnExpr
from ..metrics import REGISTRY
from .engine import MPPIneligible, MPPJoinSpec, run_mpp_join


class MPPReaderExec(Executor):
    def __init__(self, ctx: ExecContext, spec: MPPJoinSpec, ftypes,
                 plan_id: int = -1):
        super().__init__(ctx, ftypes, [], plan_id)
        self.spec = spec
        self._chunks: Optional[List[Chunk]] = None
        self._pos = 0
        self._fallback: Optional[Executor] = None

    def _open(self):
        self._chunks = None
        self._pos = 0
        self._fallback = None

    def _attribute(self, engine: str):
        if self.plan_id >= 0:
            self.ctx.op_stats(self.plan_id).engine = engine

    def _run(self):
        spec = self.spec
        spec.ts = self.ctx.snapshot_ts()
        if self.ctx.engine != "tpu":
            self._start_fallback("engine=cpu")
            return
        if spec.copartitions is not None:
            self._run_copartitioned()
            return
        try:
            self._chunks, mode = run_mpp_join(self.ctx.storage, spec)
            self._attribute(f"mpp-{mode}")
        except MPPIneligible as e:
            self._start_fallback(str(e))

    def _run_copartitioned(self):
        """Exchange elision: both sides hash-partitioned on the join
        key, so partition i joins ONLY partition i — one engine run per
        partition pair, no cross-partition exchange at all (TiFlash's
        same-zone optimization).  A pair the engine declines host-joins
        alone; pruned/empty pairs contribute nothing (inner join)."""
        import dataclasses

        from ..trace import span

        spec = self.spec
        REGISTRY.inc("mpp_exchange_elided_total")
        probe_rngs: dict = {}
        for kr in spec.probe.ranges:
            probe_rngs.setdefault(kr.table_id, []).append(kr)
        build_rngs: dict = {}
        for kr in spec.build.ranges:
            build_rngs.setdefault(kr.table_id, []).append(kr)
        chunks, modes = [], []
        for ppid, bpid in spec.copartitions:
            self.ctx.check_killed()  # seam between partition-pair runs
            pr = probe_rngs.get(ppid)
            br = build_rngs.get(bpid)
            if not pr or not br:
                continue  # partition pruned on one side: no matches
            pair = dataclasses.replace(
                spec, copartitions=None,
                probe=dataclasses.replace(spec.probe, table_id=ppid,
                                          ranges=pr),
                build=dataclasses.replace(spec.build, table_id=bpid,
                                          ranges=br))
            try:
                stores = [self.ctx.storage.table(pid)
                          for pid in (ppid, bpid)]
                if any(t.base_rows == 0 and not t.delta for t in stores):
                    continue  # empty partition pair
                with span("mpp.copart", probe=ppid, build=bpid):
                    out, mode = run_mpp_join(self.ctx.storage, pair)
                chunks.extend(out)
                modes.append(mode)
            except MPPIneligible as e:
                chunks.extend(self._host_join_pair(pair, str(e)))
                modes.append("host")
        self._chunks = chunks
        rungs = ",".join(sorted(set(modes))) if modes else "empty"
        self._attribute(f"mpp-elided[{rungs}]")

    # ---- host rung -----------------------------------------------------
    def _side_reader(self, side, probe_ir=None) -> Executor:
        from ..copr.ir import DAG
        from ..executor.readers import TableReaderExec

        dag = DAG.from_dict(side.dag)
        if probe_ir is not None:
            dag.executors.append(probe_ir)
        return TableReaderExec(self.ctx, dag, list(side.ranges),
                               dag.output_ftypes(), plan_id=-1)

    def _build_host_join(self, spec):
        """Root hash join over a spec's two cop DAGs (always correct:
        handles deltas, duplicates, overflow shapes).  Inner joins keep
        the MPP plan's selectivity win: the FIRST key's build-side
        distinct values ship to the probe scan as a runtime semi-join
        filter (JoinProbeIR — a superset filter under multi-column keys,
        the join re-checks full equality), so non-matching probe rows
        die in the coprocessor instead of streaming to the host join."""
        from ..copr.ir import JoinProbeIR
        from ..executor.join import HashJoinExec

        pks = [ColumnExpr(kp, spec.probe.out_ftypes[kp], "pk", -1)
               for kp in spec.probe.key_pos]
        bks = [ColumnExpr(kb, spec.build.out_ftypes[kb], "bk", -1)
               for kb in spec.build.key_pos]
        probe_ir = JoinProbeIR(pks[0], filter_id=0) \
            if spec.kind == "inner" else None
        probe = self._side_reader(spec.probe, probe_ir)
        build = self._side_reader(spec.build)
        return HashJoinExec(
            self.ctx, build, probe, spec.kind, bks, pks, [],
            probe_is_left=spec.probe_is_left, plan_id=-1,
            rf_reader=probe if probe_ir is not None else None,
            rf_key_idx=0, rf_filter_id=0)

    def _host_join_pair(self, pair, reason: str) -> List[Chunk]:
        """Host-join ONE co-partitioned pair to completion (collected:
        pairs are 1/N of the table by construction)."""
        REGISTRY.inc("mpp_fallback_total")
        from ..trace import span

        with span("mpp.host_join", reason=reason[:80]):
            join = self._build_host_join(pair)
            grouped = pair.aggs is not None and pair.group_by is not None
            folds = ([_AggFold(a) for a in pair.aggs]
                     if pair.aggs is not None and not grouped else None)
            out: List[Chunk] = []
            join.open()
            try:
                while True:
                    c = join.next()
                    if c is None:
                        break
                    if not c.num_rows:
                        continue
                    if grouped:
                        out.extend(_grouped_fold(pair, c))
                    elif folds is None:
                        out.append(c)
                    else:
                        for f in folds:
                            f.consume(c)
            finally:
                join.close()
            if folds is not None:
                out = [Chunk([col for f in folds for col in f.partials()])]
            return out

    def _start_fallback(self, reason: str):
        REGISTRY.inc("mpp_fallback_total")
        self._attribute(f"host-join [mpp rejected: {reason}]")
        spec = self.spec
        join = self._build_host_join(spec)
        if spec.aggs is None:
            self._fallback = join
            self._fallback.open()
            return
        # partial-agg pushdown plan: the parent is a FINAL HashAgg, so
        # the host rung must emit the same [keys..., states...] partial
        # layout.  Fold per chunk — an MPP-eligible join is big by
        # construction, so the joined rows must never materialize whole;
        # grouped plans emit per-chunk grouped partials (the final
        # HashAgg merges groups across chunks)
        grouped = spec.group_by is not None
        folds = [_AggFold(a) for a in spec.aggs] if not grouped else None
        chunks: List[Chunk] = []
        join.open()
        try:
            while True:
                c = join.next()
                if c is None:
                    break
                if not c.num_rows:
                    continue
                if grouped:
                    chunks.extend(_grouped_fold(spec, c))
                else:
                    for f in folds:
                        f.consume(c)
        finally:
            join.close()
        if grouped:
            self._chunks = chunks
        else:
            self._chunks = [
                Chunk([col for f in folds for col in f.partials()])]

    def _next(self) -> Optional[Chunk]:
        if self._fallback is not None:
            return self._fallback.next()
        if self._chunks is None:
            self._run()
            if self._fallback is not None:
                return self._fallback.next()
        if self._pos >= len(self._chunks):
            return None
        c = self._chunks[self._pos]
        self._pos += 1
        return c

    def _close(self):
        if self._fallback is not None:
            self._fallback.close()
            self._fallback = None


class MPPTreeReaderExec(Executor):
    """Root executor for the multi-way join-tree ladder: own
    every side's cop DAG, hand the rung ladder to the device engine
    (mpp/jointree.py), and stream joined rows or partial-agg chunks.
    When the engine declines for a structural cause, the SAME ladder
    runs as CHAINED host hash joins in the compiler's join order."""

    def __init__(self, ctx: ExecContext, spec, ftypes, plan_id: int = -1):
        super().__init__(ctx, ftypes, [], plan_id)
        self.spec = spec
        self._chunks: Optional[List[Chunk]] = None
        self._pos = 0

    def _open(self):
        self._chunks = None
        self._pos = 0

    def _attribute(self, engine: str):
        if self.plan_id >= 0:
            self.ctx.op_stats(self.plan_id).engine = engine

    def _slot_ftypes(self):
        spec = self.spec
        fts = []
        for side, sp in spec.slot_src:
            ft = spec.sides[side].out_ftypes[sp]
            fts.append(ft)
        return fts

    def _run(self):
        from .jointree import run_mpp_jointree

        spec = self.spec
        spec.ts = self.ctx.snapshot_ts()
        if self.ctx.engine != "tpu":
            self._run_host("engine=cpu")
            return
        from .engine import MPPIneligible

        try:
            self._chunks, mode = run_mpp_jointree(self.ctx.storage, spec)
            self._attribute(f"mpp-{mode}")
        except MPPIneligible as e:
            self._run_host(str(e))

    # ---- host rung: chained hash joins in the same join order --------
    def _side_reader(self, side) -> Executor:
        from ..copr.ir import DAG
        from ..executor.readers import TableReaderExec

        dag = DAG.from_dict(side.dag)
        return TableReaderExec(self.ctx, dag, list(side.ranges),
                               dag.output_ftypes(), plan_id=-1)

    def _build_host_chain(self) -> Executor:
        from ..executor.join import HashJoinExec

        spec = self.spec
        slot_fts = self._slot_ftypes()
        cur = self._side_reader(spec.sides[0])
        for rung in spec.rungs:
            side = spec.sides[rung.side]
            pkeys = [ColumnExpr(s, slot_fts[s], "pk", -1)
                     for s in rung.left_slots]
            bkeys = [ColumnExpr(kp, side.out_ftypes[kp], "bk", -1)
                     for kp in rung.build_key_pos]
            build = self._side_reader(side)
            cur = HashJoinExec(
                self.ctx, build, cur, rung.kind, bkeys, pkeys,
                list(rung.other_conds), probe_is_left=True, plan_id=-1)
        return cur

    def _run_host(self, reason: str):
        REGISTRY.inc("mpp_fallback_total")
        REGISTRY.inc("mpp_tree_fallback_total")
        self._attribute(f"host-tree [mpp rejected: {reason}]")
        from ..trace import span

        spec = self.spec
        grouped = spec.aggs is not None and spec.group_by is not None
        folds = ([_AggFold(a) for a in spec.aggs]
                 if spec.aggs is not None and not grouped else None)
        chunks: List[Chunk] = []
        join = self._build_host_chain()
        with span("mpp.host_join", reason=reason[:80]):
            join.open()
            try:
                while True:
                    c = join.next()
                    if c is None:
                        break
                    if not c.num_rows:
                        continue
                    if grouped:
                        chunks.extend(_grouped_fold(spec, c))
                    elif folds is not None:
                        for f in folds:
                            f.consume(c)
                    else:
                        chunks.append(self._project_rows(c))
            finally:
                join.close()
        if folds is not None:
            chunks = [Chunk([col for f in folds for col in f.partials()])]
        self._chunks = chunks

    def _project_rows(self, c: Chunk) -> Chunk:
        spec = self.spec
        if spec.out_slots == list(range(len(spec.slot_src))):
            return c
        return Chunk([c.columns[s] for s in spec.out_slots])

    def _next(self) -> Optional[Chunk]:
        if self._chunks is None:
            self._run()
        if self._pos >= len(self._chunks):
            return None
        c = self._chunks[self._pos]
        self._pos += 1
        return c


def _grouped_fold(spec, chunk: Chunk) -> List[Chunk]:
    """Host-rung grouped partials for one joined chunk (the shared
    copr recipe; the parent FINAL HashAgg merges across chunks)."""
    from ..copr.cpu_engine import grouped_partial_chunks

    return grouped_partial_chunks(spec.group_by, spec.aggs, [chunk])


class _AggFold:
    """Streaming scalar-partial accumulator for one AggDesc over joined
    chunks, emitting the device engine's partial layout
    (engine._assemble_partials) without materializing the join."""

    def __init__(self, a):
        self.a = a
        self.rows = 0      # count(*) input rows
        self.count = 0     # non-NULL arg rows
        self.sum = 0       # int or float, in the arg's physical domain
        self.minmax = None

    def consume(self, chunk: Chunk):
        a = self.a
        self.rows += chunk.num_rows
        if not a.args:
            return
        v = a.args[0].eval(chunk)
        data = v.data[v.validity()]
        c = len(data)
        self.count += c
        if not c:
            return
        if a.name in ("sum", "avg"):
            from ..types import TypeKind

            if a.partial_types()[0].kind == TypeKind.FLOAT:
                self.sum += float(data.astype(np.float64).sum())
            else:
                self.sum += int(data.astype(np.int64).sum())
        elif a.name in ("min", "max"):
            ext = data.min() if a.name == "min" else data.max()
            if self.minmax is None:
                self.minmax = ext
            else:
                self.minmax = (min(self.minmax, ext) if a.name == "min"
                               else max(self.minmax, ext))

    def partials(self) -> List:
        from ..chunk import Column
        from ..types import TypeKind

        a = self.a
        pts = a.partial_types()
        if a.name == "count":
            n = self.count if a.args else self.rows
            return [Column(pts[0], np.array([n], np.int64))]
        if a.name in ("sum", "avg"):
            st, arg_ft = pts[0], a.args[0].ftype
            sm = self.sum
            if self.count:
                if st.kind == TypeKind.FLOAT:
                    if arg_ft.kind == TypeKind.DECIMAL:
                        sm /= 10.0 ** arg_ft.scale
                else:
                    sm *= 10 ** (st.scale - arg_ft.scale)
            cols = [Column(pts[0], np.array([sm]).astype(st.np_dtype),
                           np.array([self.count > 0]))]
            if a.name == "avg":
                cols.append(Column(pts[1], np.array([self.count], np.int64)))
            return cols
        val = self.minmax if self.minmax is not None else 0
        return [Column(pts[0], np.array([val]).astype(pts[0].np_dtype),
                       np.array([self.count > 0]))]

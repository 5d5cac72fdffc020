"""Physical plans: cop/root task split + executor construction + EXPLAIN.

Reference: planner/core/physical_plans.go + task.go (copTask vs rootTask, the
cost boundary where operators either sink into the coprocessor DAG or stay in
root executors) + plan_to_pb.go (DAG serialization) + executor/builder.go (the
physical-plan -> executor type switch).

The pushdown decision (the TPU routing) happens in `attach_*` below: a
DataSource starts a cop task (TableScanIR [+ SelectionIR]); Aggregation/TopN/
Limit directly above a cop task sink into the DAG when their expressions pass
`can_push_*` (expr/pushdown.py) and the table has no dirty txn writes;
everything else finalizes the cop task into a PhysTableReader and continues
root-side.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Tuple

from ..catalog import TableInfo
from ..copr.ir import (
    DAG,
    AggregationIR,
    LimitIR,
    ProjectionIR,
    SelectionIR,
    TableScanIR,
    TopNIR,
)
from ..errors import KVError, PlanError
from ..expr.aggregation import AggDesc
from ..expr.expression import ColumnExpr, Constant, Expression, ScalarFunc
from ..expr.pushdown import (can_push_agg, can_push_expr,
                             can_remap_group_key)
from ..store.kv import KeyRange
from ..store.regions import INF
from ..types import FieldType, TypeKind, common_compare_type
from .build import DeletePlan, InsertPlan, LoadDataPlan, UpdatePlan
from .columns import Schema, SchemaCol
from .logical import (
    LogicalAggregation,
    LogicalDataSource,
    LogicalDual,
    LogicalJoin,
    LogicalLimit,
    LogicalMaxOneRow,
    LogicalPlan,
    LogicalProjection,
    LogicalSelection,
    LogicalSort,
    LogicalTopN,
    LogicalUnion,
)

_plan_id_counter = [0]


def _next_plan_id() -> int:
    _plan_id_counter[0] += 1
    return _plan_id_counter[0]


class PhysicalPlan:
    """Base physical node: knows its output schema (for positional remap),
    builds its executor, explains itself."""

    def __init__(self, schema: Schema, children: List["PhysicalPlan"]):
        self.schema = schema
        self.children = children
        self.id = _next_plan_id()
        self.est_rows: Optional[float] = None

    @property
    def name(self) -> str:
        return type(self).__name__.replace("Phys", "")

    def task(self) -> str:
        return "root"

    def info(self) -> str:
        return ""

    def build(self, ctx):
        raise NotImplementedError

    def _est_str(self) -> str:
        return f"{self.est_rows:.2f}" if self.est_rows is not None else ""

    def explain_tree(self, indent: int = 0, lines=None) -> List[str]:
        lines = lines if lines is not None else []
        pad = ("  " * indent + "└─") if indent else ""
        lines.append((f"{pad}{self.name}_{self.id}", self._est_str(),
                      self.task(), self.info()))
        for c in self.children:
            c.explain_tree(indent + 1, lines)
        return lines


# ---------------------------------------------------------------------------
# cop task: a DAG under construction (task.go copTask analog)
# ---------------------------------------------------------------------------


@dataclass
class CopTask:
    table: TableInfo
    scan_cols: List[SchemaCol]  # schema cols with store offsets
    dag_execs: List = dc_field(default_factory=list)  # IR nodes after scan
    out_schema: Schema = None  # current output schema of the DAG
    partial_agg: Optional[Tuple[List[Expression], List[AggDesc]]] = None
    # partitioned tables: pruned per-partition key ranges + names (EXPLAIN)
    ranges: Optional[List[KeyRange]] = None
    partitions: Optional[List[str]] = None

    def scan_pos_map(self) -> dict:
        return {c.uid: i for i, c in enumerate(self.scan_cols)}


class PhysTableReader(PhysicalPlan):
    """Root-side reader driving the cop DAG over all regions."""

    def __init__(self, schema: Schema, task: CopTask, keep_order: bool,
                 ranges: Optional[List[KeyRange]] = None):
        super().__init__(schema, [])
        self.cop = task
        self.keep_order = keep_order
        if ranges is None:
            ranges = task.ranges  # pruned partition ranges ([] = all pruned)
        self.ranges = (ranges if ranges is not None
                       else [KeyRange(task.table.id, 0, INF)])
        scan = TableScanIR(
            task.table.id,
            [c.store_offset for c in task.scan_cols],
            [c.ftype for c in task.scan_cols],
        )
        self.dag = DAG([scan] + task.dag_execs)

    def task(self) -> str:
        return "root"

    def info(self) -> str:
        parts = [f"table:{self.cop.table.name}"]
        if self.cop.partitions is not None:
            parts.append("partition:" + ",".join(self.cop.partitions))
        if self.keep_order:
            parts.append("keep-order")
        return ", ".join(parts)

    def build(self, ctx):
        from ..executor import TableReaderExec

        return TableReaderExec(ctx, self.dag, self.ranges,
                               self.dag.output_ftypes(),
                               self.keep_order, self.id)

    def explain_tree(self, indent: int = 0, lines=None):
        lines = lines if lines is not None else []
        pad = ("  " * indent + "└─") if indent else ""
        lines.append((f"{pad}{self.name}_{self.id}", self._est_str(),
                      self.task(), self.info()))
        for i, ex in enumerate(self.dag.executors):
            pad2 = "  " * (indent + 1 + i) + "└─"
            nm = type(ex).__name__.replace("IR", "")
            info = ""
            if isinstance(ex, TableScanIR):
                info = f"table:{self.cop.table.name}, cols:{ex.columns}"
            elif isinstance(ex, SelectionIR):
                info = ", ".join(str(c) for c in ex.conditions)
            elif isinstance(ex, AggregationIR):
                info = (f"group:[{', '.join(map(str, ex.group_by))}] "
                        f"aggs:[{', '.join(map(str, ex.aggs))}] {ex.mode}")
            elif isinstance(ex, TopNIR):
                info = f"limit:{ex.limit}"
            elif isinstance(ex, LimitIR):
                info = f"limit:{ex.limit}"
            else:
                from ..copr.ir import JoinLookupIR, JoinProbeIR

                if isinstance(ex, JoinProbeIR):
                    info = f"runtime filter: {ex.key} in build keys"
                elif isinstance(ex, JoinLookupIR):
                    info = (f"inner join on {ex.key}, "
                            f"{len(ex.payload_ftypes)} payload cols "
                            "(broadcast build)")
            lines.append((f"{pad2}{nm}", "", "cop[tpu]", info))
        return lines


class PhysDeviceJoinReader(PhysicalPlan):
    """Broadcast lookup join pushed into the cop task: the build subplan
    runs root-side first, its sorted unique keys + payload columns ship to
    every mesh shard, and the probe table's device DAG completes
    scan -> filter -> JOIN -> partial aggregation on chip
    (copr/ir.py JoinLookupIR; the reference's executor/join.go HashJoin
    role, relocated into the coprocessor)."""

    def __init__(self, schema: Schema, reader: PhysTableReader,
                 build: PhysicalPlan, build_key_pos: int,
                 payload_pos: List[int], filter_id: int = 0):
        super().__init__(schema, [build])
        self.reader = reader
        self.build_plan = build
        self.build_key_pos = build_key_pos
        self.payload_pos = payload_pos
        self.filter_id = filter_id

    def task(self) -> str:
        return "root"

    def info(self) -> str:
        return (f"build key @{self.build_key_pos}, "
                f"payload cols {self.payload_pos} -> cop join")

    def build(self, ctx):
        from ..executor.readers import DeviceJoinReaderExec

        return DeviceJoinReaderExec(
            ctx, self.reader.build(ctx), self.build_plan.build(ctx),
            self.build_key_pos, self.payload_pos, self.filter_id, self.id)

    def explain_tree(self, indent: int = 0, lines=None):
        lines = lines if lines is not None else []
        pad = ("  " * indent + "└─") if indent else ""
        lines.append((f"{pad}{self.name}_{self.id}", self._est_str(), "root",
                      self.info()))
        self.reader.explain_tree(indent + 1, lines)
        self.build_plan.explain_tree(indent + 1, lines)
        return lines


class PhysExchangeSender(PhysTableReader):
    """MPP fragment boundary: this scan's shards hash-partition their
    rows by the join key and exchange them across the mesh
    (tipb.ExchangeSender with ExchangeType Hash; TiFlash's
    mpp.ExchangeSenderBlockInputStream role, realized as a
    `jax.lax.all_to_all` inside the shard_map program)."""

    def __init__(self, schema: Schema, task: CopTask, key_pos: List[int],
                 ranges: Optional[List[KeyRange]] = None,
                 elided: bool = False):
        super().__init__(schema, task, keep_order=False, ranges=ranges)
        self.key_pos = list(key_pos)  # scan positions of the join key(s)
        # co-partitioned elision: this fragment IS already partitioned on
        # the join key (hash-partitioned table), so no exchange runs —
        # the node renders as a plain MPP scan
        self.elided = elided

    @property
    def name(self) -> str:
        return "MPPScan" if self.elided else "ExchangeSender"

    def task(self) -> str:
        return "mpp[tpu]"

    def info(self) -> str:
        key = ", ".join(self.cop.scan_cols[k].name for k in self.key_pos)
        if self.elided:
            return (f"co-partitioned on {key} "
                    f"(hash, {len(self.cop.table.partition_info.defs)} "
                    f"partitions), table:{self.cop.table.name}")
        return (f"ExchangeType: HashPartition, key:{key}, "
                f"table:{self.cop.table.name}")


class PhysExchangeReceiver(PhysicalPlan):
    """Receiving end of the exchange: reassembles one hash partition per
    mesh shard (tipb.ExchangeReceiver).  Pure plan-shape marker — the
    sender/receiver pair compiles into the all_to_all collective."""

    def __init__(self, sender: PhysExchangeSender):
        super().__init__(sender.schema, [sender])

    def task(self) -> str:
        return "mpp[tpu]"

    def info(self) -> str:
        return "stream: hash-partitioned"


class PhysMPPJoin(PhysicalPlan):
    """Device-resident partitioned shuffle join over the mesh: children
    = [left receiver, right receiver] in schema order; both sides stay
    on device, partitions exchange via all_to_all, and the
    co-partitioned local join (+ optional scalar partial aggregation)
    completes inside the same compiled program.  Strategy ladder at
    runtime: shuffle -> broadcast -> host hash join (mpp/engine.py)."""

    def __init__(self, left_recv, right_recv, kind: str,
                 probe_is_left: bool, schema: Schema,
                 left_keys: List[Expression], right_keys: List[Expression],
                 aggs=None, group_by=None, group_budget: int = 0,
                 reason: str = "", elided: bool = False):
        super().__init__(schema, [left_recv, right_recv])
        self.kind = kind
        self.probe_is_left = probe_is_left
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.aggs = aggs  # partial-agg pushdown (joined layout)
        # grouped partial-agg pushdown: GROUP BY exprs (joined layout) +
        # the cost-model group budget the device checks at runtime
        self.group_by = group_by
        self.group_budget = group_budget
        self.reason = reason  # cost-choice note surfaced in EXPLAIN
        # co-partitioned elision: children are bare MPPScan fragments
        # (no sender/receiver pair); the join runs per partition pair
        self.elided = elided

    def _sender(self, child) -> "PhysExchangeSender":
        return child if isinstance(child, PhysExchangeSender) \
            else child.children[0]

    @property
    def probe_sender(self) -> "PhysExchangeSender":
        return self._sender(self.children[0 if self.probe_is_left else 1])

    @property
    def build_sender(self) -> "PhysExchangeSender":
        return self._sender(self.children[1 if self.probe_is_left else 0])

    def info(self) -> str:
        keys = ", ".join(
            f"{l}=={r}" for l, r in zip(self.left_keys, self.right_keys))
        s = f"{self.kind} [{keys}] "
        s += "exchange elided (co-partitioned)" if self.elided else "shuffle"
        s += ", build:" + ("right" if self.probe_is_left else "left")
        if self.aggs is not None:
            s += f", partial aggs:[{', '.join(map(str, self.aggs))}]"
        if self.group_by:
            s += (f", group by:[{', '.join(map(str, self.group_by))}]"
                  f" budget:{self.group_budget}")
        if self.reason:
            s += f" ({self.reason})"
        return s

    def build(self, ctx):
        from ..mpp import MPPJoinSide, MPPJoinSpec, MPPReaderExec

        def side(sender: PhysExchangeSender) -> MPPJoinSide:
            return MPPJoinSide(
                table_id=sender.cop.table.id,
                dag=sender.dag.to_dict(),
                ranges=list(sender.ranges),
                key_pos=list(sender.key_pos),
                out_ftypes=sender.dag.output_ftypes(),
            )

        spec = MPPJoinSpec(
            probe=side(self.probe_sender), build=side(self.build_sender),
            kind=self.kind, probe_is_left=self.probe_is_left,
            aggs=self.aggs, group_by=self.group_by,
            group_budget=self.group_budget)
        if self.elided:
            # partition pairs aligned by ordinal: partition i of the
            # probe table joins ONLY partition i of the build table
            ppi = self.probe_sender.cop.table.partition_info
            bpi = self.build_sender.cop.table.partition_info
            spec.copartitions = list(zip(
                (d.id for d in ppi.defs), (d.id for d in bpi.defs)))
        return MPPReaderExec(ctx, spec, self.schema.ftypes(), self.id)


class PhysMPPJoinTree(PhysicalPlan):
    """Multi-way device-resident join ladder: children are
    one ExchangeSender scan fragment per side in JOIN ORDER; each rung
    joins the device-resident intermediate against the next side inside
    one exchange program, and the final phase emits joined rows or the
    on-device partial aggregation.  EXPLAIN shows the chosen join order
    with est_rows per rung; the executor (MPPTreeReaderExec) falls back
    to a chained host hash join when the mesh declines."""

    def __init__(self, senders, rungs, slot_src, out_slots, out_ftypes,
                 schema: Schema, aggs=None, group_by=None,
                 group_budget: int = 0):
        super().__init__(schema, list(senders))
        self.rungs = rungs          # [{side, kind, left_slots, build_pos,
        #                              others, est}]
        self.slot_src = slot_src
        self.out_slots = out_slots
        self.out_ftypes = out_ftypes
        self.aggs = aggs
        self.group_by = group_by
        self.group_budget = group_budget
        # ([(kind "key" | "agg", index, desc)], k): the TopN above the
        # final HashAgg, kept on the card (set by _push_topn_into_tree)
        self.topn = None

    @property
    def name(self) -> str:
        return "MPPJoinTree"

    def task(self) -> str:
        return "mpp[tpu]"

    def info(self) -> str:
        order = " -> ".join(c.cop.table.name for c in self.children)
        s = f"order: {order}"
        if self.aggs is not None:
            s += f", partial aggs:[{', '.join(map(str, self.aggs))}]"
        if self.group_by:
            s += (f", group by:[{', '.join(map(str, self.group_by))}]"
                  f" budget:{self.group_budget}")
        return s

    def explain_tree(self, indent: int = 0, lines=None):
        lines = lines if lines is not None else []
        pad = ("  " * indent + "└─") if indent else ""
        lines.append((f"{pad}{self.name}_{self.id}", self._est_str(),
                      self.task(), self.info()))
        for i, r in enumerate(self.rungs):
            pad2 = "  " * (indent + 1) + "└─"
            build = self.children[r["side"]].cop.table.name
            info = (f"{r['kind']} build:{build}, "
                    f"keys:{r['left_slots']}=={r['build_pos']}")
            if r["others"]:
                info += " other:[" + ", ".join(
                    map(str, r["others"])) + "]"
            lines.append((f"{pad2}Rung_{i}", f"{r['est']:.2f}",
                          "mpp[tpu]", info))
        for c in self.children:
            c.explain_tree(indent + 1, lines)
        return lines

    def build(self, ctx):
        from ..mpp import MPPJoinSide
        from ..mpp.jointree import MPPJoinTreeSpec, TreeRung
        from ..mpp.reader import MPPTreeReaderExec

        sides = []
        for sender in self.children:
            sides.append(MPPJoinSide(
                table_id=sender.cop.table.id,
                dag=sender.dag.to_dict(),
                ranges=list(sender.ranges),
                key_pos=list(sender.key_pos),
                out_ftypes=sender.dag.output_ftypes(),
            ))
        rungs = [TreeRung(side=r["side"], kind=r["kind"],
                          left_slots=list(r["left_slots"]),
                          build_key_pos=list(r["build_pos"]),
                          other_conds=list(r["others"]),
                          est_rows=float(r["est"]))
                 for r in self.rungs]
        spec = MPPJoinTreeSpec(
            sides=sides, rungs=rungs, slot_src=list(self.slot_src),
            out_slots=list(self.out_slots),
            out_ftypes=list(self.out_ftypes),
            aggs=self.aggs, group_by=self.group_by,
            group_budget=self.group_budget, topn=self.topn)
        return MPPTreeReaderExec(ctx, spec, self.schema.ftypes(), self.id)


class PhysIndexLookUp(PhysicalPlan):
    """Index-range read: binary search the sorted index for handles, sparse
    block gather for rows (root task, host path — the OLTP lane)."""

    def __init__(self, schema: Schema, table: TableInfo, index_name: str,
                 index_offsets, rng, all_conds, residual_conds,
                 point_get: bool = False):
        super().__init__(schema, [])
        self.table = table
        self.index_name = index_name
        self.index_offsets = index_offsets
        self.rng = rng
        self.all_conds = all_conds
        self.residual_conds = residual_conds
        self.point_get = point_get

    @property
    def name(self) -> str:
        return "PointGet" if self.point_get else "IndexLookUp"

    def info(self) -> str:
        r = self.rng
        parts = [f"table:{self.table.name}", f"index:{self.index_name}"]
        if r.eq_prefix:
            parts.append(f"eq:{r.eq_prefix}")
        if r.low is not None or r.high is not None:
            lo = "(" if r.low_open else "["
            hi = ")" if r.high_open else "]"
            parts.append(f"range:{lo}{r.low}, {r.high}{hi}")
        return ", ".join(parts)

    def build(self, ctx):
        from ..executor.index_reader import IndexLookUpExec

        offsets = [c.store_offset for c in self.schema.cols]
        return IndexLookUpExec(
            ctx, self.table, list(self.index_offsets), self.rng,
            offsets, list(range(len(offsets))), self.all_conds,
            self.residual_conds, plan_id=self.id,
        )


class PhysIndexReader(PhysicalPlan):
    """Covering index-only scan (executor/distsql.go:317 IndexReader): the
    schema is served straight from the sorted index's key columns — the
    table is never touched."""

    def __init__(self, schema: Schema, table: TableInfo, index_name: str,
                 index_offsets: List[int], rng, out_pos: List[int],
                 all_conds, residual_conds):
        super().__init__(schema, [])
        self.table = table
        self.index_name = index_name
        self.index_offsets = index_offsets  # FULL index column offsets
        self.rng = rng
        self.out_pos = out_pos
        self.all_conds = all_conds
        self.residual_conds = residual_conds

    @property
    def name(self) -> str:
        return "IndexReader"

    def info(self) -> str:
        r = self.rng
        parts = [f"table:{self.table.name}", f"index:{self.index_name}",
                 "covering"]
        if r.eq_prefix:
            parts.append(f"eq:{r.eq_prefix}")
        if r.low is not None or r.high is not None:
            lo = "(" if r.low_open else "["
            hi = ")" if r.high_open else "]"
            parts.append(f"range:{lo}{r.low}, {r.high}{hi}")
        return ", ".join(parts)

    def build(self, ctx):
        from ..executor.index_reader import IndexReaderExec

        return IndexReaderExec(ctx, self.table, list(self.index_offsets),
                               self.rng, list(self.out_pos),
                               self.residual_conds, self.all_conds,
                               plan_id=self.id)


class PhysBatchPointGet(PhysicalPlan):
    """Multi-key point read over a unique index
    (executor/batch_point_get.go:1-176)."""

    def __init__(self, schema: Schema, table: TableInfo, index_name: str,
                 index_offsets: List[int], keys: List[tuple],
                 all_conds, residual_conds):
        super().__init__(schema, [])
        self.table = table
        self.index_name = index_name
        self.index_offsets = index_offsets
        self.keys = keys
        self.all_conds = all_conds
        self.residual_conds = residual_conds

    @property
    def name(self) -> str:
        return "Batch_Point_Get"

    def info(self) -> str:
        return (f"table:{self.table.name}, index:{self.index_name}, "
                f"keys:{len(self.keys)}")

    def build(self, ctx):
        from ..executor.index_reader import BatchPointGetExec

        offsets = [c.store_offset for c in self.schema.cols]
        return BatchPointGetExec(
            ctx, self.table, list(self.index_offsets), list(self.keys),
            offsets, list(range(len(offsets))), self.all_conds,
            self.residual_conds, plan_id=self.id)


class PhysUnionScan(PhysicalPlan):
    """Dirty-table scan merging the txn buffer (no pushdown)."""

    def __init__(self, schema: Schema, table: TableInfo,
                 conds: List[Expression]):
        super().__init__(schema, [])
        self.table = table
        self.conds = conds

    def info(self) -> str:
        return f"table:{self.table.name}, dirty"

    def build(self, ctx):
        from ..executor import UnionScanExec

        offsets = [c.store_offset for c in self.schema.cols]
        pos = {c.uid: i for i, c in enumerate(self.schema.cols)}
        conds = [c.remap_columns(pos) for c in self.conds]
        return UnionScanExec(ctx, self.table, offsets, conds,
                             with_handle=False, plan_id=self.id)


class PhysSelection(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, conds: List[Expression]):
        super().__init__(child.schema, [child])
        self.conds = conds

    def info(self) -> str:
        return ", ".join(str(c) for c in self.conds)

    def build(self, ctx):
        from ..executor import SelectionExec

        return SelectionExec(ctx, self.children[0].build(ctx), self.conds,
                             self.id)


class PhysProjection(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, exprs: List[Expression],
                 schema: Schema):
        super().__init__(schema, [child])
        self.exprs = exprs

    def info(self) -> str:
        return ", ".join(str(e) for e in self.exprs)

    def build(self, ctx):
        from ..executor import ProjectionExec

        return ProjectionExec(ctx, self.children[0].build(ctx), self.exprs,
                              self.id)


class PhysHashAgg(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, group_by: List[Expression],
                 aggs: List[AggDesc], partial_input: bool, schema: Schema):
        super().__init__(schema, [child])
        self.group_by = group_by
        self.aggs = aggs
        self.partial_input = partial_input

    def info(self) -> str:
        mode = "final" if self.partial_input else "complete"
        return (f"group:[{', '.join(map(str, self.group_by))}] "
                f"funcs:[{', '.join(map(str, self.aggs))}] mode:{mode}")

    def build(self, ctx):
        from ..executor import HashAggExec

        return HashAggExec(ctx, self.children[0].build(ctx), self.group_by,
                           self.aggs, self.partial_input, self.id)


class PhysStreamAgg(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, group_by, aggs, partial_input,
                 schema: Schema):
        super().__init__(schema, [child])
        self.group_by = group_by
        self.aggs = aggs
        self.partial_input = partial_input

    def info(self) -> str:
        return (f"group:[{', '.join(map(str, self.group_by))}] "
                f"funcs:[{', '.join(map(str, self.aggs))}]")

    def build(self, ctx):
        from ..executor import StreamAggExec

        return StreamAggExec(ctx, self.children[0].build(ctx), self.group_by,
                             self.aggs, self.partial_input, self.id)


class PhysHashJoin(PhysicalPlan):
    """children = [left, right] in schema order; build_right selects which
    child is materialized into the hash table."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan, kind: str,
                 left_keys: List[Expression], right_keys: List[Expression],
                 other_conds: List[Expression], build_right: bool,
                 schema: Schema, rf_build_key: Optional[int] = None,
                 rf_filter_id: int = 0):
        super().__init__(schema, [left, right])
        self.kind = kind
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.other_conds = other_conds
        self.build_right = build_right
        # index of the eq-key pair whose build-side distinct values are
        # shipped to the probe reader's device DAG as a runtime semi-join
        # filter (JoinProbeIR); None = no runtime filter
        self.rf_build_key = rf_build_key
        self.rf_filter_id = rf_filter_id

    def info(self) -> str:
        keys = ", ".join(
            f"{l}=={r}" for l, r in zip(self.left_keys, self.right_keys)
        )
        side = "build:right" if self.build_right else "build:left"
        s = f"{self.kind} [{keys}] {side}"
        if self.rf_build_key is not None:
            s += " runtime-filter"
        if self.other_conds:
            s += " other:[" + ", ".join(map(str, self.other_conds)) + "]"
        return s

    def build(self, ctx):
        from ..executor import HashJoinExec

        left = self.children[0].build(ctx)
        right = self.children[1].build(ctx)
        if self.build_right:
            build_exec, probe_exec, probe_is_left = right, left, True
            bkeys, pkeys = self.right_keys, self.left_keys
        else:
            build_exec, probe_exec, probe_is_left = left, right, False
            bkeys, pkeys = self.left_keys, self.right_keys
        rf_reader = probe_exec if self.rf_build_key is not None else None
        return HashJoinExec(ctx, build_exec, probe_exec, self.kind,
                            bkeys, pkeys, self.other_conds,
                            probe_is_left=probe_is_left, plan_id=self.id,
                            rf_reader=rf_reader,
                            rf_key_idx=self.rf_build_key or 0,
                            rf_filter_id=self.rf_filter_id)


class PhysIndexJoin(PhysicalPlan):
    """Index lookup join family (index_lookup_join.go:1-687,
    index_lookup_hash_join.go, index_lookup_merge_join.go): children =
    [outer]; the inner side is a (table, index) probe per outer batch."""

    VARIANT_NAMES = {"lookup": "IndexLookUpJoin",
                     "hash": "IndexLookUpHashJoin",
                     "merge": "IndexLookUpMergeJoin"}

    def __init__(self, outer: PhysicalPlan, kind: str, table: TableInfo,
                 index_name: str, index_offsets: List[int],
                 outer_keys: List[Expression], fetch_offsets: List[int],
                 out_pick: List[int], inner_conds: List[Expression],
                 other_conds: List[Expression], outer_is_left: bool,
                 variant: str, schema: Schema):
        super().__init__(schema, [outer])
        self.kind = kind
        self.table = table
        self.index_name = index_name
        self.index_offsets = index_offsets
        self.outer_keys = outer_keys
        self.fetch_offsets = fetch_offsets
        self.out_pick = out_pick
        self.inner_conds = inner_conds
        self.other_conds = other_conds
        self.outer_is_left = outer_is_left
        self.variant = variant

    @property
    def name(self) -> str:
        return self.VARIANT_NAMES.get(self.variant, "IndexLookUpJoin")

    def info(self) -> str:
        keys = ", ".join(str(k) for k in self.outer_keys)
        s = (f"{self.kind} inner:{self.table.name}, "
             f"index:{self.index_name}, outer key:[{keys}]")
        if self.inner_conds:
            s += " inner-cond:[" + ", ".join(map(str, self.inner_conds)) + "]"
        if self.other_conds:
            s += " other:[" + ", ".join(map(str, self.other_conds)) + "]"
        return s

    def explain_tree(self, indent: int = 0, lines=None):
        lines = lines if lines is not None else []
        pad = ("  " * indent + "└─") if indent else ""
        lines.append((f"{pad}{self.name}_{self.id}", self._est_str(),
                      self.task(), self.info()))
        pad2 = "  " * (indent + 1) + "└─"
        lines.append((f"{pad2}IndexRangeScan(Probe)", "", "root",
                      f"table:{self.table.name}, index:{self.index_name}"))
        for c in self.children:
            c.explain_tree(indent + 1, lines)
        return lines

    def build(self, ctx):
        from ..executor.index_join import IndexLookUpJoinExec

        return IndexLookUpJoinExec(
            ctx, self.children[0].build(ctx), self.table,
            list(self.index_offsets), self.outer_keys,
            list(self.fetch_offsets), list(self.out_pick),
            self.inner_conds, self.other_conds, self.kind,
            self.outer_is_left, self.variant, self.id)


class PhysMergeJoin(PhysicalPlan):
    """Sort-merge join over key-sorted children (merge_join.go)."""

    def __init__(self, left, right, kind, left_keys, right_keys,
                 other_conds, schema):
        super().__init__(schema, [left, right])
        self.kind = kind
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.other_conds = other_conds

    def info(self) -> str:
        keys = ", ".join(f"{l}=={r}" for l, r in
                         zip(self.left_keys, self.right_keys))
        return f"{self.kind} [{keys}]"

    def build(self, ctx):
        from ..executor import MergeJoinExec

        return MergeJoinExec(ctx, self.children[0].build(ctx),
                             self.children[1].build(ctx), self.kind,
                             self.left_keys, self.right_keys,
                             self.other_conds, self.id)


class PhysSort(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, items):
        super().__init__(child.schema, [child])
        self.items = items

    def info(self) -> str:
        return ", ".join(f"{e}{' desc' if d else ''}" for e, d in self.items)

    def build(self, ctx):
        from ..executor import SortExec

        return SortExec(ctx, self.children[0].build(ctx), self.items, self.id)


class PhysTopN(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, items, limit: int, offset: int):
        super().__init__(child.schema, [child])
        self.items = items
        self.limit = limit
        self.offset = offset

    def info(self) -> str:
        keys = ", ".join(f"{e}{' desc' if d else ''}" for e, d in self.items)
        return f"[{keys}] limit:{self.limit} offset:{self.offset}"

    def build(self, ctx):
        from ..executor import TopNExec

        return TopNExec(ctx, self.children[0].build(ctx), self.items,
                        self.limit, self.offset, self.id)


class PhysLimit(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, limit: int, offset: int):
        super().__init__(child.schema, [child])
        self.limit = limit
        self.offset = offset

    def info(self) -> str:
        return f"limit:{self.limit} offset:{self.offset}"

    def build(self, ctx):
        from ..executor import LimitExec

        return LimitExec(ctx, self.children[0].build(ctx), self.limit,
                         self.offset, self.id)


class PhysUnion(PhysicalPlan):
    def build(self, ctx):
        from ..executor import UnionExec

        return UnionExec(ctx, [c.build(ctx) for c in self.children],
                         self.schema.ftypes(), self.id)


class PhysDual(PhysicalPlan):
    def __init__(self, schema: Schema, row_count: int):
        super().__init__(schema, [])
        self.row_count = row_count

    def info(self) -> str:
        return f"rows:{self.row_count}"

    def build(self, ctx):
        from ..executor import TableDualExec

        return TableDualExec(ctx, self.schema.ftypes(), self.row_count,
                             self.id)


class PhysMaxOneRow(PhysicalPlan):
    def build(self, ctx):
        from ..executor import MaxOneRowExec

        return MaxOneRowExec(ctx, self.children[0].build(ctx), self.id)


class PhysMemTable(PhysicalPlan):
    def __init__(self, schema: Schema, provider_name: str, conds):
        super().__init__(schema, [])
        self.provider_name = provider_name
        self.conds = conds

    def info(self) -> str:
        return f"table:information_schema.{self.provider_name}"

    def build(self, ctx):
        from ..executor.memtable import MemTableExec

        pos = {c.uid: i for i, c in enumerate(self.schema.cols)}
        conds = [c.remap_columns(pos) for c in self.conds]
        return MemTableExec(ctx, self.provider_name,
                            [c.store_offset for c in self.schema.cols],
                            self.schema.ftypes(), conds, self.id)


class PhysWindow(PhysicalPlan):
    def __init__(self, child: PhysicalPlan, funcs, partition_by, order_by,
                 frame, schema: Schema):
        super().__init__(schema, [child])
        self.funcs = funcs  # [(uid, WindowFuncDesc)] remapped
        self.partition_by = partition_by
        self.order_by = order_by
        self.frame = frame

    def info(self) -> str:
        fns = ", ".join(f.name for _, f in self.funcs)
        parts = ", ".join(str(p) for p in self.partition_by)
        return f"funcs:[{fns}] partition:[{parts}]"

    def build(self, ctx):
        from ..executor.window import WindowExec

        return WindowExec(ctx, self.children[0].build(ctx),
                          [f for _, f in self.funcs], self.partition_by,
                          self.order_by, self.frame, self.id)


# ---------------------------------------------------------------------------
# DML physical wrappers
# ---------------------------------------------------------------------------


class PhysInsert(PhysicalPlan):
    def __init__(self, plan: InsertPlan,
                 select_phys: Optional[PhysicalPlan]):
        super().__init__(Schema([]), [select_phys] if select_phys else [])
        self.plan = plan

    def info(self) -> str:
        return f"table:{self.plan.table.name}"

    def build(self, ctx):
        from ..executor import InsertExec

        child = self.children[0].build(ctx) if self.children else None
        p = self.plan
        rows = None
        if p.rows is not None:
            from .build import DEFAULT_MARKER

            rows = []
            for r in p.rows:
                rows.append([
                    (p.table.columns[off].default
                     if v is DEFAULT_MARKER else v)
                    for v, off in zip(r, p.col_offsets)
                ])
        return InsertExec(ctx, p.table, p.col_offsets, rows, child,
                          p.replace, p.ignore, p.on_dup_update,
                          plan_id=self.id)


class PhysUpdate(PhysicalPlan):
    def __init__(self, plan: UpdatePlan):
        super().__init__(Schema([]), [])
        self.plan = plan

    def info(self) -> str:
        return f"table:{self.plan.table.name}"

    def build(self, ctx):
        from ..executor import UpdateExec

        t = self.plan.table
        readers = _dml_readers(ctx, t, self.plan.conditions, self.id)
        return UpdateExec(ctx, t, readers, self.plan.assignments, self.id)


class PhysDelete(PhysicalPlan):
    def __init__(self, plan: DeletePlan):
        super().__init__(Schema([]), [])
        self.plan = plan

    def info(self) -> str:
        return f"table:{self.plan.table.name}"

    def build(self, ctx):
        from ..executor import DeleteExec

        t = self.plan.table
        readers = _dml_readers(ctx, t, self.plan.conditions, self.id)
        return DeleteExec(ctx, t, readers, self.id)


def _dml_readers(ctx, t: TableInfo, conditions, plan_id: int):
    """(physical id, handle-scan) pairs feeding UPDATE/DELETE: one per
    pruned partition (conditions are full-row-offset exprs, so pruning
    matches by store offset)."""
    from ..executor import UnionScanExec

    offsets = [c.offset for c in t.columns]
    if not t.is_partitioned:
        return [(t.id, UnionScanExec(ctx, t, offsets, conditions,
                                     with_handle=True, plan_id=plan_id))]
    from .partition import prune_partitions

    part_off = t.find_column(t.partition_info.column).offset
    parts = prune_partitions(t, conditions, part_off, by_offset=True)
    return [
        (pd.id, UnionScanExec(ctx, t.partition_table(pd), offsets,
                              conditions, with_handle=True, plan_id=plan_id))
        for pd in parts
    ]


class PhysLoadData(PhysicalPlan):
    def __init__(self, plan: LoadDataPlan):
        super().__init__(Schema([]), [])
        self.plan = plan

    def build(self, ctx):
        from ..executor import LoadDataExec

        p = self.plan
        return LoadDataExec(ctx, p.table, p.path, p.fields_terminated,
                            p.ignore_lines, self.id)


# ---------------------------------------------------------------------------
# logical -> physical conversion (find_best_task analog, rule-based)
# ---------------------------------------------------------------------------


@dataclass
class PhysicalContext:
    storage: object
    dirty_tables: frozenset = frozenset()
    pushdown_blacklist: frozenset = frozenset()
    enable_pushdown: bool = True
    stats: object = None  # StatsHandle
    prefer_merge_join: bool = False  # tidb_opt_prefer_merge_join
    enable_index_join: bool = True  # tidb_opt_enable_index_join
    index_join_variant: str = "lookup"  # tidb_index_join_variant
    # tidb_check_plan: run the lint.plancheck schema/dtype verifier over
    # every finished physical plan (vet-for-plans; cheap host-side walk)
    check_plan: bool = False
    # MPP shuffle-join routing (tidb_allow_mpp / tidb_enforce_mpp /
    # tidb_broadcast_join_threshold_count): build sides at or below the
    # threshold stay on the broadcast/host lanes; bigger ones shuffle
    allow_mpp: bool = True
    enforce_mpp: bool = False
    mpp_threshold: int = 10240


def to_physical(plan: LogicalPlan, pctx: PhysicalContext) -> PhysicalPlan:
    from .logical import LogicalMemTable

    if isinstance(plan, LogicalDataSource):
        return _finish_datasource(plan, pctx)

    if isinstance(plan, LogicalMemTable):
        return PhysMemTable(plan.schema, plan.provider_name,
                            plan.pushed_conds)

    if isinstance(plan, LogicalSelection):
        child_l = plan.children[0]
        if isinstance(child_l, LogicalMemTable):
            child_l.pushed_conds.extend(plan.conds)
            return PhysMemTable(child_l.schema, child_l.provider_name,
                                child_l.pushed_conds)
        if isinstance(child_l, LogicalDataSource):
            child_l.pushed_conds.extend(plan.conds)
            return _finish_datasource(child_l, pctx)
        child = to_physical(child_l, pctx)
        conds = _remap(plan.conds, child.schema)
        return PhysSelection(child, conds)

    if isinstance(plan, LogicalProjection):
        child = to_physical(plan.children[0], pctx)
        exprs = _remap(plan.exprs, child.schema)
        return PhysProjection(child, exprs, plan.schema)

    if isinstance(plan, LogicalAggregation):
        return _physical_agg(plan, pctx)

    if isinstance(plan, LogicalTopN):
        return _physical_topn(plan, pctx)

    if isinstance(plan, LogicalSort):
        child = to_physical(plan.children[0], pctx)
        items = [(e, d) for e, d in
                 zip(_remap([e for e, _ in plan.items], child.schema),
                     [d for _, d in plan.items])]
        return PhysSort(child, items)

    if isinstance(plan, LogicalLimit):
        child, pushed = _try_push_limit(plan, pctx)
        if pushed is not None:
            return pushed
        return PhysLimit(child, plan.limit, plan.offset)

    if isinstance(plan, LogicalJoin):
        return _physical_join(plan, pctx)

    if isinstance(plan, LogicalUnion):
        children = [to_physical(c, pctx) for c in plan.children]
        return PhysUnion(plan.schema, children)

    if isinstance(plan, LogicalDual):
        return PhysDual(plan.schema, plan.row_count)

    if isinstance(plan, LogicalMaxOneRow):
        child = to_physical(plan.children[0], pctx)
        return PhysMaxOneRow(child.schema, [child])

    from ..executor.window import WindowFuncDesc
    from .logical import LogicalWindow

    if isinstance(plan, LogicalWindow):
        child = to_physical(plan.children[0], pctx)
        pos = child.schema.position_map()
        funcs = [
            (uid, WindowFuncDesc(
                f.name, _remap(f.args, child.schema), f.ftype))
            for uid, f in plan.funcs
        ]
        partition = _remap(plan.partition_by, child.schema)
        order = [(e, d) for e, d in zip(
            _remap([e for e, _ in plan.order_by], child.schema),
            [d for _, d in plan.order_by])]
        win_cols = {uid for uid, _ in plan.funcs}
        out_schema = Schema(
            list(child.schema.cols)
            + [c for c in plan.schema.cols if c.uid in win_cols]
        )
        return PhysWindow(child, funcs, partition, order, plan.frame,
                          out_schema)

    raise PlanError(f"no physical impl for {type(plan).__name__}")


def physical_for_stmt(plan, pctx: PhysicalContext) -> PhysicalPlan:
    """Entry covering DML containers too."""
    if isinstance(plan, InsertPlan):
        sub = to_physical(plan.select_plan, pctx) if plan.select_plan else None
        return PhysInsert(plan, sub)
    if isinstance(plan, UpdatePlan):
        return PhysUpdate(plan)
    if isinstance(plan, DeletePlan):
        return PhysDelete(plan)
    if isinstance(plan, LoadDataPlan):
        return PhysLoadData(plan)
    return to_physical(plan, pctx)


# ---- datasource / cop-task assembly ---------------------------------------


def _dict_uids(ds: LogicalDataSource, pctx: PhysicalContext) -> set:
    dict_cols = set()
    for pid in ds.table.physical_ids():
        dict_cols |= pctx.storage.table(pid).dict_encoded_cols()
    return {c.uid for c in ds.schema.cols if c.store_offset in dict_cols}


def _split_pushable(conds, blacklist, dict_uids):
    push, residual = [], []
    for c in conds:
        (push if can_push_expr(c, blacklist, dict_uids) else residual).append(c)
    return push, residual


def _start_cop(ds: LogicalDataSource, pctx: PhysicalContext):
    """Build the cop task skeleton: scan + pushable selection; return
    (CopTask, residual_conds).  For a partitioned table the task carries the
    pruned per-partition ranges (rule_partition_processor.go analog)."""
    task = CopTask(ds.table, list(ds.schema.cols))
    dirty = any(pid in pctx.dirty_tables for pid in ds.table.physical_ids())
    if dirty or not pctx.enable_pushdown:
        return None, list(ds.pushed_conds)
    if ds.table.is_partitioned:
        parts = _pruned_partitions(ds)
        task.ranges = [KeyRange(pd.id, 0, INF) for pd in parts]
        task.partitions = [pd.name for pd in parts]
    dict_uids = _dict_uids(ds, pctx)
    push, residual = _split_pushable(
        ds.pushed_conds, pctx.pushdown_blacklist, dict_uids
    )
    if push:
        pos = task.scan_pos_map()
        task.dag_execs.append(
            SelectionIR([c.remap_columns(pos) for c in push])
        )
    task.out_schema = Schema(task.scan_cols)
    return task, residual


def _pruned_partitions(ds: LogicalDataSource):
    from .partition import partition_uid, prune_partitions

    puid = partition_uid(ds.table, ds.schema)
    if puid is None:
        return list(ds.table.partition_info.defs)
    return prune_partitions(ds.table, ds.pushed_conds, puid)


def _finish_datasource(ds: LogicalDataSource,
                       pctx: PhysicalContext) -> PhysicalPlan:
    ix = _try_index_path(ds, pctx)
    if ix is not None:
        return ix
    task, residual = _start_cop(ds, pctx)
    if task is not None and task.ranges == []:
        return PhysDual(ds.schema, 0)  # every partition pruned
    if task is None:
        if ds.table.is_partitioned:
            # dirty/no-pushdown partitioned scan: one UnionScan per pruned
            # partition, concatenated (each partition is its own physical
            # table to the txn buffer and store)
            parts = _pruned_partitions(ds)
            if not parts:
                return PhysDual(ds.schema, 0)
            kids = [PhysUnionScan(ds.schema, ds.table.partition_table(pd),
                                  list(ds.pushed_conds)) for pd in parts]
            if len(kids) == 1:
                return kids[0]
            return PhysUnion(ds.schema, kids)
        return PhysUnionScan(ds.schema, ds.table, list(ds.pushed_conds))
    reader = PhysTableReader(Schema(task.scan_cols), task, keep_order=False,
                             ranges=ds.ranges)
    out: PhysicalPlan = reader
    if residual:
        out = PhysSelection(reader, _remap(residual, reader.schema))
    return out


def _try_index_path(ds: LogicalDataSource,
                    pctx: PhysicalContext) -> Optional[PhysicalPlan]:
    """Pick an index read over the device scan when the predicate pins a
    unique key or stats say the range is very selective (find_best_task's
    index-path choice, rule-based)."""
    if not ds.pushed_conds or not ds.table.indexes:
        return None
    if ds.table.is_partitioned:
        # sorted indexes are per-partition stores; the index read path
        # addresses a single store — partitioned tables take the pruned
        # mesh-scan path instead
        return None
    from .ranger import build_access_path

    store = pctx.storage.table(ds.table.id)
    by_name = {c.name.lower(): c for c in ds.schema.cols}
    uid_to_off = {c.uid: c.store_offset for c in ds.schema.cols}
    bpg = _try_batch_point_get(ds, store, by_name)
    if bpg is not None:
        return bpg
    best = None  # (score, index, path)
    from ..catalog.schema import STATE_PUBLIC as _PUB

    for ix in ds.table.indexes:
        if ix.state != _PUB:
            continue  # online DDL: only public indexes serve reads
        uids = []
        for cname in ix.columns:
            sc = by_name.get(cname.lower())
            if sc is None:
                break  # column pruned away -> no conds reference it
            uids.append(sc.uid)
        if not uids:
            continue
        path = build_access_path(ds.pushed_conds, uids, uid_to_off, store)
        if path is None:
            continue
        unique_full_eq = (
            (ix.unique or ix.primary)
            and path.rng.full_eq_depth == len(ix.columns)
            and path.rng.low is None and path.rng.high is None
        )
        score = (2 if unique_full_eq else 0) + path.rng.full_eq_depth \
            + (0.5 if path.rng.low is not None or path.rng.high is not None
               else 0)
        if best is None or score > best[0]:
            best = (score, ix, path, unique_full_eq)
    if best is None:
        return None
    _, ix, path, unique_full_eq = best
    if not unique_full_eq:
        # non-unique: only beat the device brute-force scan when stats say
        # the range is tiny
        if pctx.stats is None:
            return None
        offmap = {c.uid: c.store_offset for c in ds.schema.cols}
        remapped = [c.remap_columns(offmap) for c in path.access_conds]
        sel = pctx.stats.estimate_selectivity(ds.table.id, remapped)
        total = store.base_rows + len(store.delta)
        if pctx.stats.get(ds.table.id) is None or \
                sel * total > max(1000.0, 0.05 * total):
            return None
    index_offsets = [store.col_index(c) for c in ix.columns[:max(
        path.rng.full_eq_depth + (1 if path.rng.low is not None
                                  or path.rng.high is not None else 0), 1)]]
    pos = {c.uid: i for i, c in enumerate(ds.schema.cols)}
    all_conds = [c.remap_columns(pos) for c in ds.pushed_conds]
    residual = [c.remap_columns(pos) for c in path.residual_conds]
    if not unique_full_eq:
        cov = _try_covering_reader(ds, store, ix, path, all_conds, residual)
        if cov is not None:
            return cov
    return PhysIndexLookUp(ds.schema, ds.table, ix.name, index_offsets,
                           path.rng, all_conds, residual,
                           point_get=unique_full_eq)


def _try_covering_reader(ds: LogicalDataSource, store, ix, path,
                         all_conds, residual) -> Optional[PhysicalPlan]:
    """Upgrade an index path to a covering IndexReader when the output is
    served entirely by the index key columns (executor/distsql.go:317):
    skips the table-side sparse gather altogether."""
    name_to_ixpos = {n.lower(): i for i, n in enumerate(ix.columns)}
    out_pos = []
    for c in ds.schema.cols:
        p = name_to_ixpos.get(c.name.lower())
        if p is None:
            return None  # not covering
        out_pos.append(p)
    # NULL safety: the sorted index EXCLUDES rows with NULL in any key
    # column (store/index.py SortedIndex).  A covering read is sound only
    # when every nullable key column is pinned by a null-rejecting access
    # cond — i.e. sits inside the constrained prefix of the range walk.
    constrained = path.rng.full_eq_depth + (
        1 if path.rng.low is not None or path.rng.high is not None else 0)
    for depth, cname in enumerate(ix.columns):
        off = store.col_index(cname)
        if ds.table.columns[off].ftype.nullable and depth >= constrained:
            return None
    full_offsets = [store.col_index(c) for c in ix.columns]
    return PhysIndexReader(ds.schema, ds.table, ix.name, full_offsets,
                           path.rng, out_pos, all_conds, residual)


def _try_batch_point_get(ds: LogicalDataSource, store,
                         by_name) -> Optional[PhysicalPlan]:
    """`key IN (c1..ck)` over a single-column unique index becomes one
    multi-key point read (executor/batch_point_get.go:1-176)."""
    from ..catalog.schema import STATE_PUBLIC as _PUB
    from .ranger import _const_key

    for ix in ds.table.indexes:
        if ix.state != _PUB or not (ix.unique or ix.primary):
            continue
        if len(ix.columns) != 1:
            continue
        sc = by_name.get(ix.columns[0].lower())
        if sc is None:
            continue
        for cond in ds.pushed_conds:
            if not (isinstance(cond, ScalarFunc) and cond.name == "in"
                    and len(cond.args) >= 2
                    and isinstance(cond.args[0], ColumnExpr)
                    and all(isinstance(a, Constant) for a in cond.args[1:])):
                continue
            col = cond.args[0]
            uid = col.unique_id if col.unique_id >= 0 else col.index
            if uid != sc.uid:
                continue
            off = sc.store_offset
            keys, seen = [], set()
            for a in cond.args[1:]:
                ke = _const_key(col, a, store, off, "=")
                if ke is None or ke[1] != "=":
                    continue  # NULL / unrepresentable -> matches nothing
                if ke[0] not in seen:
                    seen.add(ke[0])
                    keys.append((ke[0],))
            pos = {c.uid: i for i, c in enumerate(ds.schema.cols)}
            all_conds = [c.remap_columns(pos) for c in ds.pushed_conds]
            residual = [c.remap_columns(pos) for c in ds.pushed_conds
                        if c is not cond]
            return PhysBatchPointGet(ds.schema, ds.table, ix.name, [off],
                                     keys, all_conds, residual)
    return None


def _physical_agg(plan: LogicalAggregation,
                  pctx: PhysicalContext) -> PhysicalPlan:
    child_l = plan.children[0]
    # a pin-point index read beats the device scan for OLTP-shaped aggs
    if isinstance(child_l, LogicalDataSource):
        ix = _try_index_path(child_l, pctx)
        if ix is not None:
            gb = _remap(plan.group_by, ix.schema)
            aggs = [a.remap_columns(ix.schema.position_map())
                    for a in plan.aggs]
            return PhysHashAgg(ix, gb, aggs, False, plan.schema)
    # direct cop-task child (DataSource or Selection(DataSource) already
    # collapsed by rules into ds.pushed_conds)
    if isinstance(child_l, LogicalDataSource) and pctx.enable_pushdown:
        task, residual = _start_cop(child_l, pctx)
        if task is not None and task.ranges == []:
            task = None  # every partition pruned: plan over an empty Dual
        if task is not None and not residual and plan.aggs:
            dict_uids = _dict_uids(child_l, pctx)
            ok = all(
                can_push_expr(g, pctx.pushdown_blacklist, dict_uids)
                or _is_plain_col(g)
                # computed STRING keys over dict columns lower to device
                # dict-code re-mapping — push the agg
                or can_remap_group_key(g, dict_uids)
                for g in plan.group_by
            ) and all(
                can_push_agg(a, pctx.pushdown_blacklist, dict_uids)
                for a in plan.aggs
            )
            if ok:
                pos = task.scan_pos_map()
                gb = [g.remap_columns(pos) for g in plan.group_by]
                aggs = [a.remap_columns(pos) for a in plan.aggs]
                task.dag_execs.append(AggregationIR(gb, aggs, mode="partial"))
                # first_row partials are position-sensitive: region chunks
                # must merge in handle order or the "first" value depends on
                # task completion order (the mesh path is deterministic —
                # global min row index — so the fan-out path must match)
                has_first = any(a.name == "first_row" for a in aggs)
                reader = PhysTableReader(
                    _partial_schema(plan), task, keep_order=has_first,
                    ranges=child_l.ranges,
                )
                # final merge positions: [keys..., states...] by position
                n = len(plan.group_by)
                fin_gb = [
                    ColumnExpr(i, g.ftype, str(g), -1)
                    for i, g in enumerate(plan.group_by)
                ]
                return PhysHashAgg(reader, fin_gb, plan.aggs, True,
                                   plan.schema)
    # agg over an eligible inner join: push scan+filter+JOIN+partial agg
    # into one device program (the Q3/SSB star-aggregate shape); when the
    # build side is too big to broadcast, the MPP shuffle join carries
    # the same partial-agg pushdown (scalar aggs)
    if isinstance(child_l, LogicalJoin) and pctx.enable_pushdown:
        dj = _try_device_join_agg(plan, child_l, pctx)
        if dj is not None:
            return dj
        mj = _try_mpp_join_agg(plan, child_l, pctx)
        if mj is not None:
            return mj
    # agg over a multi-way join TREE (optionally through a projection,
    # the derived-table shape of Q7/Q8/Q9): the join-tree compiler
    # lowers the whole ladder + partial agg onto the device
    if isinstance(child_l, (LogicalJoin, LogicalProjection)) \
            and pctx.enable_pushdown:
        from .jointree import try_jointree_agg

        tj = try_jointree_agg(plan, child_l, pctx)
        if tj is not None:
            return tj
    child = to_physical(child_l, pctx)
    gb = _remap(plan.group_by, child.schema)
    aggs = [a.remap_columns(child.schema.position_map()) for a in plan.aggs]
    return PhysHashAgg(child, gb, aggs, False, plan.schema)


# device-join gates: the build side is broadcast to every shard, so it must
# be decisively the small side; the key must be int-domain and plan-time
# unique (lookup join semantics: <= 1 match per probe row)
DEVICE_JOIN_BUILD_MAX = 2_000_000
_DJ_KEY_KINDS = (TypeKind.INT, TypeKind.UINT, TypeKind.DECIMAL,
                 TypeKind.DATE)
_DJ_PAYLOAD_KINDS = _DJ_KEY_KINDS + (TypeKind.FLOAT, TypeKind.BOOL)


def _build_key_unique(plan, uid: int) -> bool:
    """Conservative plan-time uniqueness: does each output row of `plan`
    carry a distinct value of column `uid`?  (util/ranger + schema key
    inference role — TiDB's schema.Keys/maxOneRow propagation.)"""
    from .logical import (LogicalAggregation, LogicalDataSource, LogicalJoin,
                          LogicalProjection, LogicalSelection)

    if isinstance(plan, LogicalDataSource):
        sc = next((c for c in plan.schema.cols if c.uid == uid), None)
        if sc is None:
            return False
        t = plan.table
        if 0 <= t.pk_is_handle < len(t.columns) \
                and t.columns[t.pk_is_handle].name == sc.name:
            return True
        return any((ix.unique or ix.primary) and len(ix.columns) == 1
                   and ix.columns[0] == sc.name for ix in t.indexes)
    if isinstance(plan, LogicalSelection):
        return _build_key_unique(plan.children[0], uid)
    if isinstance(plan, LogicalProjection):
        if not any(c.uid == uid for c in plan.schema.cols):
            return False
        return _build_key_unique(plan.children[0], uid)
    if isinstance(plan, LogicalAggregation):
        # the SOLE group-by key is unique per output row by construction;
        # with multiple keys the same value of one key can repeat
        return (len(plan.group_by) == 1
                and isinstance(plan.group_by[0], ColumnExpr)
                and plan.group_by[0].unique_id == uid)
    if isinstance(plan, LogicalJoin):
        left, right = plan.children
        in_left = any(c.uid == uid for c in left.schema.cols)
        side, other = (left, right) if in_left else (right, left)
        if not _build_key_unique(side, uid):
            return False
        if plan.kind in ("semi", "anti_semi") and in_left:
            return True  # semi joins only filter left rows
        if plan.kind == "inner" and len(plan.eq_conds) == 1:
            # each side row matches <= 1 other row iff the other side's
            # eq key is unique there
            le, re_ = plan.eq_conds[0]
            oe = re_ if in_left else le
            if isinstance(oe, ColumnExpr) and oe.unique_id >= 0:
                return _build_key_unique(other, oe.unique_id)
        return False
    return False


def _try_device_join_agg(plan: LogicalAggregation, join: LogicalJoin,
                         pctx: PhysicalContext):
    """Agg(InnerJoin(probe datasource, small unique-key build)) ->
    final agg over a DeviceJoinReader whose cop DAG is
    scan -> selection -> JoinLookupIR -> partial AggregationIR.
    Returns None whenever any gate fails (the generic paths take over)."""
    from ..copr.ir import JoinLookupIR

    if join.kind != "inner" or len(join.eq_conds) != 1 or join.other_conds:
        return None
    if not plan.aggs:
        return None
    if pctx.prefer_merge_join:
        return None  # MERGE_JOIN hint/binding pins the root algorithm
    if pctx.enforce_mpp:
        return None  # tidb_enforce_mpp pins the exchange engine
    left, right = join.children
    le, re_ = join.eq_conds[0]
    for probe_l, build_l, pk_e, bk_e in (
            (left, right, le, re_), (right, left, re_, le)):
        if not isinstance(probe_l, LogicalDataSource):
            continue
        if not isinstance(bk_e, ColumnExpr) or bk_e.unique_id < 0:
            continue
        if pk_e.ftype.kind not in _DJ_KEY_KINDS:
            continue
        # both key sides must share the scaled-int comparison domain
        if bk_e.ftype.kind != pk_e.ftype.kind:
            continue
        if pk_e.ftype.kind == TypeKind.DECIMAL \
                and bk_e.ftype.scale != pk_e.ftype.scale:
            continue
        if not _build_key_unique(build_l, bk_e.unique_id):
            continue
        task, residual = _start_cop(probe_l, pctx)
        if task is None or residual:
            continue
        if task.ranges == []:
            continue  # fully pruned: the Dual path handles it
        if any(not isinstance(ex, SelectionIR) for ex in task.dag_execs):
            continue
        dict_uids = _dict_uids(probe_l, pctx)
        from ..expr.pushdown import can_push_agg, can_push_expr

        if not can_push_expr(pk_e, pctx.pushdown_blacklist, dict_uids):
            continue
        probe_uids = {c.uid for c in probe_l.schema.cols}
        build_pos = {c.uid: i for i, c in enumerate(build_l.schema.cols)}
        # split agg expr refs between probe scan cols and build payload
        refs: set = set()
        for g in plan.group_by:
            g.collect_columns(refs)
        for a in plan.aggs:
            for x in a.args:
                x.collect_columns(refs)
        payload_uids = sorted(u for u in refs if u not in probe_uids)
        if any(u not in build_pos for u in payload_uids):
            continue  # references something outside the join
        payload_cols = [build_l.schema.cols[build_pos[u]]
                        for u in payload_uids]
        if any(c.ftype.kind not in _DJ_PAYLOAD_KINDS for c in payload_cols):
            continue
        if any(a.name == "first_row" and any(
                u not in probe_uids
                for u in _collect(a)) for a in plan.aggs):
            continue  # first_row partials gather from the table
        # size gate (after the cheap structural gates)
        build_phys = to_physical(build_l, pctx)
        build_est = _est_rows(build_phys, pctx)
        probe_est = _est_rows(
            PhysTableReader(Schema(task.scan_cols), task, False,
                            probe_l.ranges), pctx)
        if build_est > DEVICE_JOIN_BUILD_MAX \
                or build_est > 0.5 * max(probe_est, 1):
            continue
        # remap: probe uids -> scan positions; build uids -> payload slots
        scan_w = len(task.scan_cols)
        mapping = dict(task.scan_pos_map())
        for j, u in enumerate(payload_uids):
            mapping[u] = scan_w + j
        gb = [g.remap_columns(mapping) for g in plan.group_by]
        aggs = [a.remap_columns(mapping) for a in plan.aggs]
        if not all(can_push_expr(g, pctx.pushdown_blacklist, dict_uids)
                   or _is_plain_col(g) for g in gb):
            continue
        if not all(can_push_agg(a, pctx.pushdown_blacklist, dict_uids)
                   for a in aggs):
            continue
        pk_pos = pk_e.remap_columns(task.scan_pos_map())
        task.dag_execs.append(JoinLookupIR(
            pk_pos, 0, [c.ftype for c in payload_cols]))
        task.dag_execs.append(AggregationIR(gb, aggs, mode="partial"))
        # first_row partials are position-sensitive: region chunks must
        # merge in handle order (same invariant as the direct agg
        # pushdown path) or "first" depends on task completion order
        has_first = any(a.name == "first_row" for a in aggs)
        reader = PhysTableReader(_partial_schema(plan), task,
                                 keep_order=has_first,
                                 ranges=probe_l.ranges)
        djr = PhysDeviceJoinReader(
            reader.schema, reader, build_phys,
            build_pos[bk_e.unique_id],
            [build_pos[u] for u in payload_uids])
        fin_gb = [ColumnExpr(i, g.ftype, str(g), -1)
                  for i, g in enumerate(plan.group_by)]
        return PhysHashAgg(djr, fin_gb, plan.aggs, True, plan.schema)
    return None


def _collect(a) -> set:
    refs: set = set()
    for x in a.args:
        x.collect_columns(refs)
    return refs


def _partial_schema(plan: LogicalAggregation) -> Schema:
    cols = []
    from .columns import next_uid

    for g in plan.group_by:
        cols.append(SchemaCol(next_uid(), str(g), g.ftype))
    for a in plan.aggs:
        for j, pt in enumerate(a.partial_types()):
            cols.append(SchemaCol(next_uid(), f"{a}#{j}", pt))
    return Schema(cols)


def _physical_topn(plan: LogicalTopN, pctx: PhysicalContext) -> PhysicalPlan:
    child_l = plan.children[0]
    k = plan.limit + plan.offset
    if isinstance(child_l, LogicalDataSource) and pctx.enable_pushdown:
        task, residual = _start_cop(child_l, pctx)
        if task is not None and task.ranges == []:
            task = None
        if task is not None and not residual:
            dict_uids = _dict_uids(child_l, pctx)
            if all(can_push_expr(e, pctx.pushdown_blacklist, dict_uids)
                   or _is_plain_col(e) for e, _ in plan.items):
                pos = task.scan_pos_map()
                items = [(e.remap_columns(pos), d) for e, d in plan.items]
                task.dag_execs.append(TopNIR(items, k))
                reader = PhysTableReader(Schema(task.scan_cols), task,
                                         keep_order=False,
                                         ranges=child_l.ranges)
                ritems = [(e.remap_columns(reader.schema.position_map()), d)
                          for e, d in plan.items]
                return PhysTopN(reader, ritems, plan.limit, plan.offset)
    child = to_physical(child_l, pctx)
    items = [(e, d) for e, d in
             zip(_remap([e for e, _ in plan.items], child.schema),
                 [d for _, d in plan.items])]
    _push_topn_into_tree(child, items, k)
    return PhysTopN(child, items, plan.limit, plan.offset)


#: kinds whose values order on the card as SQL orders them (int64 words)
_TREE_TOPN_KINDS = (TypeKind.INT, TypeKind.DATE, TypeKind.DECIMAL)


def _push_topn_into_tree(child: PhysicalPlan, items, k: int):
    """A TopN over the final HashAgg of a join tree's grouped final: the
    groups the tree merges on the card are whole and unique there, so
    its final phase keeps only the k that lead by `items`, and k group
    rows leave the card instead of every group.  The HashAgg and the
    TopN still run over those k.  Items must be plain group keys of
    int64-ordered kinds, or count / sum / min / max over such kinds."""
    if not (isinstance(child, PhysHashAgg) and child.partial_input
            and isinstance(child.children[0], PhysMPPJoinTree)):
        return
    tree = child.children[0]
    if not tree.group_by or tree.aggs is None:
        return
    n_gb = len(tree.group_by)
    out = []
    for e, desc in items:
        if not isinstance(e, ColumnExpr):
            return
        if e.index < n_gb:
            ft = tree.group_by[e.index].ftype
            if ft.kind not in _TREE_TOPN_KINDS or ft.is_wide_decimal:
                return
            out.append(("key", e.index, bool(desc)))
            continue
        # a pushed aggregate's state is an int64 word on the card,
        # whatever the width of its SQL type
        a = tree.aggs[e.index - n_gb]
        if a.distinct or a.name not in ("count", "sum", "min", "max") or (
                a.name != "count"
                and a.args[0].ftype.kind not in _TREE_TOPN_KINDS):
            return
        out.append(("agg", e.index - n_gb, bool(desc)))
    tree.topn = (out, k)


def _try_push_limit(plan: LogicalLimit, pctx: PhysicalContext):
    child_l = plan.children[0]
    if isinstance(child_l, LogicalDataSource) and pctx.enable_pushdown:
        task, residual = _start_cop(child_l, pctx)
        if task is not None and task.ranges == []:
            task = None
        if task is not None and not residual:
            task.dag_execs.append(LimitIR(plan.limit + plan.offset))
            reader = PhysTableReader(Schema(task.scan_cols), task,
                                     keep_order=False, ranges=child_l.ranges)
            return None, PhysLimit(reader, plan.limit, plan.offset)
    return to_physical(child_l, pctx), None


def _try_index_join(plan: LogicalJoin,
                    pctx: PhysicalContext) -> Optional[PhysicalPlan]:
    """Choose an index lookup join when the inner side is a datasource with
    a usable index on the join keys and the outer side is small (the
    reference's index-join path in planner/core/exhaust_physical_plans.go;
    executors match index_lookup_join.go / _hash_ / _merge_)."""
    if not pctx.enable_index_join or not plan.eq_conds:
        return None
    if plan.kind not in ("inner", "left_outer", "semi", "anti_semi"):
        return None
    from ..catalog.schema import STATE_PUBLIC as _PUB
    from .rules import _bool_ft, _est_member

    sides = [1] + ([0] if plan.kind == "inner" else [])
    for inner_pos in sides:
        inner_l = plan.children[inner_pos]
        outer_l = plan.children[1 - inner_pos]
        if not isinstance(inner_l, LogicalDataSource):
            continue
        if inner_l.table.is_partitioned:
            continue  # index lookups address one partition store
        inner_cols = {c.uid: c for c in inner_l.schema.cols}
        eqmap = {}  # inner col uid -> (outer_expr, compare type, pair)
        for le, re in plan.eq_conds:
            ie, oe = (re, le) if inner_pos == 1 else (le, re)
            ct = common_compare_type(le.ftype, re.ftype)
            if (isinstance(ie, ColumnExpr)
                    and ie.unique_id in inner_cols
                    and ie.unique_id not in eqmap
                    and _ij_type_ok(ct, inner_cols[ie.unique_id].ftype)):
                eqmap[ie.unique_id] = (oe, ct, (le, re))
        if not eqmap:
            continue
        store = pctx.storage.table(inner_l.table.id)
        by_name = {c.name.lower(): c for c in inner_l.schema.cols}
        best = None  # ((prefix_len, unique_full), ix, prefix schema cols)
        for ix in inner_l.table.indexes:
            if ix.state != _PUB:
                continue
            prefix = []
            for cname in ix.columns:
                sc = by_name.get(cname.lower())
                if sc is None or sc.uid not in eqmap:
                    break
                prefix.append(sc)
            if not prefix:
                continue
            score = (len(prefix),
                     1 if ix.unique and len(prefix) == len(ix.columns) else 0)
            if best is None or score > best[0]:
                best = (score, ix, prefix)
        if best is None:
            continue
        _, ix, prefix = best
        # cost gate: the lookup path wins only when the outer side is small
        # relative to the inner table (otherwise the device scan + hash
        # join lane is faster); mirrors the small-outer heuristic of the
        # reference's index-join cost
        outer_est = _est_member(outer_l, pctx)
        inner_rows = store.base_rows + len(store.delta)
        if outer_est > 4096 or outer_est * 16 > max(inner_rows, 1):
            continue
        outer_phys = to_physical(outer_l, pctx)
        omap = outer_phys.schema.position_map()
        outer_keys, index_offsets, chosen = [], [], []
        for sc in prefix:
            oe, ct, pair = eqmap[sc.uid]
            outer_keys.append(_maybe_cast(oe.remap_columns(omap), ct))
            index_offsets.append(sc.store_offset)
            chosen.append(pair)
        outer_is_left = inner_pos == 1
        if outer_is_left:
            pair_cols = list(outer_phys.schema.cols) + list(inner_l.schema.cols)
        else:
            pair_cols = list(inner_l.schema.cols) + list(outer_phys.schema.cols)
        pair_map = {c.uid: i for i, c in enumerate(pair_cols)}
        others = [c.remap_columns(pair_map) for c in plan.other_conds]
        for le, re in plan.eq_conds:
            if any(p[0] is le and p[1] is re for p in chosen):
                continue
            others.append(ScalarFunc(
                "=", [le.remap_columns(pair_map), re.remap_columns(pair_map)],
                _bool_ft(), {}))
        fetch_offsets = [c.store_offset for c in inner_l.schema.cols]
        fmap = {c.uid: i for i, c in enumerate(inner_l.schema.cols)}
        inner_conds = [c.remap_columns(fmap) for c in inner_l.pushed_conds]
        return PhysIndexJoin(
            outer_phys, plan.kind, inner_l.table, ix.name, index_offsets,
            outer_keys, fetch_offsets, list(range(len(fetch_offsets))),
            inner_conds, others, outer_is_left,
            pctx.index_join_variant, plan.schema)
    return None


def _ij_type_ok(ct: FieldType, inner_ft: FieldType) -> bool:
    """The probe compares outer keys (cast to `ct`) against the inner
    index's NATIVE key arrays — only exact-domain matches are safe."""
    intk = (TypeKind.INT, TypeKind.UINT, TypeKind.BOOL,
            TypeKind.DATE, TypeKind.DATETIME)
    if ct.kind != inner_ft.kind and not (
            ct.kind in intk and inner_ft.kind in intk):
        return False
    if inner_ft.kind == TypeKind.DECIMAL and ct.scale != inner_ft.scale:
        return False
    return True


# MPP shuffle joins exchange full column payloads between shards, so the
# output columns must be device-representable (int-domain, float, or
# dict-coded strings the host decodes after readback)
_MPP_OUT_KINDS = _DJ_PAYLOAD_KINDS + (TypeKind.STRING,)


def _mpp_join_parts(join: LogicalJoin, pctx: PhysicalContext):
    """Structural + cost gates for the MPP shuffle join; returns
    (probe_l, build_l, p_task, b_task, pk_pos, bk_pos, probe_is_left,
    build_est, copart) with pk_pos/bk_pos as scan-position LISTS, or
    None.  Mirrors TiFlash's MPP eligibility: int-domain equi-keys
    (multi-column inner joins exchange a mix-hash and re-verify true
    equality on device; build keys may be NON-unique — the local join
    is a two-pass count+emit expansion), plain scan[+selection]
    fragments on both sides."""
    if join.kind not in ("inner", "left_outer") or not join.eq_conds \
            or join.other_conds:
        return None
    # multi-column LEFT-OUTER keys are planner-eligible now:
    # the engine composes them EXACTLY (stride packing over both sides'
    # column stats — mpp/exchange.pack_keys_exact), so no probe row can
    # lose its NULL-extension slot to a hash collision; key spaces too
    # wide to pack raise MPPIneligible at run time and take the host rung
    if not pctx.allow_mpp or not pctx.enable_pushdown \
            or pctx.prefer_merge_join:
        return None
    if any(not isinstance(le, ColumnExpr) or not isinstance(re_, ColumnExpr)
           for le, re_ in join.eq_conds):
        return None
    left, right = join.children
    les = [le for le, _ in join.eq_conds]
    res = [re_ for _, re_ in join.eq_conds]
    orders = [(left, right, les, res, True)]
    if join.kind == "inner":
        orders.append((right, left, res, les, False))
    for probe_l, build_l, pks, bks, probe_is_left in orders:
        if not isinstance(probe_l, LogicalDataSource) \
                or not isinstance(build_l, LogicalDataSource):
            continue
        copart = False
        if probe_l.table.is_partitioned or build_l.table.is_partitioned:
            # co-partitioned elision (TiFlash's same-zone optimization):
            # both sides HASH-partitioned on the join key with equal
            # partition counts means partition i of one side can only
            # match partition i of the other — the join runs per
            # partition pair with NO exchange operators.  Inner joins
            # with a single key only: a pruned build partition then
            # simply contributes nothing.  Anything else stays
            # per-partition-store sharded and takes the host lanes.
            copart = (join.kind == "inner" and len(pks) == 1
                      and _co_partitioned(probe_l, pks[0], build_l,
                                          bks[0]))
            if not copart:
                continue
        if any(pk.ftype.kind not in _DJ_KEY_KINDS
               or bk.ftype.kind != pk.ftype.kind
               for pk, bk in zip(pks, bks)):
            continue
        if any(pk.ftype.kind == TypeKind.DECIMAL
               and bk.ftype.scale != pk.ftype.scale
               for pk, bk in zip(pks, bks)):
            continue
        if any(c.ftype.kind not in _MPP_OUT_KINDS
               or (c.ftype.kind == TypeKind.DECIMAL
                   and c.ftype.is_wide_decimal)
               for c in list(probe_l.schema.cols) + list(build_l.schema.cols)):
            continue
        p_task, p_resid = _start_cop(probe_l, pctx)
        if p_task is None or p_resid or p_task.ranges == []:
            continue
        b_task, b_resid = _start_cop(build_l, pctx)
        if b_task is None or b_resid or b_task.ranges == []:
            continue
        if any(not isinstance(x, SelectionIR)
               for x in p_task.dag_execs + b_task.dag_execs):
            continue
        pk_pos = [p_task.scan_pos_map().get(pk.unique_id) for pk in pks]
        bk_pos = [b_task.scan_pos_map().get(bk.unique_id) for bk in bks]
        if any(p is None for p in pk_pos) or any(b is None
                                                 for b in bk_pos):
            continue
        # cost gate: small build sides are served better by the
        # broadcast lookup / host lanes (no exchange); the shuffle wins
        # once the build side is too big to broadcast or hash cheaply
        build_est = _est_rows(
            PhysTableReader(Schema(b_task.scan_cols), b_task, False,
                            build_l.ranges), pctx)
        if not probe_is_left:
            # the reversed order exists so the SMALLER side builds; now
            # that non-unique build keys are legal, never reverse just
            # to get a bigger build side past the broadcast threshold
            probe_est = _est_rows(
                PhysTableReader(Schema(p_task.scan_cols), p_task, False,
                                probe_l.ranges), pctx)
            if build_est > probe_est:
                continue
        if not pctx.enforce_mpp and build_est <= pctx.mpp_threshold:
            continue
        return (probe_l, build_l, p_task, b_task, pk_pos, bk_pos,
                probe_is_left, build_est, copart)
    return None


def _co_partitioned(probe_l, pk, build_l, bk) -> bool:
    """True when both sides are HASH-partitioned ON THE JOIN KEY with
    equal partition counts: rows with equal keys land in same-ordinal
    partitions (the same abs(v) %% N routing on both sides), so the
    exchange pair is provably unnecessary."""
    pi = probe_l.table.partition_info
    bi = build_l.table.partition_info
    if pi is None or bi is None:
        return False
    if pi.kind != "hash" or bi.kind != "hash" or len(pi.defs) != len(bi.defs):
        return False

    def key_is_part_col(ds, key, info):
        col = next((c for c in ds.schema.cols
                    if c.uid == key.unique_id), None)
        return (col is not None
                and col.name.lower() == info.column.lower())

    return (key_is_part_col(probe_l, pk, pi)
            and key_is_part_col(build_l, bk, bi))


def _mpp_reason(pctx: PhysicalContext, build_est: float) -> str:
    if pctx.enforce_mpp and build_est <= pctx.mpp_threshold:
        return "enforced"
    return f"build est {build_est:.0f} > broadcast threshold"


def _mpp_exchange_pair(probe_l, build_l, p_task, b_task, pk_pos, bk_pos,
                       probe_is_left, elided: bool = False):
    """(left, right) fragment plans in schema order: sender/receiver
    pairs normally, bare co-partitioned scans when the exchange is
    elided (no exchange operators in the plan at all)."""
    p_sender = PhysExchangeSender(Schema(p_task.scan_cols), p_task, pk_pos,
                                  ranges=probe_l.ranges, elided=elided)
    b_sender = PhysExchangeSender(Schema(b_task.scan_cols), b_task, bk_pos,
                                  ranges=build_l.ranges, elided=elided)
    if elided:
        left, right = ((p_sender, b_sender) if probe_is_left
                       else (b_sender, p_sender))
        return left, right
    p_recv = PhysExchangeReceiver(p_sender)
    b_recv = PhysExchangeReceiver(b_sender)
    if probe_is_left:
        return p_recv, b_recv
    return b_recv, p_recv


def _try_mpp_join(plan: LogicalJoin,
                  pctx: PhysicalContext) -> Optional[PhysicalPlan]:
    """Join(big scan, big unique-key scan) -> device-resident shuffle
    join: ExchangeSender/Receiver pair per side under one PhysMPPJoin."""
    parts = _mpp_join_parts(plan, pctx)
    if parts is None:
        return None
    (probe_l, build_l, p_task, b_task, pk_pos, bk_pos, probe_is_left,
     build_est, copart) = parts
    left_l, right_l = plan.children
    want = [c.uid for c in list(left_l.schema.cols)
            + list(right_l.schema.cols)]
    if [c.uid for c in plan.schema.cols] != want:
        return None  # schema is not the plain left++right concatenation
    left_recv, right_recv = _mpp_exchange_pair(
        probe_l, build_l, p_task, b_task, pk_pos, bk_pos, probe_is_left,
        elided=copart)
    lmap = {c.uid: i for i, c in enumerate(left_l.schema.cols)}
    rmap = {c.uid: i for i, c in enumerate(right_l.schema.cols)}
    return PhysMPPJoin(
        left_recv, right_recv, plan.kind, probe_is_left, plan.schema,
        [le.remap_columns(lmap) for le, _ in plan.eq_conds],
        [re_.remap_columns(rmap) for _, re_ in plan.eq_conds],
        reason=_mpp_reason(pctx, build_est), elided=copart)


#: the pair lane's grouped-pushdown ceiling: above this estimated group
#: count the compacted (key, state) all_gather stops paying for itself
#: and the generic plan (device join + host agg over joined rows) serves
#: better.  The join tree's limit follows the card (mpp.engine.group_limit)
MPP_GROUP_BUDGET_MAX = 1 << 15
MPP_GROUP_BUDGET_MIN = 1 << 10


def _mpp_grouped_enabled() -> bool:
    from ..mpp.engine import grouped_pushdown_enabled

    return grouped_pushdown_enabled()


def _mpp_group_ndv(p_task, b_task, group_by, pctx) -> float:
    """Estimated distinct-group count of a GROUP BY over the join:
    product of per-key ANALYZEd NDVs (plain columns resolve against the
    owning side's stats; computed keys guess 100, the _group_ndv
    default)."""
    ndv = 1.0
    for g in group_by:
        got = None
        if isinstance(g, ColumnExpr) and g.unique_id >= 0 \
                and pctx.stats is not None:
            for task in (p_task, b_task):
                sc = next((c for c in task.scan_cols
                           if c.uid == g.unique_id), None)
                if sc is None:
                    continue
                st = pctx.stats.get(task.table.id)
                cs = st.columns.get(sc.store_offset) if st else None
                if cs is not None and cs.ndv > 0:
                    got = float(cs.ndv)
                break
        ndv *= got if got is not None else 100.0
    return ndv


def _try_mpp_join_agg(plan: LogicalAggregation, join: LogicalJoin,
                      pctx: PhysicalContext) -> Optional[PhysicalPlan]:
    """Aggregation over an MPP-eligible inner join -> the partial
    aggregation runs inside the exchange program and a FINAL HashAgg
    merges.  Scalar aggs psum-merge on device (G=1 partials leave);
    GROUP BY sort-groups per shard inside a planner-budgeted group
    capacity and merges partials ACROSS shards on device, so only O(G)
    group rows leave — the "partial partial aggregates" regime.  The
    group-cardinality gate keeps exploding GROUP BYs on the generic
    plan; runtime overflow falls back through the agg-peel rung."""
    if not plan.aggs or join.kind != "inner":
        return None
    grouped = bool(plan.group_by)
    if grouped and not _mpp_grouped_enabled():
        return None
    parts = _mpp_join_parts(join, pctx)
    if parts is None:
        return None
    (probe_l, build_l, p_task, b_task, pk_pos, bk_pos, probe_is_left,
     build_est, copart) = parts
    if not probe_is_left:
        return None  # host-rung partial layout assumes probe==left
    budget = 0
    if grouped:
        est_g = _mpp_group_ndv(p_task, b_task, plan.group_by, pctx)
        if est_g > MPP_GROUP_BUDGET_MAX:
            return None  # group cardinality too large to pay for itself
        budget = int(min(max(2.0 * est_g, MPP_GROUP_BUDGET_MIN),
                         MPP_GROUP_BUDGET_MAX))
    if grouped and copart:
        # per-pair grouped partials merge at the final HashAgg anyway,
        # but each pair would budget G independently; keep the elided
        # path on the scalar/row shapes it is tested for and let the
        # grouped plan ride the generic per-pair host merge
        return None
    from ..expr.pushdown import can_push_agg, can_push_expr

    dict_uids = _dict_uids(probe_l, pctx) | _dict_uids(build_l, pctx)
    probe_uids = {c.uid for c in probe_l.schema.cols}
    build_pos = {c.uid: i for i, c in enumerate(build_l.schema.cols)}
    wp = len(p_task.scan_cols)
    mapping = dict(p_task.scan_pos_map())
    for u, i in build_pos.items():
        mapping[u] = wp + i
    group_by = []
    for g in plan.group_by:
        refs: set = set()
        g.collect_columns(refs)
        if any(u not in probe_uids and u not in build_pos for u in refs):
            return None
        remappable = can_remap_group_key(g, dict_uids)
        if not (can_push_expr(g, pctx.pushdown_blacklist, dict_uids)
                or _is_plain_col(g) or remappable):
            return None
        if (g.ftype.kind == TypeKind.STRING
                and not isinstance(g, ColumnExpr) and not remappable):
            # computed STRING keys lower via dict-code re-mapping
            #; anything else still needs
            # a store column for the dict decode
            return None
        group_by.append(g.remap_columns(mapping))
    aggs = []
    for a in plan.aggs:
        if a.name not in ("count", "sum", "avg", "min", "max") \
                or a.distinct:
            return None
        if not can_push_agg(a, pctx.pushdown_blacklist, dict_uids):
            return None
        refs = set()
        for x in a.args:
            x.collect_columns(refs)
        if any(u not in probe_uids and u not in build_pos for u in refs):
            return None
        if any(x.ftype.kind == TypeKind.STRING for x in a.args):
            return None  # dict codes don't aggregate
        aggs.append(a.remap_columns(mapping))
    left_recv, right_recv = _mpp_exchange_pair(
        probe_l, build_l, p_task, b_task, pk_pos, bk_pos, probe_is_left,
        elided=copart)
    lmap = {c.uid: i for i, c in enumerate(probe_l.schema.cols)}
    rmap = {c.uid: i for i, c in enumerate(build_l.schema.cols)}
    mpp = PhysMPPJoin(
        left_recv, right_recv, "inner", True, _partial_schema(plan),
        [le.remap_columns(lmap) for le, _ in join.eq_conds],
        [re_.remap_columns(rmap) for _, re_ in join.eq_conds],
        aggs=aggs, group_by=group_by or None, group_budget=budget,
        reason=_mpp_reason(pctx, build_est), elided=copart)
    fin_gb = [ColumnExpr(i, g.ftype, str(g), -1)
              for i, g in enumerate(plan.group_by)]
    return PhysHashAgg(mpp, fin_gb, plan.aggs, True, plan.schema)


def _physical_join(plan: LogicalJoin, pctx: PhysicalContext) -> PhysicalPlan:
    if not pctx.prefer_merge_join:
        # tidb_enforce_mpp pins the exchange engine whenever structurally
        # eligible — it outranks the index-join cost choice too
        if pctx.enforce_mpp:
            mpp = _try_mpp_join(plan, pctx)
            if mpp is not None:
                return mpp
        ij = _try_index_join(plan, pctx)
        if ij is not None:
            return ij
        if not pctx.enforce_mpp:
            mpp = _try_mpp_join(plan, pctx)
            if mpp is not None:
                return mpp
        # multi-way join trees / decorrelated semi-anti filter rungs:
        # the join-tree compiler keeps the whole ladder device-resident
        from .jointree import try_jointree

        jt = try_jointree(plan, pctx)
        if jt is not None:
            return jt
    left = to_physical(plan.children[0], pctx)
    right = to_physical(plan.children[1], pctx)
    lmap = left.schema.position_map()
    rmap = right.schema.position_map()
    lkeys, rkeys = [], []
    for le, re in plan.eq_conds:
        ct = common_compare_type(le.ftype, re.ftype)
        le2 = _maybe_cast(le.remap_columns(lmap), ct)
        re2 = _maybe_cast(re.remap_columns(rmap), ct)
        lkeys.append(le2)
        rkeys.append(re2)
    # other conds evaluate over left++right layout
    pair_map = dict(lmap)
    off = len(left.schema)
    for uid, i in rmap.items():
        pair_map[uid] = off + i
    others = [c.remap_columns(pair_map) for c in plan.other_conds]
    if plan.kind == "inner":
        build_right = _est_rows(right, pctx) <= _est_rows(left, pctx)
    else:
        build_right = True  # outer/semi: probe must be the left side
    if not plan.eq_conds and not plan.other_conds and \
            plan.kind in ("semi", "anti_semi"):
        # EXISTS with no correlation: keys empty -> every probe row matches
        # iff build side non-empty; HashJoinExec handles empty key lists.
        pass
    if (pctx.prefer_merge_join and plan.eq_conds
            and plan.kind in ("inner", "left_outer", "semi", "anti_semi")):
        # sort-merge join: inject explicit sorts on the join keys (the
        # merge exec requires ascending key order); preserves left order
        # through the join (merge_join.go's keep-order property)
        left_s = PhysSort(left, [(k, False) for k in lkeys])
        right_s = PhysSort(right, [(k, False) for k in rkeys])
        return PhysMergeJoin(left_s, right_s, plan.kind, lkeys, rkeys,
                             others, plan.schema)
    rf = _attach_runtime_filter(
        plan.kind, left, right, lkeys, rkeys, build_right, pctx
    )
    rf_key, rf_id = rf if rf is not None else (None, 0)
    return PhysHashJoin(left, right, plan.kind, lkeys, rkeys, others,
                        build_right, plan.schema, rf_build_key=rf_key,
                        rf_filter_id=rf_id)


def _attach_runtime_filter(kind, left, right, lkeys, rkeys, build_right,
                           pctx) -> Optional[Tuple[int, int]]:
    """Device semi-join probe (runtime filter): when the probe side is a
    plain cop scan and a join key is device-eligible, append a JoinProbeIR
    to the probe DAG — the hash join ships its build-side distinct keys to
    the device so non-matching fact rows die before reaching the host.

    The device analog of index_lookup_join.go building inner requests from
    outer rows; only row-reducing join kinds qualify (inner/semi — outer
    and anti joins need the non-matching probe rows too)."""
    if kind not in ("inner", "semi"):
        return None
    if not pctx.enable_pushdown:
        return None
    probe = left if build_right else right
    build = right if build_right else left
    pkeys = lkeys if build_right else rkeys
    if not isinstance(probe, PhysTableReader) or not pkeys:
        return None
    # size gate: shipping + deduping a huge build key set costs more than it
    # filters; only worth it when the build side is clearly the small side
    build_est = _est_rows(build, pctx)
    probe_est = _est_rows(probe, pctx)
    if build_est > 2_000_000 or build_est > 0.5 * max(probe_est, 1):
        return None
    # DAG must end at scan [+ selections]: a probe after agg/topn/proj is
    # not row-aligned with the scan
    from ..copr.ir import JoinProbeIR

    if any(not isinstance(ex, (SelectionIR, JoinProbeIR))
           for ex in probe.dag.executors[1:]):
        return None
    from ..expr.pushdown import can_push_expr

    # dict encoding lives on PHYSICAL stores: a partitioned probe's scan
    # carries the logical id, which has no storage — resolve through the
    # first range's physical id (encoding is uniform per column family)
    try:
        store_tid = probe.ranges[0].table_id if probe.ranges \
            else probe.dag.scan.table_id
        dict_cols = {
            i for i, ci in enumerate(probe.dag.scan.columns)
            if ci in pctx.storage.table(store_tid).dict_encoded_cols()
        }
    except KVError:
        return None  # no physical store reachable: skip the filter
    from ..copr.ir import deserialize_expr, serialize_expr

    for i, pk in enumerate(pkeys):
        if pk.ftype.kind == TypeKind.STRING:
            continue  # dict codes are store-local; skip string keys
        # strip planner uids: IR exprs address scan-output POSITIONS
        pk_pos = deserialize_expr(serialize_expr(pk))
        cols: set = set()
        pk_pos.collect_columns(cols)
        if any(c >= len(probe.dag.scan.columns) for c in cols):
            continue
        if not can_push_expr(pk_pos, pctx.pushdown_blacklist, dict_cols):
            continue
        # unique per reader: a second join filtering the same scan gets its
        # own aux slot instead of colliding on probe_keys_0
        fid = sum(1 for ex in probe.dag.executors
                  if isinstance(ex, JoinProbeIR))
        probe.dag.executors.append(JoinProbeIR(pk_pos, filter_id=fid))
        return i, fid
    return None


def _key_ndv(child: PhysicalPlan, key, child_rows: float,
             pctx: PhysicalContext):
    """ANALYZEd NDV of a plain-column join key, capped by the child's
    estimated output rows (filters cannot increase distinct count); None
    when no stats reach the key."""
    if not isinstance(key, ColumnExpr) or key.unique_id < 0:
        return None
    node = child
    while isinstance(node, (PhysSelection, PhysSort, PhysExchangeReceiver)):
        node = node.children[0]
    if not isinstance(node, PhysTableReader) or pctx.stats is None:
        return None
    sc = next((c for c in node.cop.scan_cols if c.uid == key.unique_id),
              None)
    st = pctx.stats.get(node.cop.table.id)
    if sc is None or st is None:
        return None
    cs = st.columns.get(sc.store_offset)
    if cs is None or cs.ndv <= 0:
        return None
    return max(min(float(cs.ndv), child_rows), 1.0)


def _cop_selectivity(p: "PhysTableReader", conds, pctx) -> float:
    """Histogram-backed selectivity for pushed conds; conds' ColumnExprs are
    remapped (by uid) onto STORE column offsets for the stats lookup."""
    if pctx.stats is None:
        return 0.25 ** min(len(conds), 2)
    offmap = {c.uid: c.store_offset for c in p.cop.scan_cols}
    remapped = [c.remap_columns(offmap) for c in conds]
    return pctx.stats.estimate_selectivity(p.cop.table.id, remapped)


def _est_rows(p: PhysicalPlan, pctx: PhysicalContext) -> float:
    if isinstance(p, PhysTableReader):
        st = pctx.stats.get(p.cop.table.id) if pctx.stats else None
        if st is not None:
            rows = float(st.row_count)
        else:
            rows = 0.0
            for pid in {kr.table_id for kr in p.ranges}:
                store = pctx.storage.table(pid)
                rows += store.base_rows + len(store.delta)
        for ex in p.dag.executors[1:]:
            if isinstance(ex, SelectionIR):
                rows *= _cop_selectivity(p, ex.conditions, pctx)
            elif isinstance(ex, (TopNIR, LimitIR)):
                rows = min(rows, ex.limit)
            elif isinstance(ex, AggregationIR):
                ndv = _group_ndv(p, ex, pctx)
                rows = max(min(rows, ndv), 1)
        return rows
    if isinstance(p, (PhysSelection,)):
        return _est_rows(p.children[0], pctx) * 0.25
    if isinstance(p, (PhysLimit, PhysTopN)):
        return min(_est_rows(p.children[0], pctx), p.limit)
    if isinstance(p, PhysHashAgg):
        if p.partial_input:
            # child already emits one row per (shard, group); the final
            # merge keeps roughly the group count
            return max(_est_rows(p.children[0], pctx), 1)
        return max(_est_rows(p.children[0], pctx) * 0.1, 1)
    if isinstance(p, PhysMPPJoinTree):
        if p.aggs is not None:
            if p.group_by:
                return float(max(p.group_budget, 1))
            return 1.0
        return max(float(p.rungs[-1]["est"]) if p.rungs else 1.0, 1.0)
    if isinstance(p, PhysMPPJoin):
        if p.aggs is not None:
            if p.group_by:
                # grouped partials: at most the planner's group budget
                return float(max(p.group_budget, 1))
            return 1.0  # scalar partial: one G=1 partial row
        l = _est_rows(p.children[0], pctx)
        r = _est_rows(p.children[1], pctx)
        if p.left_keys and p.right_keys:
            nl = _key_ndv(p.children[0], p.left_keys[0], l, pctx)
            nr = _key_ndv(p.children[1], p.right_keys[0], r, pctx)
            if nl is not None and nr is not None:
                est = l * r / max(nl, nr, 1.0)
                if p.kind == "left_outer":
                    est = max(est, l)
                return max(est, 1.0)
        return max(l, r)
    if isinstance(p, PhysHashJoin):
        l = _est_rows(p.children[0], pctx)
        r = _est_rows(p.children[1], pctx)
        if p.kind in ("semi", "anti_semi", "left_outer_semi"):
            return l
        # equi-join output from key NDVs: |L ⋈ R| = |L|·|R| / max(ndv_l,
        # ndv_r) (the classic System-R containment assumption, the
        # reference's statistics join estimation) — fixed-fraction
        # heuristics only when no ANALYZEd NDV reaches the key
        if p.left_keys and p.right_keys:
            nl = _key_ndv(p.children[0], p.left_keys[0], l, pctx)
            nr = _key_ndv(p.children[1], p.right_keys[0], r, pctx)
            if nl is not None and nr is not None:
                est = l * r / max(nl, nr, 1.0)
                if p.kind == "left_outer":
                    est = max(est, l)
                return max(est, 1.0)
        return max(l, r)  # FK-join heuristic (no usable key stats)
    if isinstance(p, PhysIndexJoin):
        o = _est_rows(p.children[0], pctx)
        if p.kind in ("semi", "anti_semi"):
            return o
        return max(o, 1.0)  # FK lookup: ~one inner row per outer row
    if isinstance(p, PhysBatchPointGet):
        return float(max(len(p.keys), 1))
    if isinstance(p, (PhysIndexLookUp, PhysIndexReader)):
        if isinstance(p, PhysIndexLookUp) and p.point_get:
            return 1.0
        store = pctx.storage.table(p.table.id)
        total = float(store.base_rows + len(store.delta))
        if pctx.stats is not None:
            offmap = {c.uid: c.store_offset for c in p.schema.cols}
            remapped = [c.remap_columns(offmap) for c in p.all_conds]
            return max(
                pctx.stats.estimate_selectivity(p.table.id, remapped) * total,
                1.0,
            )
        return max(total * 0.01, 1.0)
    if isinstance(p, PhysUnionScan):
        total = 0.0
        for pid in p.table.physical_ids():
            store = pctx.storage.table(pid)
            total += store.base_rows + len(store.delta)
        return total
    if isinstance(p, PhysUnion):
        return sum(_est_rows(c, pctx) for c in p.children)
    if p.children:
        return _est_rows(p.children[0], pctx)
    return 1.0


def _group_ndv(p: "PhysTableReader", agg_ir: AggregationIR, pctx) -> float:
    if pctx.stats is None:
        return 100.0
    st = pctx.stats.get(p.cop.table.id)
    if st is None:
        return 100.0
    ndv = 1.0
    offmap = {i: c.store_offset for i, c in enumerate(p.cop.scan_cols)}
    for g in agg_ir.group_by:
        if isinstance(g, ColumnExpr) and g.index in offmap:
            cs = st.columns.get(offmap[g.index])
            ndv *= cs.ndv if cs else 100.0
        else:
            ndv *= 100.0
    return ndv


def annotate_estimates(p: PhysicalPlan, pctx: PhysicalContext):
    """Fill est_rows on every node for EXPLAIN (stats.go row counts)."""
    try:
        p.est_rows = _est_rows(p, pctx)
    except Exception:
        p.est_rows = None
    for c in p.children:
        annotate_estimates(c, pctx)


def _is_plain_col(e: Expression) -> bool:
    return isinstance(e, ColumnExpr)


def _maybe_cast(e: Expression, target: FieldType) -> Expression:
    if e.ftype.kind == target.kind and e.ftype.scale == target.scale:
        return e
    return ScalarFunc("cast", [e], target.with_nullable(e.ftype.nullable),
                      {"target": target.with_nullable(e.ftype.nullable)})


def _remap(exprs: List[Expression], schema: Schema) -> List[Expression]:
    pos = schema.position_map()
    for e in exprs:
        used: set = set()
        e.collect_columns(used)
        missing = used - pos.keys()
        if missing:
            raise PlanError(
                f"column uid(s) {sorted(missing)} not in child schema for "
                f"expr {e}"
            )
    return [e.remap_columns(pos) for e in exprs]


def explain_text(p: PhysicalPlan) -> str:
    lines = p.explain_tree()
    w1 = max(len(l[0]) for l in lines) + 2
    w2 = max(len(l[1]) for l in lines) + 2
    w3 = max(len(l[2]) for l in lines) + 2
    return "\n".join(
        f"{a:<{w1}}{b:<{w2}}{c:<{w3}}{d}" for a, b, c, d in lines
    )

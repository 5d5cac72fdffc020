"""Join-tree compiler: n-way equi-join graphs -> device rung ladders.

The planning half of join-tree compilation.  TPC-H is join TREES — Q2/Q5/
Q7/Q8/Q9 join 4-8 tables — but the two-table MPP lane
(physical._try_mpp_join) only fires when BOTH children are scans, so
multi-way joins fell back to host rungs.  This module:

1. collects a maximal inner-join GROUP whose members are all
   MPP-eligible scan fragments, plus the semi / anti-semi / left-outer
   joins stacked above it (decorrelated EXISTS/IN subqueries —
   planner/decorrelate.py — arrive exactly in that shape);
2. chooses a join ORDER from NDV/row-count statistics: exact dynamic
   programming over connected left-deep orders up to ``DP_MAX_RELS``
   relations (Selinger on subsets), the greedy smallest-intermediate
   heuristic beyond;
3. emits a ``PhysMPPJoinTree`` whose executor (mpp/jointree.py) runs
   one exchange/local-join program per rung with the intermediate
   result staying DEVICE-RESIDENT between rungs, and (when the parent
   aggregation is pushable) finishes with the on-device partial
   aggregation so only O(G) rows ever leave the mesh.

EXPLAIN shows the chosen order with est_rows per rung; every structural
decline returns None and the generic lanes (index join, two-table MPP,
host hash join) take over unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..expr.expression import ColumnExpr, Expression
from ..expr.pushdown import (can_push_agg, can_push_expr,
                             can_remap_group_key)
from ..types import TypeKind
from .columns import Schema
from .expr_build import expr_uids as _expr_uids
from .logical import (
    LogicalAggregation,
    LogicalDataSource,
    LogicalJoin,
    LogicalPlan,
    LogicalProjection,
)

#: exact DP join ordering up to this many relations; greedy beyond
DP_MAX_RELS = 8


# ---------------------------------------------------------------------------
# collection: flatten the join tree into group members + filter rungs
# ---------------------------------------------------------------------------


class _Collected:
    """Flattened join tree: inner-group members, their eq edges/other
    conds, and the semi/anti/left-outer joins stacked above the group
    (bottom-up order)."""

    def __init__(self):
        self.members: List[LogicalDataSource] = []
        self.eqs: List[Tuple[Expression, Expression]] = []
        self.others: List[Expression] = []
        # (kind, inner datasource, [(outer_e, inner_e)], other_conds)
        self.filters: List[tuple] = []


def _subst_cols(e: Expression, sub: dict) -> Expression:
    """Replace mapped column uids, leave everything else alone (the
    outer side of a semi-join condition must survive untouched)."""
    if isinstance(e, ColumnExpr):
        return sub.get(e.unique_id, e)
    from ..expr.expression import ScalarFunc

    if isinstance(e, ScalarFunc):
        return ScalarFunc(e.name, [_subst_cols(a, sub) for a in e.args],
                          e.ftype, e.meta)
    return e


def _peel_projection(p: LogicalPlan):
    """A plain-column Projection over a scan (the shape an uncorrelated
    IN subquery's select list leaves behind) is transparent to the join
    graph: return (datasource, {proj uid -> source ColumnExpr})."""
    if not isinstance(p, LogicalProjection) \
            or not isinstance(p.children[0], LogicalDataSource):
        return None
    sub = {}
    for c, e in zip(p.schema.cols, p.exprs):
        if not isinstance(e, ColumnExpr) or e.unique_id < 0:
            return None
        sub[c.uid] = e
    return p.children[0], sub


def _collect(plan: LogicalPlan) -> Optional[_Collected]:
    out = _Collected()
    # peel the filter-join chain (semi/anti/louter applied above FROM)
    filters_top_down = []
    node = plan
    while isinstance(node, LogicalJoin) and node.kind in (
            "semi", "anti_semi", "left_outer"):
        right = node.children[1]
        eqs, others = list(node.eq_conds), list(node.other_conds)
        if not isinstance(right, LogicalDataSource):
            peeled = _peel_projection(right)
            if peeled is None:
                return None
            right, sub = peeled
            eqs = [(le, _subst_cols(re_, sub)) for le, re_ in eqs]
            others = [_subst_cols(c, sub) for c in others]
        filters_top_down.append((node.kind, right, eqs, others))
        node = node.children[0]
    out.filters = list(reversed(filters_top_down))  # bottom-up

    def collect(p):
        if isinstance(p, LogicalJoin) and p.kind == "inner":
            out.eqs.extend(p.eq_conds)
            out.others.extend(p.other_conds)
            for c in p.children:
                collect(c)
        else:
            out.members.append(p)

    collect(node)
    if not all(isinstance(m, LogicalDataSource) for m in out.members):
        return None
    return out


# ---------------------------------------------------------------------------
# per-side eligibility (mirrors physical._mpp_join_parts' gates)
# ---------------------------------------------------------------------------


class _Side:
    """One eligible scan side: the cop task plus uid bookkeeping."""

    def __init__(self, ds: LogicalDataSource, task):
        self.ds = ds
        self.task = task
        self.uid_pos = {c.uid: i for i, c in enumerate(ds.schema.cols)}

    @property
    def table(self):
        return self.ds.table


def _eligible_side(ds: LogicalDataSource, pctx) -> Optional[_Side]:
    from ..copr.ir import SelectionIR
    from .physical import _MPP_OUT_KINDS, _start_cop

    if ds.table.is_partitioned:
        return None  # per-partition stores; the copart lane owns these
    if any(c.ftype.kind not in _MPP_OUT_KINDS
           or (c.ftype.kind == TypeKind.DECIMAL
               and c.ftype.is_wide_decimal)
           for c in ds.schema.cols):
        return None
    task, residual = _start_cop(ds, pctx)
    if task is None or residual or task.ranges == []:
        return None
    if any(not isinstance(x, SelectionIR) for x in task.dag_execs):
        return None
    return _Side(ds, task)


def _side_ndv(side: _Side, uid: int, pctx) -> Optional[float]:
    from .physical import _build_key_unique

    sc = next((c for c in side.ds.schema.cols if c.uid == uid), None)
    if sc is None:
        return None
    st = pctx.stats.get(side.table.id) if pctx.stats is not None else None
    cs = st.columns.get(sc.store_offset) if st else None
    if cs is not None and cs.ndv > 0:
        return float(cs.ndv)
    # unanalyzed: a single-column primary or unique key has as many
    # distinct values as the side has rows
    if _build_key_unique(side.ds, uid):
        return _side_rows(side, pctx)
    return None


def _side_rows(side: _Side, pctx) -> float:
    from .physical import PhysTableReader, _est_rows

    return max(_est_rows(
        PhysTableReader(Schema(side.task.scan_cols), side.task, False,
                        side.ds.ranges), pctx), 1.0)


# ---------------------------------------------------------------------------
# join ordering: DP on connected left-deep orders, greedy beyond
# ---------------------------------------------------------------------------


def _edge_list(members, eqs) -> Optional[List[tuple]]:
    uid_of = {}
    for i, m in enumerate(members):
        for u in m.schema.uids():
            uid_of[u] = i

    def side_of(e):
        us = _expr_uids([e])
        idxs = {uid_of.get(u) for u in us}
        if None in idxs or len(idxs) != 1:
            return None
        return idxs.pop()

    edges = []
    for le, re_ in eqs:
        i, j = side_of(le), side_of(re_)
        if i is None or j is None or i == j:
            return None
        edges.append((i, j, le, re_))
    return edges


def _join_est(rows_built: float, built_idx: set, rows_new: float,
              new_idx: int, edges, ndv_of) -> float:
    """Containment estimate |built ⋈ new|, one division per connecting
    eq edge (capped NDVs: filters cannot raise distinct counts)."""
    est = rows_built * rows_new
    connected = False
    for i, j, le, re_ in edges:
        if (i in built_idx and j == new_idx):
            pair = (le, re_)
        elif (j in built_idx and i == new_idx):
            pair = (re_, le)
        else:
            continue
        connected = True
        bl, nw = pair
        nl = min(ndv_of(bl) or 100.0, rows_built)
        nr = min(ndv_of(nw) or 100.0, rows_new)
        est /= max(nl, nr, 1.0)
    if not connected:
        return -1.0  # cross join: not a candidate
    return max(est, 1.0)


def _order_members(sides: List[_Side], edges, pctx
                   ) -> Optional[Tuple[List[int], List[float]]]:
    """Left-deep join order minimizing the summed intermediate sizes:
    exact DP over connected subsets up to DP_MAX_RELS, greedy beyond.

    Returns (order, per-step estimates): ests[k] is the estimated
    intermediate after joining order[k+1] — the SAME numbers the DP
    costed with, so rung assembly (EXPLAIN est_rows, grouped-agg
    budgets) never re-derives them from a second copy of the
    containment formula."""
    n = len(sides)
    if n == 1:
        return [0], []
    rows = [_side_rows(s, pctx) for s in sides]

    def ndv_of(e):
        if not isinstance(e, ColumnExpr) or e.unique_id < 0:
            return None
        for s in sides:
            if e.unique_id in s.uid_pos:
                return _side_ndv(s, e.unique_id, pctx)
        return None

    if n <= DP_MAX_RELS:
        # best[frozenset] = (cost, rows, order, ests): Selinger over
        # left-deep connected extensions
        best = {frozenset([i]): (0.0, rows[i], (i,), ()) for i in range(n)}
        for _size in range(1, n):
            nxt = {}
            for subset, (cost, r, order, ests) in best.items():
                if len(subset) != _size:
                    continue
                for j in range(n):
                    if j in subset:
                        continue
                    est = _join_est(r, subset, rows[j], j, edges, ndv_of)
                    if est < 0:
                        continue
                    key = subset | {j}
                    cand = (cost + est, est, order + (j,), ests + (est,))
                    cur = nxt.get(key)
                    if cur is None or cand[0] < cur[0]:
                        nxt[key] = cand
            best.update(nxt)
        full = best.get(frozenset(range(n)))
        if full is None:
            return None  # disconnected graph: cross joins stay host
        return list(full[2]), list(full[3])

    # greedy: start from the smallest member, repeatedly add the
    # connected member minimizing the estimated intermediate
    order = [min(range(n), key=lambda i: rows[i])]
    joined = set(order)
    cur_rows = rows[order[0]]
    step_ests: List[float] = []
    while len(order) < n:
        cands = []
        for j in range(n):
            if j in joined:
                continue
            est = _join_est(cur_rows, joined, rows[j], j, edges, ndv_of)
            if est >= 0:
                cands.append((est, j))
        if not cands:
            return None
        est, j = min(cands)
        joined.add(j)
        order.append(j)
        step_ests.append(est)
        cur_rows = est
    return order, step_ests


# ---------------------------------------------------------------------------
# rung assembly
# ---------------------------------------------------------------------------


_TREE_KEY_KINDS = (TypeKind.INT, TypeKind.UINT, TypeKind.DECIMAL,
                   TypeKind.DATE)


def _key_ok(le: Expression, re_: Expression) -> bool:
    if not isinstance(le, ColumnExpr) or not isinstance(re_, ColumnExpr):
        return False
    if le.ftype.kind not in _TREE_KEY_KINDS \
            or re_.ftype.kind != le.ftype.kind:
        return False
    if le.ftype.kind == TypeKind.DECIMAL \
            and le.ftype.scale != re_.ftype.scale:
        return False
    return True


class _TreePlan:
    """The assembled ladder, pre-physical: sides in join order, rung
    dicts, slot bookkeeping."""

    def __init__(self):
        self.sides: List[_Side] = []
        self.rungs: List[dict] = []
        self.slot_of: dict = {}       # uid -> slot
        self.slot_src: List[Tuple[int, int]] = []
        self.slot_ftypes: list = []
        self.dict_uids: set = set()


def _assemble(col: _Collected, pctx) -> Optional[_TreePlan]:
    from .physical import _dict_uids

    member_sides = []
    for m in col.members:
        s = _eligible_side(m, pctx)
        if s is None:
            return None
        member_sides.append(s)
    filter_sides = []
    for kind, ds, eqs, others in col.filters:
        if kind == "left_outer" and len(eqs) > 1:
            # multi-key louter candidates come from the collision-prone
            # mix-hash; dropping a collision pair would still emit a
            # spurious NULL-extended row (keep=out_valid), so this
            # shape stays host — the same gate the two-table lane
            # applies when exact key packing doesn't cover the space
            return None
        if kind == "left_outer" and others:
            # push build-side-only ON conds into the inner scan (sound
            # for LEFT JOIN: they only restrict which inner rows match);
            # anything referencing the outer side keeps the host lane
            ruids = set(ds.schema.uids())
            duids = _dict_uids(ds, pctx)
            for c in others:
                if not (_expr_uids([c]) <= ruids) or not can_push_expr(
                        c, pctx.pushdown_blacklist, duids):
                    return None
            # identity-dedupe: _assemble may run more than once over the
            # SAME logical nodes (agg lane declines after assembly, the
            # rows lane retries) — never stack the same cond twice
            ds.pushed_conds.extend(
                c for c in others
                if not any(c is p for p in ds.pushed_conds))
            others = []
        s = _eligible_side(ds, pctx)
        if s is None:
            return None
        filter_sides.append((kind, s, eqs, others))

    edges = _edge_list(col.members, col.eqs)
    if edges is None:
        return None
    for _i, _j, le, re_ in edges:
        if not _key_ok(le, re_):
            return None
    for kind, s, eqs, _o in filter_sides:
        if not eqs and kind in ("semi", "anti_semi"):
            return None  # uncorrelated EXISTS: host lane
        for oe, ie in eqs:
            if not _key_ok(oe, ie):
                return None

    ordered = _order_members(member_sides, edges, pctx)
    if ordered is None:
        return None
    # one formula drives ordering AND EXPLAIN/budget estimates: the DP's
    # per-step numbers ARE the rung est_rows (jointree follow-up (f))
    order, step_ests = ordered

    tp = _TreePlan()
    dict_all: set = set()
    for m in col.members:
        dict_all |= _dict_uids(m, pctx)
    for _k, s, _e, _o in filter_sides:
        dict_all |= _dict_uids(s.ds, pctx)
    tp.dict_uids = dict_all

    def add_slots(side: _Side, ordinal: int):
        for pos, c in enumerate(side.ds.schema.cols):
            tp.slot_of[c.uid] = len(tp.slot_src)
            tp.slot_src.append((ordinal, pos))
            tp.slot_ftypes.append(c.ftype)

    rows = [_side_rows(s, pctx) for s in member_sides]

    base = member_sides[order[0]]
    tp.sides.append(base)
    add_slots(base, 0)
    placed_eq = [False] * len(edges)
    placed_other = [False] * len(col.others)
    built_idx = {order[0]}
    built_uids = set(base.ds.schema.uids())
    cur_rows = rows[order[0]]
    for step, mi in enumerate(order[1:]):
        side = member_sides[mi]
        ordinal = len(tp.sides)
        keys = []
        for k, (i, j, le, re_) in enumerate(edges):
            if placed_eq[k]:
                continue
            if i in built_idx and j == mi:
                keys.append((le, re_))
                placed_eq[k] = True
            elif j in built_idx and i == mi:
                keys.append((re_, le))
                placed_eq[k] = True
        if not keys:
            return None  # cross-join rung: host lane
        est = step_ests[step]
        muids = set(side.ds.schema.uids())
        avail = built_uids | muids
        oth = []
        for k, c in enumerate(col.others):
            if placed_other[k]:
                continue
            if _expr_uids([c]) <= avail:
                if not can_push_expr(c, pctx.pushdown_blacklist,
                                     dict_all):
                    return None
                oth.append(c)
                placed_other[k] = True
        rung = {
            "side": ordinal,
            "kind": "inner",
            "left_uids": [le.unique_id for le, _ in keys],
            "build_pos": [side.uid_pos[re_.unique_id]
                          for _, re_ in keys],
            "others": oth,
            "build_width": len(side.ds.schema.cols),
            "est": est,
        }
        tp.sides.append(side)
        tp.rungs.append(rung)
        add_slots(side, ordinal)
        built_idx.add(mi)
        built_uids = avail
        cur_rows = est
    if not all(placed_eq) or not all(placed_other):
        return None

    # filter rungs (bottom-up order preserved)
    for kind, s, eqs, others in filter_sides:
        ordinal = len(tp.sides)
        muids = set(s.ds.schema.uids())
        for oe, _ie in eqs:
            if oe.unique_id not in built_uids:
                return None
        for c in others:
            refs = _expr_uids([c])
            if not refs <= (built_uids | muids):
                return None
            if not can_push_expr(c, pctx.pushdown_blacklist, dict_all):
                return None
        est = cur_rows if kind == "left_outer" else max(cur_rows * 0.5,
                                                        1.0)
        rung = {
            "side": ordinal,
            "kind": kind,
            "left_uids": [oe.unique_id for oe, _ in eqs],
            "build_pos": [s.uid_pos[ie.unique_id] for _, ie in eqs],
            "others": list(others),
            "build_width": len(s.ds.schema.cols),
            "est": est,
        }
        tp.sides.append(s)
        tp.rungs.append(rung)
        if kind == "left_outer":
            add_slots(s, ordinal)
        built_uids = built_uids | (muids if kind == "left_outer"
                                   else set())
        cur_rows = est
    return tp


def _remap_pair(e: Expression, tp: _TreePlan, rung: dict,
                side: _Side) -> Expression:
    """uid expr -> pair-layout positions: built slots, build side cols
    at n_slots+pos (the rung program's evaluation layout)."""
    n_slots = _n_slots_before(tp, rung)
    mapping = dict(tp.slot_of)
    for uid, pos in side.uid_pos.items():
        mapping[uid] = n_slots + pos
    return e.remap_columns(mapping)


def _n_slots_before(tp: _TreePlan, rung: dict) -> int:
    n = len(tp.sides[0].ds.schema.cols)
    for r in tp.rungs:
        if r is rung:
            break
        if r["kind"] in ("inner", "left_outer"):
            n += r["build_width"]
    return n


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _tree_gate(col: Optional[_Collected], pctx) -> bool:
    if col is None:
        return False
    if not pctx.allow_mpp or not pctx.enable_pushdown \
            or pctx.prefer_merge_join:
        return False
    if len(col.members) >= 3:
        return True
    # smaller ladders only when a decorrelated filter rung makes the
    # device the only lane that keeps the subquery off the host
    return bool(col.filters)


def try_jointree(plan: LogicalJoin, pctx):
    """Rows-mode ladder: Join tree -> PhysMPPJoinTree emitting joined
    rows.  None when ineligible (generic lanes take over)."""
    col = _collect(plan)
    if not _tree_gate(col, pctx):
        return None
    tp = _assemble(col, pctx)
    if tp is None:
        return None
    out_slots, out_ftypes = [], []
    for c in plan.schema.cols:
        slot = tp.slot_of.get(c.uid)
        if slot is None:
            return None
        out_slots.append(slot)
        out_ftypes.append(c.ftype)
    return _phys_tree(tp, pctx, plan.schema, out_slots, out_ftypes)


def try_jointree_agg(plan: LogicalAggregation, join: LogicalPlan, pctx):
    """Aggregation over a join tree -> the partial aggregation runs in
    the ladder's final on-device phase; a FINAL HashAgg merges."""
    group_by, aggs = list(plan.group_by), list(plan.aggs)
    if isinstance(join, LogicalProjection):
        sub = {c.uid: e for c, e in zip(join.schema.cols, join.exprs)}
        from .rules import _substitute

        child = join.children[0]
        if not isinstance(child, LogicalJoin):
            return None
        g2, a2 = [], []
        for g in group_by:
            s = _substitute(g, sub)
            if s is None:
                return None
            g2.append(s)
        for a in aggs:
            from ..expr.aggregation import AggDesc

            args = []
            for x in a.args:
                s = _substitute(x, sub)
                if s is None:
                    return None
                args.append(s)
            a2.append(AggDesc(a.name, args, a.distinct, a.ftype))
        group_by, aggs, join = g2, a2, child
    if not isinstance(join, LogicalJoin) or not aggs:
        return None
    col = _collect(join)
    if not _tree_gate(col, pctx):
        return None
    tp = _assemble(col, pctx)
    if tp is None:
        return None

    from .physical import (MPP_GROUP_BUDGET_MIN, _is_plain_col,
                           _mpp_grouped_enabled, _partial_schema)

    grouped = bool(group_by)
    if grouped and not _mpp_grouped_enabled():
        return None
    all_uids = set(tp.slot_of)
    for g in group_by:
        if not (_expr_uids([g]) <= all_uids):
            return None
        if not (can_push_expr(g, pctx.pushdown_blacklist, tp.dict_uids)
                or _is_plain_col(g)
                or can_remap_group_key(g, tp.dict_uids)):
            return None
        if (g.ftype.kind == TypeKind.STRING
                and not isinstance(g, ColumnExpr)
                and not can_remap_group_key(g, tp.dict_uids)):
            return None
    for a in aggs:
        if a.name not in ("count", "sum", "avg", "min", "max") \
                or a.distinct:
            return None
        if not can_push_agg(a, pctx.pushdown_blacklist, tp.dict_uids):
            return None
        if not (_expr_uids(a.args) <= all_uids):
            return None
        if any(x.ftype.kind == TypeKind.STRING for x in a.args):
            return None  # dict codes don't aggregate
    budget = 0
    if grouped:
        est_rows = tp.rungs[-1]["est"] if tp.rungs else 1.0
        est_g = 1.0
        for g in group_by:
            got = None
            if isinstance(g, ColumnExpr) and g.unique_id >= 0:
                for s in tp.sides:
                    if g.unique_id in s.uid_pos:
                        got = _side_ndv(s, g.unique_id, pctx)
                        break
            est_g *= got if got is not None else 100.0
        # correlated keys (Q3's l_orderkey, o_orderdate) make the NDV
        # product wildly pessimistic: groups cannot exceed joined rows
        est_g = min(est_g, 2.0 * max(est_rows, 1.0))
        # the estimate only seeds the final's capacity: the ladder bounds
        # it by the rows it joined and by the card's group limit
        # (mpp.engine.group_limit), and regrows it on the card when the
        # groups outrun it
        budget = int(max(2.0 * est_g, MPP_GROUP_BUDGET_MIN))

    # agg exprs remap onto the slot layout
    slot_map = dict(tp.slot_of)
    gb = [g.remap_columns(slot_map) for g in group_by]
    from ..expr.aggregation import AggDesc

    ag = [AggDesc(a.name, [x.remap_columns(slot_map) for x in a.args],
                  a.distinct, a.ftype) for a in aggs]
    partial = _partial_schema(plan)
    phys = _phys_tree(tp, pctx, partial,
                      list(range(len(tp.slot_src))),
                      list(tp.slot_ftypes),
                      aggs=ag, group_by=gb or None, group_budget=budget)
    if phys is None:
        return None
    from .physical import PhysHashAgg

    fin_gb = [ColumnExpr(i, g.ftype, str(g), -1)
              for i, g in enumerate(plan.group_by)]
    return PhysHashAgg(phys, fin_gb, plan.aggs, True, plan.schema)


def _phys_tree(tp: _TreePlan, pctx, schema, out_slots, out_ftypes,
               aggs=None, group_by=None, group_budget=0):
    from .physical import PhysExchangeSender, PhysMPPJoinTree

    senders = []
    key_pos_of = {0: []}
    for r in tp.rungs:
        key_pos_of[r["side"]] = r["build_pos"]
    for ordinal, s in enumerate(tp.sides):
        senders.append(PhysExchangeSender(
            Schema(s.task.scan_cols), s.task,
            key_pos_of.get(ordinal, []), ranges=s.ds.ranges))
    rungs = []
    for r in tp.rungs:
        side = tp.sides[r["side"]]
        others = [_remap_pair(c, tp, r, side) for c in r["others"]]
        rungs.append({
            "side": r["side"],
            "kind": r["kind"],
            "left_slots": [tp.slot_of[u] for u in r["left_uids"]],
            "build_pos": r["build_pos"],
            "others": others,
            "est": r["est"],
        })
    return PhysMPPJoinTree(
        senders, rungs, list(tp.slot_src), out_slots, out_ftypes,
        schema, aggs=aggs, group_by=group_by, group_budget=group_budget)

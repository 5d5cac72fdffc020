"""Device engine pieces shared by the fused mesh program (torch).

The port of the analysis half of the JAX package's per-tile engine: DAG
analysis (`_Analyzed`), dictionary rewrites of string constants, the
program fingerprint, the decimal state widening, and the host merge of
dense aggregation results.  The per-tile program itself (`run_base_jax`
in the JAX package) is not part of the port yet: the per-region rung
declines with DeviceUnsupported and its regions run on the CPU engine,
while the whole-table fused program (copr/parallel.py) carries the
device path.

Anything the port does not run on the device raises DeviceUnsupported
and the caller falls back to the CPU engine (or, inside a fused region,
peels the executor into a host tail): today the runtime join probes and
lookups.
"""

from __future__ import annotations

import json
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..chunk import Chunk, Column
from ..expr.aggregation import AggDesc
from ..expr.expression import ColumnExpr, Constant, Expression, ScalarFunc
from ..types import FieldType, TypeKind
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
    serialize_expr,
)
from .torch_eval import DeviceUnsupported

import os as _os


# rows per device dispatch; env-overridable so tests exercise multi-tile
# paths with small tables (TIDB_TPU_TILE=1024 in tests/conftest.py)
TILE = int(_os.environ.get("TIDB_TPU_TILE", 1 << 20))
MAX_GROUPS = 1 << 16  # cap on dense group-code space


# ---------------------------------------------------------------------------
# dictionary rewrite: string constants -> codes
# ---------------------------------------------------------------------------

_RANGE_OPS = {"<", "<=", ">", ">="}


def rewrite_for_dict(e: Expression, table, scan: TableScanIR) -> Expression:
    """Rewrite string-vs-constant comparisons over dict-encoded columns into
    integer code comparisons.  Raises DeviceUnsupported for raw string use."""
    return rewrite_for_dict_resolved(e, _scan_resolver(table, scan))


def _scan_resolver(table, scan: TableScanIR):
    """resolve(col_index) -> (table, scan, scan_pos): the single-side
    identity resolver; the join-tree engine (mpp/jointree.py) supplies a
    multi-side one that maps pair-layout positions onto each owning
    side's (table, scan)."""

    def resolve(idx: int):
        if 0 <= idx < len(scan.columns):
            return table, scan, idx
        return None

    return resolve


def rewrite_for_dict_resolved(e: Expression, resolve) -> Expression:
    if isinstance(e, (ColumnExpr, Constant)):
        return e
    assert isinstance(e, ScalarFunc)
    name = e.name
    if name in ("=", "!=") or name in _RANGE_OPS or name == "in":
        col, consts, col_first = _split_col_consts(e)
        if col is not None and col.ftype.kind == TypeKind.STRING:
            where = resolve(col.index)
            if where is None:
                raise DeviceUnsupported("string column not resolvable to a "
                                     "dict-encoded store column")
            table, scan, sp = where
            store_ci = scan.columns[sp]
            if store_ci not in table.dict_encoded_cols():
                raise DeviceUnsupported("string column not dict-encoded")
            if name in ("=", "!="):
                code = table.encode_dict_const(store_ci, str(consts[0].value))
                return ScalarFunc(
                    name,
                    [col, Constant(code, col.ftype)] if col_first
                    else [Constant(code, col.ftype), col],
                    e.ftype, e.meta,
                )
            if name == "in":
                items = [
                    Constant(table.encode_dict_const(store_ci, str(c.value)),
                             col.ftype)
                    for c in consts
                ]
                return ScalarFunc("in", [col] + items, e.ftype, e.meta)
            # range op on sorted dictionary
            op = name if col_first else _flip(name)
            s = str(consts[0].value)
            if op == "<":
                bound, newop = table.dict_bound(store_ci, s, "left"), "<"
            elif op == "<=":
                bound, newop = table.dict_bound(store_ci, s, "right"), "<"
            elif op == ">":
                bound, newop = table.dict_bound(store_ci, s, "right"), ">="
            else:  # >=
                bound, newop = table.dict_bound(store_ci, s, "left"), ">="
            return ScalarFunc(
                newop, [col, Constant(bound, col.ftype)], e.ftype, e.meta
            )
    from ..expr.pushdown import DICT_PRED_HEADS, dict_pred_source

    if name in DICT_PRED_HEADS and dict_pred_source(e) is not None:
        # computed predicate over ONE dict column (LIKE patterns,
        # SUBSTR/LENGTH comparisons): the host evaluates the
        # predicate once per DICTIONARY entry and the device tests CODE
        # membership — a range conjunction when the matching codes are
        # contiguous (prefix patterns on sorted dictionaries), an
        # in-list otherwise
        return _lower_dict_pred(e, resolve)
    new_args = [rewrite_for_dict_resolved(a, resolve) for a in e.args]
    return ScalarFunc(e.name, new_args, e.ftype, e.meta)




def _reindex_expr(e: Expression, mapping) -> Expression:
    """Clone `e` with every ColumnExpr index passed through `mapping`."""
    from .ir import deserialize_expr

    e2 = deserialize_expr(serialize_expr(e))

    def walk(x):
        if isinstance(x, ColumnExpr):
            x.index = mapping(x.index)
        elif isinstance(x, ScalarFunc):
            for a in x.args:
                walk(a)

    walk(e2)
    return e2


#: largest non-contiguous dict-predicate code set lowered as an in-list
#: (one Constant per code rides the program AND its fingerprint; sorted
#: dictionaries keep prefix patterns contiguous, so real LIKE-prefix
#: shapes never reach this cap — only mid-string matches over
#: high-cardinality dictionaries do, and those belong on the host lane)
DICT_PRED_IN_MAX = 256


def _lower_dict_pred(e: ScalarFunc, resolve) -> Expression:
    """A computed predicate over ONE dict column (LIKE patterns, SUBSTR /
    LENGTH comparisons) -> a code test: the host evaluates it once per
    dictionary entry (fusion.dict_pred_codes) and the device compares
    codes — a range when the matching codes are contiguous, an in-list
    otherwise."""
    from . import fusion
    from ..expr.pushdown import dict_pred_source

    cols = dict_pred_source(e)
    src = cols[0]
    where = resolve(src.index)
    if where is None:
        raise DeviceUnsupported("dict predicate column not resolvable")
    table, scan, sp = where
    # evaluate in the owning side's scan layout (the predicate reads ONE
    # column, so reindexing every leaf to `sp` is exact), then emit the
    # lowered comparison against the ORIGINAL position
    shifted = _reindex_expr(e, lambda _i: sp)
    _idx, codes, _nd = fusion.dict_pred_codes(table, scan, shifted)
    col = ColumnExpr(src.index, src.ftype, src.name, -1)
    if len(codes) == 0:
        # never-matching comparison, NOT a bare FALSE constant: the
        # column's validity must keep riding (NULL rows evaluate to
        # NULL, so `NOT <pred>` stays NULL instead of flipping TRUE)
        return ScalarFunc("=", [col, Constant(-1, col.ftype)],
                          e.ftype, {})
    # no all-match shortcut: the code comparison must keep carrying the
    # column's validity (a NULL row never matches a predicate)
    lo, hi = int(codes[0]), int(codes[-1])
    if hi - lo + 1 == len(codes):
        # contiguous code range (sorted dictionaries make every prefix
        # pattern contiguous): two comparisons instead of a member scan
        if lo == hi:
            return ScalarFunc("=", [col, Constant(lo, col.ftype)],
                              e.ftype, {})
        return ScalarFunc("and", [
            ScalarFunc(">=", [col, Constant(lo, col.ftype)], e.ftype, {}),
            ScalarFunc("<=", [col, Constant(hi, col.ftype)], e.ftype, {}),
        ], e.ftype, {})
    if len(codes) > DICT_PRED_IN_MAX:
        # a non-contiguous match set over a high-cardinality dictionary
        # would embed one Constant per code into the program AND its
        # fingerprint — decline so the host lane serves it instead
        raise DeviceUnsupported("dict predicate code set too large")
    return ScalarFunc(
        "in", [col] + [Constant(int(c), col.ftype) for c in codes],
        e.ftype, {})


def _string_leaf(e: Expression) -> bool:
    """Does the expression read any STRING-typed column?"""
    if isinstance(e, ColumnExpr):
        return e.ftype.kind == TypeKind.STRING
    if isinstance(e, ScalarFunc):
        return any(_string_leaf(a) for a in e.args)
    return False


def _split_col_consts(e: ScalarFunc):
    args = e.args
    if isinstance(args[0], ColumnExpr) and all(
        isinstance(a, Constant) for a in args[1:]
    ):
        return args[0], list(args[1:]), True
    if len(args) == 2 and isinstance(args[1], ColumnExpr) and isinstance(
        args[0], Constant
    ):
        return args[1], [args[0]], False
    return None, [], True


def _flip(op: str) -> str:
    return {"<": ">", "<=": ">=", ">": "<", ">=": "<="}[op]


# ---------------------------------------------------------------------------
# device block cache
# ---------------------------------------------------------------------------


class _Analyzed:
    def __init__(self, dag: DAG, table):
        self.scan: TableScanIR = dag.scan
        self.selections: List[SelectionIR] = []
        self.projection: Optional[ProjectionIR] = None
        self.agg: Optional[AggregationIR] = None
        self.topn: Optional[TopNIR] = None
        self.limit: Optional[int] = None
        for ex in dag.executors[1:]:
            if isinstance(ex, SelectionIR):
                if self.agg or self.topn or self.projection:
                    raise DeviceUnsupported(
                        "selection after agg/topn on device")
                self.selections.append(ex)
            elif isinstance(ex, (JoinProbeIR, JoinLookupIR)):
                # runtime join filters and broadcast lookup joins on the
                # device are not part of the port yet
                raise DeviceUnsupported("device join probe not ported")
            elif isinstance(ex, ProjectionIR):
                if self.agg or self.topn:
                    raise DeviceUnsupported(
                        "projection after agg/topn on device")
                self.projection = ex
            elif isinstance(ex, AggregationIR):
                if self.agg or self.topn or self.projection:
                    raise DeviceUnsupported("late aggregation on device")
                if ex.mode != "partial":
                    raise DeviceUnsupported("device agg is partial-only")
                self.agg = ex
            elif isinstance(ex, TopNIR):
                if self.agg or self.topn:
                    raise DeviceUnsupported("topn after agg on device")
                self.topn = ex
            elif isinstance(ex, LimitIR):
                self.limit = ex.limit if self.limit is None else min(
                    self.limit, ex.limit
                )
            else:
                raise DeviceUnsupported(f"device executor {ex!r}")
        # pushability gate (defense in depth; the planner already gates)
        from ..expr.pushdown import can_push_agg, can_push_expr

        dict_scan_idx = {
            i for i, ci in enumerate(self.scan.columns)
            if ci in table.dict_encoded_cols()
        }
        all_exprs: List[Expression] = [
            c for s in self.selections for c in s.conditions
        ]
        if self.projection is not None:
            all_exprs += self.projection.exprs
        if self.topn is not None:
            all_exprs += [e for e, _ in self.topn.order_by]
        for ex2 in all_exprs:
            if not can_push_expr(ex2, dict_cols=dict_scan_idx):
                raise DeviceUnsupported(f"expr not device-eligible: {ex2}")
        if self.agg is not None:
            for a in self.agg.aggs:
                if not can_push_agg(a, dict_cols=dict_scan_idx):
                    raise DeviceUnsupported(f"agg not device-eligible: {a}")
        # rewrite dict-encoded string constants
        self.conds = [
            rewrite_for_dict(c, table, self.scan)
            for s in self.selections
            for c in s.conditions
        ]
        if self.projection is not None:
            self.proj_exprs = [
                rewrite_for_dict(p, table, self.scan)
                for p in self.projection.exprs
            ]
        else:
            self.proj_exprs = None
        if self.agg is not None:
            # rewrite agg ARGS and group keys for dict codes too
            # (CASE-heavy aggregate arguments with string comparisons
            # — `sum(case when prio = '1-URGENT' ...)` — compile against
            # integer codes).  A fresh AggregationIR: the DAG's own IR
            # keeps the original string constants for the host engines.
            self.agg = AggregationIR(
                [rewrite_for_dict(g, table, self.scan)
                 for g in self.agg.group_by],
                [AggDesc(a.name,
                         [rewrite_for_dict(x, table, self.scan)
                          for x in a.args],
                         a.distinct, a.ftype)
                 for a in self.agg.aggs],
                mode=self.agg.mode, stream=self.agg.stream)
        # group-key layout for device aggregation
        self.group_cols: List[int] = []  # scan-output indices
        self.group_card: List[Tuple[int, int]] = []  # (lo, card) per key
        # 'dense': mixed-radix int codes + segment reduce (small key
        # spaces); 'sort': sort + boundary segments (arbitrary NDV,
        # float/NULLable/computed keys)
        self.agg_mode = "dense"
        #: per-group-key dict-code remaps (computed string keys lowered
        #: to code-space gathers) — None when no key needs one
        self.key_remaps = None
        #: packed lexicographic multi-column TopN spec, else None
        self.topn_pack = None
        if self.agg is not None:
            for a in self.agg.aggs:
                if a.distinct:
                    raise DeviceUnsupported("distinct agg on device")
                if a.name not in ("count", "sum", "avg", "min", "max",
                                  "first_row"):
                    raise DeviceUnsupported(f"device agg {a.name}")
            try:
                self._analyze_dense_keys(table)
            except DeviceUnsupported:
                # high-NDV / float / NULLable / non-column keys: group by
                # sorting — keys only need to be device-compilable.
                # Computed keys READING a dict-encoded string column
                # lower to code-space gathers (fusion.build_key_remap):
                # the host evaluates the function once per DICTIONARY
                # entry and the device re-maps row codes through a
                # runtime operand (K1) — no host tail, no decode.
                from .fusion import build_key_remap

                remaps = []
                for k in self.agg.group_by:
                    if not isinstance(k, ColumnExpr) and (
                            k.ftype.kind == TypeKind.STRING
                            or _string_leaf(k)):
                        # STRING outputs remap into an output dictionary;
                        # INT-valued ones (LENGTH/ASCII) remap straight
                        # to computed values
                        remaps.append(build_key_remap(table, self.scan, k))
                        continue
                    if not can_push_expr(k, dict_cols=dict_scan_idx):
                        raise
                    remaps.append(None)
                if any(r is not None for r in remaps):
                    self.key_remaps = remaps
                self.agg_mode = "sort"
                self.num_groups = 0
                self.group_cols = []
                self.group_card = []
        if self.topn is not None and len(self.topn.order_by) != 1:
            # exact compound ordering: pack every key's stats-bounded
            # rank into ONE integer sort key (fusion.compound_topn_key);
            # unpackable key sets raise with the compound-order reason
            self._analyze_compound_topn(table)

    def _analyze_compound_topn(self, table):
        """Build the packed lexicographic sort-key spec for a
        multi-column TopN: per key (col_idx, lo, hi, slots, desc,
        has_null) with a NULL rank slot when the column is nullable.
        The slot product is capped at 2**52 so the f64 top-k comparison
        stays exact."""
        pack = []
        total = 1
        for e, desc in self.topn.order_by:
            if not isinstance(e, ColumnExpr):
                raise DeviceUnsupported(
                    f"compound order key must be a plain column: {e}")
            if e.ftype.kind == TypeKind.FLOAT:
                raise DeviceUnsupported(
                    "compound order over unbounded float sort key")
            if e.index >= len(self.scan.columns):
                raise DeviceUnsupported(
                    "compound order key over join payload")
            store_ci = self.scan.columns[e.index]
            lo, hi, has_null = table.column_stats(store_ci)
            if hi < lo:
                lo, hi = 0, 0
            slots = (hi - lo + 1) + (1 if has_null else 0)
            total *= slots
            if total > (1 << 52):
                raise DeviceUnsupported(
                    "compound order key space too large for a packed "
                    "sort key")
            pack.append((e.index, int(lo), int(hi), int(slots),
                         bool(desc), bool(has_null)))
        self.topn_pack = pack

    def _analyze_dense_keys(self, table):
        g = 1
        group_cols: List[int] = []
        group_card: List[Tuple[int, int]] = []
        for k in self.agg.group_by:
            if not isinstance(k, ColumnExpr):
                raise DeviceUnsupported("dense group key must be a column")
            if k.ftype.kind == TypeKind.FLOAT:
                # dense int codes would truncate: 1.2 and 1.4 collapse
                raise DeviceUnsupported("float group key on device")
            if k.index >= len(self.scan.columns):
                # payload column (join lookup): no base stats — sort mode
                raise DeviceUnsupported("payload group key needs sort agg")
            store_ci = self.scan.columns[k.index]
            lo, hi, has_null = table.column_stats(store_ci)
            if has_null:
                # NULL is its own group in SQL; the dense-code space has
                # no slot for it
                raise DeviceUnsupported("NULLable group key on device")
            if hi < lo:
                lo, hi = 0, 0
            card = hi - lo + 1
            if card <= 0 or card > MAX_GROUPS:
                raise DeviceUnsupported("group key cardinality too large")
            g *= card
            if g > MAX_GROUPS:
                raise DeviceUnsupported("combined group space too large")
            group_cols.append(k.index)
            group_card.append((lo, card))
        self.group_cols = group_cols
        self.group_card = group_card
        self.num_groups = max(g, 1)

    def needed_cols(self) -> List[int]:
        """Scan-output col indices the device actually needs."""
        need: set = set()
        for c in self.conds:
            c.collect_columns(need)
        if self.agg is not None:
            need.update(self.group_cols)
            for k in self.agg.group_by:
                k.collect_columns(need)
            for a in self.agg.aggs:
                for x in a.args:
                    x.collect_columns(need)
        if self.proj_exprs is not None:
            for p in self.proj_exprs:
                p.collect_columns(need)
        if self.topn is not None:
            for e, _d in self.topn.order_by:
                e.collect_columns(need)
        width = len(self.scan.columns)
        return sorted(i for i in need if i < width)


# ---------------------------------------------------------------------------
# fingerprint + result layout
# ---------------------------------------------------------------------------

def _fingerprint(an: _Analyzed, kind: str) -> str:
    payload = {
        "kind": kind,
        "conds": [serialize_expr(c) for c in an.conds],
        "proj": [serialize_expr(p) for p in an.proj_exprs]
        if an.proj_exprs is not None
        else None,
        "scan_ft": [int(f.kind) for f in an.scan.ftypes],
    }
    if an.agg is not None:
        payload["agg"] = {
            "mode": an.agg_mode,
            "keys": an.group_cols,
            "card": an.group_card,
            "group_by": [serialize_expr(g) for g in an.agg.group_by],
            "aggs": [
                {"name": a.name, "args": [serialize_expr(x) for x in a.args]}
                for a in an.agg.aggs
            ],
        }
    if an.topn is not None:
        from ..serving import topn_budget

        e, desc = an.topn.order_by[0]
        # pow2-bucketed device budget: LIMIT 5 and LIMIT 7 share one
        # program; the exact limit re-applies at the host merge
        payload["topn"] = {
            "key": serialize_expr(e), "desc": desc,
            "k": topn_budget(an.topn.limit),
        }
        if an.topn_pack is not None:
            # packed compound ordering: every key + its static rank
            # layout (lo/slots derive from column stats) shapes it
            payload["topn"]["keys"] = [
                [serialize_expr(e2), bool(d2)]
                for e2, d2 in an.topn.order_by
            ]
            payload["topn"]["pack"] = [
                [p[1], p[3], p[4], p[5]] for p in an.topn_pack
            ]
    if an.key_remaps:
        # remap arity + pow2 caps shape the program; mapping CONTENTS
        # stay runtime operands (one program serves every dictionary
        # content)
        payload["remaps"] = [r.cap if r is not None else None
                             for r in an.key_remaps]
    return json.dumps(payload, sort_keys=True, default=str)


def _agg_tags(agg_ir) -> List[str]:
    """Static result layout: tag per agg."""
    tags = []
    for a in agg_ir.aggs:
        if a.name == "count":
            tags.append("count")
        elif a.name in ("sum", "avg"):
            tags.append("sumcount")
        elif a.name in ("min", "max"):
            tags.append("minmax")
        else:
            tags.append("argfirst")
    return tags


def _to_state_dtype(d, src_ft: FieldType, state_ft: FieldType):
    if state_ft.kind == TypeKind.FLOAT:
        if src_ft.kind == TypeKind.DECIMAL:
            return d.to(torch.float64) / (10.0 ** src_ft.scale)
        return d.to(torch.float64)
    # decimal state: rescale ints
    if src_ft.kind == TypeKind.DECIMAL:
        ds = state_ft.scale - src_ft.scale
        if ds > 0:
            return d.to(torch.int64) * (10 ** ds)
        return d.to(torch.int64)
    return d.to(torch.int64) * (10 ** state_ft.scale)


# ---------------------------------------------------------------------------
# engine entry

def _device_agg_to_chunk(accum, table, an: _Analyzed) -> Chunk:
    """Dense per-group arrays -> partial chunk [keys..., states...] with
    empty groups dropped (matches the CPU engine layout)."""
    gcount = accum["gcount"]
    present = np.flatnonzero(gcount > 0)
    if an.agg.group_by and len(present) == 0:
        return Chunk.empty(
            [g.ftype for g in an.agg.group_by]
            + [t for a in an.agg.aggs for t in a.partial_types()]
        )
    if not an.agg.group_by:
        present = np.array([0], dtype=np.int64)
    cols: List[Column] = []
    # decode mixed-radix codes back to key values
    code = present.copy()
    for kcol, (lo, card), g in zip(an.group_cols, an.group_card,
                                   an.agg.group_by):
        vals = (code % card) + lo
        code = code // card
        store_ci = an.scan.columns[kcol]
        meta = table.cols[store_ci]
        if meta.ftype.kind == TypeKind.STRING:
            d = meta.dictionary or []
            obj = np.empty(len(vals), dtype=object)
            for i, c in enumerate(vals):
                obj[i] = d[c] if 0 <= c < len(d) else ""
            cols.append(Column(g.ftype, obj))
        else:
            cols.append(Column(g.ftype, vals.astype(meta.ftype.np_dtype)))
    for a, slot in zip(an.agg.aggs, accum["states"]):
        tag = slot[0]
        pts = a.partial_types()
        if tag == "count":
            cols.append(Column(pts[0], slot[1][present].astype(np.int64)))
        elif tag == "sumcount":
            s = slot[1][present]
            c = slot[2][present]
            sum_col = Column(pts[0], s.astype(pts[0].np_dtype), c > 0)
            if a.name == "sum":
                cols.append(sum_col)
            else:
                cols.append(sum_col)
                cols.append(Column(pts[1], c.astype(np.int64)))
        elif tag == "minmax":
            v = slot[1][present]
            c = slot[2][present]
            arg_ft = a.args[0].ftype
            if arg_ft.kind == TypeKind.STRING:
                # values are dict codes; decode
                colexpr = a.args[0]
                store_ci = an.scan.columns[colexpr.index]
                d = table.cols[store_ci].dictionary or []
                obj = np.empty(len(v), dtype=object)
                for i, cd in enumerate(v):
                    obj[i] = d[int(cd)] if 0 <= int(cd) < len(d) else ""
                cols.append(Column(pts[0], obj, c > 0))
            else:
                cols.append(
                    Column(pts[0], v.astype(pts[0].np_dtype), c > 0)
                )
        elif tag == "argfirst":
            cols.append(Column(pts[0], slot[1][present], slot[2][present]))
    return Chunk(cols)

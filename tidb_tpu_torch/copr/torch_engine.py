"""Device engine pieces shared by the fused programs (torch).

The port of the JAX package's per-tile engine (`jax_engine.py`): DAG
analysis (`_Analyzed`, runtime join probes and broadcast lookup joins
included), dictionary rewrites of string constants, the program
fingerprint, the decimal state widening, the host merge of dense
aggregation results, and the per-tile program (`run_base_torch`): the
per-region rung that runs a region's rows tile by tile on the card when
the whole-table program (copr/parallel.py) declines the request, e.g.
one with more disjoint ranges than its range slots.

- Tiles of immutable base blocks are cached on the card, keyed by
  (store, base version, column, tile, device) in `DEVICE_CACHE`, padded
  to TILE rows, so a repeated scan moves no column over the link.
- The row mask is built on the card from the region's [lo, hi) clip
  within the tile and the tile's MVCC deletions.
- Anything the device path cannot run raises DeviceUnsupported: the
  fusion ladder (copr/fusion.run_fragment) then peels the executor into
  a host tail, or the CPU engine serves the region.
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

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
# device tile cache
# ---------------------------------------------------------------------------


class _DeviceCache:
    """(store_uid, base_version, store_ci, tile_idx, position, device) ->
    (data, valid) TILE-row tensors on that mesh position's device.
    Bounded by its byte cap and counted in the device bytes the engine
    reports (`parallel._hbm_bytes`), beside the whole-table column
    cache."""

    def __init__(self, capacity_bytes: int = 8 << 30):
        from .cache import ByteCapCache

        self._c = ByteCapCache(capacity_bytes, name="tile")

    def get_tile(self, table, store_ci: int, tile_idx: int, start: int,
                 end: int, device: torch.device, pos: int = 0):
        key = (table.store_uid, table.base_version, store_ci, tile_idx,
               pos, str(device))

        def load():
            from ..trace import span
            from .parallel import to_device

            with span("copr.transfer", col=store_ci, tile=tile_idx) as sp:
                data, valid = _gather_tile(table, store_ci, start, end)
                # the trace counts devices by their position id
                sp.set(bytes=data.nbytes + valid.nbytes, device=pos)
                return to_device(data, device), to_device(valid, device)

        return self._c.get_or_load(key, load)

    def clear(self):
        """Drop every resident tile (device-OOM recovery path)."""
        self._c.clear()

    def evict_device(self, device_id: int) -> int:
        """Drop every tile placed on this mesh position."""
        return self._c.evict_if(lambda k: k[4] == device_id)


def _gather_tile(table, store_ci: int, start: int, end: int):
    """Host side: concatenate the block slices of rows [start, end) at
    the dtype the expression compiler expects, padded to TILE."""
    meta = table.cols[store_ci]
    dt = np.int32 if meta.ftype.kind in (TypeKind.DATE, TypeKind.STRING) else (
        np.float64 if meta.ftype.kind == TypeKind.FLOAT else np.int64
    )
    parts, vparts = [], []
    for _, arrs, vals in table.iter_base_blocks([store_ci], start, end):
        parts.append(arrs[0])
        v = vals[0]
        vparts.append(v if v is not None else np.ones(len(arrs[0]), np.bool_))
    if parts:
        data = np.concatenate(parts).astype(dt, copy=False)
        valid = np.concatenate(vparts)
    else:
        data = np.zeros(0, dtype=dt)
        valid = np.zeros(0, dtype=np.bool_)
    n = len(data)
    if n < TILE:
        data = np.pad(data, (0, TILE - n))
        valid = np.pad(valid, (0, TILE - n))
    return data, valid


DEVICE_CACHE = _DeviceCache()

_ALL_TRUE: dict = {}


def _all_true(device: torch.device) -> torch.Tensor:
    """The resident all-true TILE mask of one device, made once."""
    key = (str(device), TILE)
    m = _ALL_TRUE.get(key)
    if m is None:
        m = _ALL_TRUE.setdefault(
            key, torch.ones(TILE, dtype=torch.bool, device=device))
    return m


# ---------------------------------------------------------------------------
# DAG analysis
# ---------------------------------------------------------------------------


class _Analyzed:
    def __init__(self, dag: DAG, table):
        self.scan: TableScanIR = dag.scan
        self.selections: List[SelectionIR] = []
        self.probes: List[JoinProbeIR] = []
        self.lookups: List[JoinLookupIR] = []
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
            elif isinstance(ex, JoinProbeIR):
                if self.agg or self.topn or self.projection:
                    raise DeviceUnsupported(
                        "join probe after agg/topn on device")
                self.probes.append(ex)
            elif isinstance(ex, JoinLookupIR):
                if self.agg or self.topn or self.projection:
                    raise DeviceUnsupported("join lookup after agg/topn")
                self.lookups.append(ex)
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
        ] + [p.key for p in self.probes] + [lk.key for lk in self.lookups]
        if self.lookups and self.agg is None:
            # the filter/topn readback paths gather rows from the TABLE,
            # which has no payload columns: a lookup runs on the device
            # only under a partial aggregation (the only shape the
            # planner emits; the per-region rung handles the rest)
            raise DeviceUnsupported("join lookup without device aggregation")
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
            width = len(self.scan.columns)
            for a in self.agg.aggs:
                if a.distinct:
                    raise DeviceUnsupported("distinct agg on device")
                if a.name not in ("count", "sum", "avg", "min", "max",
                                  "first_row"):
                    raise DeviceUnsupported(f"device agg {a.name}")
                if a.name == "first_row" and self.lookups:
                    refs: set = set()
                    for x in a.args:
                        x.collect_columns(refs)
                    if any(i >= width for i in refs):
                        # first_row partials resolve through a TABLE
                        # gather, which has no payload columns
                        raise DeviceUnsupported(
                            "first_row over join payload")
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
        """Scan-output col indices the device actually needs (payload
        indices of join lookups arrive as operands, not scanned columns,
        and are dropped)."""
        need: set = set()
        for c in self.conds:
            c.collect_columns(need)
        for p in self.probes:
            p.key.collect_columns(need)
        for lk in self.lookups:
            lk.key.collect_columns(need)
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
        "probes": [[serialize_expr(p.key), p.filter_id] for p in an.probes],
        "lookups": [
            [serialize_expr(lk.key), lk.filter_id,
             [int(f.kind) for f in lk.payload_ftypes]]
            for lk in an.lookups
        ],
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
# the per-tile program
# ---------------------------------------------------------------------------

from .cache import ProgramCache  # noqa: E402

_COMPILED = ProgramCache("tile")


def _tile_core(an: _Analyzed, kind: str, col_order: List[int],
               with_params: bool = False, batched: bool = False):
    """The per-tile program, composed from the fusion phase emitters
    (copr/fusion.py) so every pushed phase (filter, project, agg, topN)
    emits into one shared context.

    Signature: fn(datas, valids, lo, hi, del_mask[, pi, pf]): the pi/pf
    trailing tensors (hoisted predicate parameters, serving/params.py)
    are passed only when `with_params`.  Returns (mask, projection
    outputs or None) for `filter`, (gcount, results) for dense `agg` and
    (tile-local row indices, count) for `topn`.

    `batched` is the micro-batcher's program (serving/batcher.py; the
    JAX package vmaps this core): pi/pf are stacked as [B, P] int64 and
    [B, Q] f64, one row per statement, while the tile, lo, hi and
    del_mask are shared.  The predicate mask is then [B, TILE], and the
    dense aggregation reduces B x G segments at once (ops/segment.py),
    so the whole batch is one sequence of device ops per tile with no
    loop over members: [B, TILE] masks for `filter`, (gcount [B, G],
    results with [B, G] leaves) for dense `agg`."""
    from . import fusion

    if an.lookups:
        # the broadcast lookup join runs in the whole-table program only;
        # the per-region rung hands these regions to the CPU engine
        raise DeviceUnsupported("join lookup needs the mesh engine")
    if batched and (kind not in ("filter", "agg") or not with_params):
        raise DeviceUnsupported(f"batched {kind} program")
    n = TILE

    def region_ctx(datas, valids, lo, hi, del_mask, params):
        env = {
            ci: (datas[j], valids[j]) for j, ci in enumerate(col_order)
        }
        if with_params and params:
            env["__params__"] = params
        ar = torch.arange(n, dtype=torch.int64, device=del_mask.device)
        ctx = fusion.RegionContext(
            an=an, cols=env, n=n,
            mask=(ar >= lo) & (ar < hi) & del_mask)
        fusion.selection_mask(ctx)
        if batched and ctx.mask.dim() == 1:
            # no predicate reads a parameter: one mask serves every member
            ctx.mask = ctx.mask.expand(params[0].shape[0], n)
        return ctx

    if kind == "filter":
        def fn(datas, valids, lo, hi, del_mask, *params):
            ctx = region_ctx(datas, valids, lo, hi, del_mask, params)
            outs = None
            if an.proj_exprs is not None:
                outs = fusion.projection_outputs(ctx)
            return ctx.mask, outs

        return fn

    if kind == "agg":
        def fn(datas, valids, lo, hi, del_mask, *params):
            ctx = region_ctx(datas, valids, lo, hi, del_mask, params)
            gidx = fusion.dense_group_codes(ctx)
            return fusion.dense_agg_results(ctx, gidx)

        return fn

    if kind == "topn":
        from .. import ops
        from ..serving import topn_budget

        desc = fusion.topn_desc(an)
        k = min(topn_budget(an.topn.limit), TILE)

        def fn(datas, valids, lo, hi, del_mask, *params):
            ctx = region_ctx(datas, valids, lo, hi, del_mask, params)
            key = fusion.topn_key(ctx)
            return ops.masked_top_k(key, ctx.mask, k, desc)

        return fn

    raise DeviceUnsupported(kind)


def _np_batch(tensors) -> List[np.ndarray]:
    """Read a list of [B, ...] device tensors back in ONE copy: each is
    flattened per member into int64 words (floats bit-cast, narrower
    ints and bools widened), the words travel in one `.cpu()`, and the
    host splits them back into arrays of the original dtypes and
    shapes."""
    b = tensors[0].shape[0]
    words = []
    for t in tensors:
        t = t.reshape(b, -1)
        words.append(t.to(torch.float64).view(torch.int64)
                     if t.dtype.is_floating_point else t.to(torch.int64))
    host = torch.cat(words, 1).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        k = t[0].numel()
        part = np.ascontiguousarray(host[:, off:off + k])
        off += k
        if t.dtype.is_floating_point:
            part = part.view(np.float64)
        np_dt = torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(part.astype(np_dt, copy=False).reshape(tuple(t.shape)))
    return out


def _build_tile_fn(an: _Analyzed, kind: str, col_order: List[int],
                   with_params: bool = False):
    """The per-tile program for one fragment shape:
    fn(datas, valids, lo, hi, del_mask[, pi, pf]).

    The row mask is built ON THE CARD from the [lo, hi) clip of the
    region within the tile, ANDed with del_mask (a resident all-true
    tensor unless the tile has MVCC-deleted rows), so a steady query
    moves no scan data over the link: only the results come back.  For
    `agg` the results are tagged with their `_agg_tags` layout."""
    core = _tile_core(an, kind, col_order, with_params=with_params)
    if kind != "agg":
        return core
    tags = _agg_tags(an.agg)

    def wrapped(datas, valids, lo, hi, del_mask, *params):
        gcount, results = core(datas, valids, lo, hi, del_mask, *params)
        return gcount, list(zip(tags, results))

    return wrapped


# ---------------------------------------------------------------------------
# engine entry
# ---------------------------------------------------------------------------


def _tile_devices():
    """The mesh positions the per-tile path may place work on: this
    process's positions minus tripped breakers; an all-tripped set
    falls back to the full list.  Tiles go round-robin over them.
    Across processes every local position serves (no breaker filter, as
    in the JAX package): the rung issues no collective."""
    from .. import ops
    from .device_health import DEVICE_HEALTH
    from .parallel import _Card

    cards = [_Card(d) for d in ops.device_ids()]
    if ops.process_count() > 1:
        return cards
    healthy = DEVICE_HEALTH.select_devices(cards)
    return healthy if healthy else cards


def _card_device(card) -> torch.device:
    """The torch device of a mesh position."""
    from .. import ops

    return ops.position_device(card.id)


def run_base_torch(table, dag: DAG, start: int, end: int,
                   deleted: Sequence[int], aux=None, an=None) -> List[Chunk]:
    """Execute `dag` over base rows [start, end) on the card, tile by
    tile; returns result chunks (partial-agg rows, topn rows, or
    filtered rows).  `an` lets the fusion ladder pass its analysis in.
    Raises DeviceUnsupported for the shapes only the whole-table program
    runs (sort-mode aggregation, join probes and lookups)."""
    if an is None:
        an = _Analyzed(dag, table)
    if an.agg is not None and an.agg_mode != "dense":
        # sort-based grouping needs the whole-table program
        # (copr/parallel.py); the per-region rung hands these to the CPU
        # engine
        raise DeviceUnsupported("sort-mode agg runs on the mesh path only")
    if an.probes:
        # runtime join filters run in the whole-table program; the
        # per-region rung evaluates them on the CPU engine
        raise DeviceUnsupported("join probe runs on the mesh path only")
    kind = "agg" if an.agg is not None else (
        "topn" if an.topn is not None else "filter"
    )
    import time as _time

    from ..lifecycle import chunk_admission, scope_check
    from ..serving import hoist_conds
    from ..store.fault import FAILPOINTS
    from ..trace import span
    from .chunking import observe_chunk
    from .device_health import DEVICE_HEALTH
    from .parallel import _hbm_bytes, to_device

    col_order = an.needed_cols()
    # predicate constants hoisted into runtime parameter slots: the
    # fingerprint serializes SLOTS, so parameter-different queries of the
    # same shape share one program
    hoisted = hoist_conds(an)
    fp = (_fingerprint(an, kind) + f"|cols={col_order}|tile={TILE}"
          + (f"|hp={len(hoisted[0])},{len(hoisted[1])}"
             if hoisted is not None else ""))
    fn = _COMPILED.get(fp)
    built_now = fn is None
    if fn is None:
        fn = _build_tile_fn(an, kind, col_order,
                            with_params=hoisted is not None)
        _COMPILED.put(fp, fn)
    else:
        # zero-duration marker: the DAG fingerprint hit the program cache
        with span("copr.compile", cache="hit", kind=kind):
            pass

    del_arr = np.fromiter(sorted(deleted), dtype=np.int64,
                          count=len(deleted))
    out_chunks: List[Chunk] = []
    agg_accum = None
    topn_parts: List[Chunk] = []
    remaining_limit = an.limit
    devices = _tile_devices()
    used_ids: set = set()
    pextra: dict = {}
    for tile_start in range((start // TILE) * TILE, end, TILE):
        # host-side cancellation seam: KILL and deadlines land between
        # tile dispatches
        scope_check()
        t0 = max(tile_start, start)
        t1 = min(tile_start + TILE, end)
        if t0 >= t1:
            continue
        tile_idx = tile_start // TILE
        # the tile loop IS the chunk sequence of this rung: each tile
        # re-acquires resource-group admission and feeds the same chunk
        # telemetry the whole-table dispatcher does
        FAILPOINTS.hit("copr/chunk_dispatch", kind="tile", chunk=tile_idx,
                       total=0, start=t0, end=t1)
        # tiles are always the aligned cached tensors; the region clip
        # [t0, t1) and the deletions become the mask
        card = devices[tile_idx % len(devices)]
        dev = _card_device(card)
        used_ids.add(card.id)
        datas, valids = [], []
        for ci in col_order:
            d, v = DEVICE_CACHE.get_tile(
                table, an.scan.columns[ci], tile_idx, tile_start,
                min(tile_start + TILE, table.base_rows), dev, card.id)
            datas.append(d)
            valids.append(v)
        params = ()
        if hoisted is not None:
            params = pextra.get(dev)
            if params is None:
                params = pextra[dev] = (to_device(hoisted[0], dev),
                                        to_device(hoisted[1], dev))
        base0 = tile_start
        lo, hi = t0 - base0, t1 - base0
        del_mask = _all_true(dev)
        if len(del_arr):
            dd = del_arr[(del_arr >= base0) & (del_arr < base0 + TILE)] - base0
            if len(dd):
                dm = np.ones(TILE, dtype=np.bool_)
                dm[dd] = False
                del_mask = to_device(dm, dev)

        # the first dispatch of a freshly built program carries the
        # compile label, as in the whole-table path
        dspan = "copr.compile" if built_now else "copr.device.execute"
        dattr = {"cache": "miss"} if built_now else {}
        dattr["hbm_bytes"] = _hbm_bytes()
        built_now = False
        td0 = _time.perf_counter()
        with span(dspan, kind=kind, tile=tile_idx, **dattr):
            with chunk_admission():
                out = fn(datas, valids, lo, hi, del_mask, *params)
        observe_chunk("tile", (_time.perf_counter() - td0) * 1000.0,
                      int(t1 - t0))
        if kind == "filter":
            m, outs = out
            with span("copr.readback") as rsp:
                sel_t = torch.nonzero(m).reshape(-1)
                if remaining_limit is not None:
                    sel_t = sel_t[:remaining_limit]
                sel = sel_t.cpu().numpy()
                nb = sel.nbytes
                cols = []
                if outs is not None and len(sel):
                    for (dv, vv), p in zip(outs, an.proj_exprs):
                        dv, vv = _np_tree((dv[sel_t], vv[sel_t]))
                        nb += dv.nbytes + vv.nbytes
                        cols.append(Column(p.ftype, dv, vv))
                rsp.set(bytes=nb)
            if len(sel) == 0:
                continue
            if outs is not None:
                chunk = Chunk(cols)
            else:
                chunk = _gather_rows(table, an.scan, base0, sel)
            out_chunks.append(chunk)
            if remaining_limit is not None:
                remaining_limit -= chunk.num_rows
                if remaining_limit <= 0:
                    break
        elif kind == "agg":
            gcount, results = out
            with span("copr.readback") as rsp:
                vals = [r for _t, r in results]
                host = _np_tree((gcount,) + tuple(agg_leaves(vals)))
                gh = host[0]
                rh = agg_states([t for t, _r in results], vals, host[1:])
                rsp.set(bytes=sum(h.nbytes for h in host))
            agg_accum = _merge_device_agg(agg_accum, gh, rh, table, an,
                                          base0)
        else:  # topn
            idx, cnt = out
            with span("copr.readback") as rsp:
                idx = _np_tree(idx[:int(cnt)])
                rsp.set(bytes=idx.nbytes)
            if len(idx):
                topn_parts.append(_gather_rows(table, an.scan, base0, idx))

    # every tile program completed: reset error streaks for the cards
    # that actually ran a tile
    DEVICE_HEALTH.record_success(sorted(used_ids))

    if kind == "agg":
        if agg_accum is None:
            return []
        return [_device_agg_to_chunk(agg_accum, table, an)]
    if kind == "topn":
        if not topn_parts:
            return []
        from .cpu_engine import run_topn

        merged = topn_parts[0]
        for p in topn_parts[1:]:
            merged = merged.append(p)
        return [run_topn(an.topn.order_by, an.topn.limit, merged)]
    return out_chunks


def _np_tree(r):
    """Host copy of a tensor, or of a tuple of tensors in ONE copy
    (`_np_batch`, a batch of one)."""
    if isinstance(r, tuple):
        return tuple(h[0] for h in _np_batch([x[None] for x in r]))
    return r.cpu().numpy()


def agg_leaves(results) -> list:
    """The tensors of an aggregation's results (`_agg_tags` layout),
    flattened in order."""
    out = []
    for r in results:
        out.extend(r if isinstance(r, tuple) else (r,))
    return out


def agg_states(tags, results, leaves) -> list:
    """(tag, state) pairs in `_agg_tags` layout from the host copies of
    `agg_leaves(results)`."""
    states, i = [], 0
    for tag, r in zip(tags, results):
        if isinstance(r, tuple):
            states.append((tag, tuple(leaves[i:i + len(r)])))
            i += len(r)
        else:
            states.append((tag, leaves[i]))
            i += 1
    return states


def _gather_rows(table, scan: TableScanIR, base0: int,
                 sel: np.ndarray) -> Chunk:
    """Host gather of scan-output rows at tile-local indices `sel`: a
    per-block sparse gather, not a contiguous-span materialization."""
    return table.gather_chunk(list(scan.columns), base0 + sel)


def _merge_device_agg(accum, gcount: np.ndarray, results, table,
                      an: _Analyzed, base0: int):
    """Accumulate per-tile dense G-arrays into running host arrays."""
    if accum is None:
        accum = {"gcount": gcount.copy(),
                 "states": [[tag, None, None] for tag, _r in results]}
    else:
        accum["gcount"] += gcount
    for si, (tag, r) in enumerate(results):
        slot = accum["states"][si]
        if tag == "count":
            slot[1] = r if slot[1] is None else slot[1] + r
        elif tag == "sumcount":
            s, c = r
            if slot[1] is None:
                slot[1], slot[2] = s.copy(), c.copy()
            else:
                slot[1] += s
                slot[2] += c
        elif tag == "minmax":
            v, c = r
            if slot[1] is None:
                slot[1], slot[2] = v.copy(), c.copy()
            else:
                a = an.agg.aggs[si]
                pick = np.minimum if a.name == "min" else np.maximum
                have_old = slot[2] > 0
                have_new = c > 0
                both = have_old & have_new
                slot[1] = np.where(both, pick(slot[1], v),
                                   np.where(have_new, v, slot[1]))
                slot[2] += c
        elif tag == "argfirst":
            # r: per-group first row index in the tile (TILE if none)
            arg = an.agg.aggs[si].args[0]
            vals, valid = _resolve_first_values(table, an, arg, base0, r,
                                                r < TILE)
            if slot[1] is None:
                slot[1], slot[2] = vals, valid
            else:
                need = ~slot[2] & valid
                slot[1] = np.where(need, vals, slot[1])
                slot[2] = slot[2] | valid
    return accum


def _resolve_first_values(table, an, arg, base0, idx, have):
    sel = np.flatnonzero(have)
    G = an.num_groups
    st = arg.ftype
    if st.kind == TypeKind.STRING:
        vals = np.empty(G, dtype=object)
        vals[:] = ""
    else:
        vals = np.zeros(G, dtype=st.np_dtype)
    valid = np.zeros(G, dtype=np.bool_)
    if len(sel):
        rows = _gather_rows(table, an.scan, base0, idx[sel])
        v = arg.eval(rows)
        vals[sel] = v.data
        valid[sel] = v.validity()
    return vals, valid


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

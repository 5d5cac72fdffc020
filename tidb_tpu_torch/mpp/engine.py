"""run_mpp_join: the device-resident partitioned shuffle join engine.

Reference: TiFlash's MPP task graph — ExchangeSender hash-partitions each
plan fragment's rows, ExchangeReceiver reassembles partitions per node,
and a per-node hash join runs on co-partitioned inputs.  Here both
sides' base tables are already resident, sharded over the mesh
(`copr.parallel.MESH_CACHE`, the hot tier), the "fragments" are the
mesh's S shards, the sender/receiver pair is the bucket pack plus the
all_to_all exchange (`exchange.exchange`), and the co-partitioned local
join is argsort + searchsorted on each shard: device ops from scan to
joined rows (or partial aggregates), with overflow counts summed across
shards and read once every shard was issued.

Join-strategy ladder (README "MPP exchange engine"):

1. shuffle    — both sides hash-partitioned by join key and exchanged;
                per-(src,dst) buckets have static capacity, so skew
                overflows are detected on the card and demote to
2. broadcast  — the build side is replicated to every shard (no probe
                exchange, immune to probe skew); build sides above
                DEVICE_JOIN_BUILD_MAX skip to
3. host       — MPPIneligible is raised and the caller (MPPReaderExec)
                runs the root HashJoinExec.

A grouped aggregation whose groups blow the budget re-runs the same
rung with the aggregation peeled to a host tail (agg-peel).

MPPIneligible carries only STRUCTURAL causes (the shape or the data
layout the card cannot serve).  A runtime failure of the exchange
program, or of K1 inside it, is no such cause: device-classified errors
retry on the card through `copr.parallel._handle_mesh_failure` and then
reach the statement, as every other device path of the port does; an
open breaker raises `DeviceUnavailableError`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..chunk import Chunk, Column
from ..copr.ir import DAG, serialize_expr
from ..copr.parallel import (
    DISPATCH_LOCK,
    MAX_MESH_ATTEMPTS,
    MESH_RANGE_SLOTS,
    _check_breaker,
    _check_membership_epoch,
    _cols_env,
    _del_mask,
    _handle_mesh_failure,
    _layout,
    _mesh_masks,
    get_mesh,
    load_columns,
    local_bounds,
    statement_program,
)
from ..copr import torch_engine as te
from ..copr.torch_engine import _Analyzed, _fingerprint, _to_state_dtype
from ..copr.torch_eval import DeviceUnsupported, compile_expr
from ..metrics import REGISTRY
from ..ops.collective import first_local
from ..store.fault import FAILPOINTS
from ..store.kv import KeyRange
from ..types import TypeKind
from . import exchange as ex

# broadcast rung ceiling: replicating the build side to every shard costs
# S * build bytes of device memory; above this the only safe rung is the
# host join (same constant the planner's broadcast lookup join gates on)
from ..planner.physical import DEVICE_JOIN_BUILD_MAX  # noqa: E402


class MPPIneligible(Exception):
    """The MPP engine declines this join; the caller takes the host
    rung.  Message = reason string (surfaced in EXPLAIN ANALYZE)."""


class MPPPartitionOverflow(Exception):
    """A (source, destination) exchange bucket — or the two-pass join's
    emission buffer — exceeded its static capacity: the program dropped
    rows, so the result is incomplete and the run must step down the
    ladder."""


class MPPGroupedAggOverflow(Exception):
    """The per-shard or merged distinct-group count exceeded the runtime
    group budget: the compacted group slots hold merged garbage beyond
    the cap, so the grouped pushdown is invalid for this data.  The run
    retries with the AGG PEELED to a host tail over the device-joined
    rows (not a full host-join demotion)."""


@dataclass
class MPPJoinSide:
    """One side of the join: a scan[+selection] cop DAG over one table."""

    table_id: int
    dag: dict                   # serialized DAG (TableScanIR + SelectionIR*)
    ranges: List[KeyRange]
    key_pos: List[int]          # scan-output positions of the join key(s)
    out_ftypes: list = field(default_factory=list)  # schema ftypes by pos


@dataclass
class MPPJoinSpec:
    probe: MPPJoinSide
    build: MPPJoinSide
    kind: str                   # "inner" | "left_outer"
    probe_is_left: bool
    ts: int = 0
    # partial-agg pushdown: AggDescs over the JOINED layout (probe scan
    # positions, then build positions at probe_width+j); only set for
    # inner joins with probe_is_left
    aggs: Optional[list] = None
    # grouped partial-agg pushdown: GROUP BY expressions over the joined
    # layout; None = scalar aggregation (G=1) when aggs is set
    group_by: Optional[list] = None
    # planner's group-cardinality budget: the card detects budget
    # overflow and the run falls back to the agg-peel rung.  The STATIC
    # group capacity pow2-buckets this value; the budget itself is a
    # runtime scalar (never enters the program fingerprint)
    group_budget: int = 0
    # co-partitioned elision (PhysMPPJoin.elided): ordinal-aligned
    # (probe partition id, build partition id) pairs — the join runs per
    # pair with NO exchange between partitions (inner joins only)
    copartitions: Optional[List[Tuple[int, int]]] = None


from ..copr.cache import ProgramCache  # noqa: E402

_COMPILED = ProgramCache("mpp")

OUT_CHUNK_ROWS = 1 << 16


def _pow2ceil(n: int) -> int:
    c = 16
    while c < n:
        c <<= 1
    return c


def _slack() -> float:
    return float(os.environ.get("TIDB_TPU_MPP_SLACK", "2.0"))


def _join_slack() -> float:
    return float(os.environ.get("TIDB_TPU_MPP_JOIN_SLACK", "1.0"))


def _group_budget(spec, S: int) -> Tuple[int, int]:
    """(budget, static group capacity) of a grouped pushdown: the
    capacity pow2-buckets the budget and pads it to a multiple of S, so
    every shard emits an equal slice of the merged groups."""
    budget = (int(os.environ.get("TIDB_TPU_MPP_GROUP_BUDGET", "0"))
              or spec.group_budget or 4096)
    return budget, _group_cap(budget, S)


def _group_cap(budget: int, S: int) -> int:
    return S * (-(-_pow2ceil(budget) // S))


def group_slot_bytes(n_keys: int, state_words: int, S: int) -> int:
    """Device bytes a slot of a join tree's grouped final takes on one
    card, from `grouped_phase`'s layout in int64 words, with S shards on
    the card and w = 2 n_keys + state_words + 1 words a partial group
    (key words, their null flags, the states, the slot flag):

    - each shard's compacted partials and their first-row positions,
      then its merged groups with their spans: S (2w + 5);
    - each shard's all-gathered copy of every shard's partials, and its
      merge's sort over them (permutation, the radix sort's two
      buffers, sorted keys and flags, boundaries, segment ids and their
      prefix sum, one gathered state at a time, its prefix sum):
      S^2 (w + 2 n_keys + 10)."""
    w = 2 * n_keys + state_words + 1
    return 8 * (S * (2 * w + 5) + S * S * (w + 2 * n_keys + 10))


def state_words(aggs) -> int:
    """int64 words of the partial states `aggs` keep a group (a count
    one; a sum, an average, a min or a max its value and count)."""
    return sum(1 if a.name in ("count", "first_row") else 2 for a in aggs)


def group_limit(n_keys: int, n_state_words: int, S: int) -> int:
    """The most groups a join tree's grouped final holds on the card: the
    largest power of two whose slots (`group_slot_bytes`) take at most
    an eighth of the device's memory (off the card, of the hot tier's
    cap)."""
    per = group_slot_bytes(n_keys, n_state_words, S)
    return 1 << max((card_share_bytes() // per).bit_length() - 1, 10)


def card_share_bytes() -> int:
    """An eighth of the device's memory (off the card, of the hot tier's
    cap): what one buffer of the MPP engines may be sized to."""
    if ops.device().type == "cuda":
        mem = torch.cuda.get_device_properties(ops.device()).total_memory
    else:
        from ..layout import hot_cap_bytes

        mem = hot_cap_bytes()
    return mem // 8


class _SideState:
    """Everything one side contributes to the program: analysis, layout,
    device tensors, range bounds."""

    def __init__(self, storage, side: MPPJoinSide, ts: int, mesh):
        self.side = side
        self.mesh = mesh
        self.table = storage.table(side.table_id)
        t = self.table
        if t.base_rows == 0:
            raise MPPIneligible(f"table {side.table_id} empty")
        if t.base_ts > ts:
            raise MPPIneligible("stale snapshot")
        deleted, inserted = t.delta_overlay(ts, 0, 1 << 62)
        if inserted:
            # committed delta rows live host-side; joining them against
            # device-resident rows needs the host join
            raise MPPIneligible("delta rows present")
        self.deleted = deleted
        if any(kr.table_id != side.table_id for kr in side.ranges):
            raise MPPIneligible("partitioned ranges")
        if len(side.ranges) > MESH_RANGE_SLOTS:
            raise MPPIneligible(f"{len(side.ranges)} disjoint ranges")
        dag = DAG.from_dict(side.dag)
        try:
            self.an = _Analyzed(dag, t)
        except DeviceUnsupported as e:
            raise MPPIneligible(str(e))
        an = self.an
        if an.agg or an.topn or an.probes or an.lookups or an.projection:
            raise MPPIneligible("side DAG is not scan+selection")
        for kp in side.key_pos:
            kft = an.scan.ftypes[kp]
            if kft.kind in (TypeKind.FLOAT, TypeKind.STRING):
                raise MPPIneligible(f"non-int join key {kft.kind.name}")
        for ft in an.scan.ftypes:
            if ft.kind == TypeKind.DECIMAL and ft.is_wide_decimal:
                raise MPPIneligible("wide-decimal column")
        self.n_tiles, self.n_pad, self.Tl = _layout(t.base_rows, mesh.size,
                                                    table=t)
        self.n_local = self.Tl * te.TILE
        self.col_order = list(range(len(an.scan.columns)))
        self.bounds = [(max(kr.start, 0), min(kr.end, t.base_rows))
                       for kr in side.ranges]

    def load(self):
        """Device tensors (each an `ops.Shards` over the mesh): cached hot
        columns + deletion mask."""
        datas, valids = [], []
        for d, v in load_columns(
                self.mesh, self.table,
                [self.an.scan.columns[ci] for ci in self.col_order]):
            datas.append(d)
            valids.append(v)
        self.datas, self.valids = datas, valids
        self.wire_sig = [(str(first_local(d).dtype), v is None)
                         for d, v in zip(datas, valids)]
        self.del_mask = _del_mask(self.deleted, self.mesh, self.n_pad)

    def exchange_cols(self):
        """(scan position, env dtype itemsize) for every exchanged
        column — the bytes-metric accounting."""
        from ..copr.parallel import _full_dtype

        return [(ci, _full_dtype(self.an.scan.ftypes[ci].kind).itemsize)
                for ci in self.col_order]


def _shift_expr(e, delta: int):
    """Clone an expression with every column index shifted by `delta`
    (joined-layout indices -> one side's scan layout)."""
    return te._reindex_expr(e, lambda i: i + delta)


def _expr_refs(e) -> set:
    """Column POSITIONS an expression reads (collect_columns would
    return planner uids here — these exprs still carry them; the engine
    works in index space)."""
    from ..expr.expression import ColumnExpr

    refs: set = set()

    def walk(x):
        if isinstance(x, ColumnExpr):
            refs.add(x.index)
        for c in getattr(x, "args", ()) or ():
            walk(c)

    walk(e)
    return refs


def _computed_string_key(g) -> bool:
    from ..expr.expression import ColumnExpr

    return not isinstance(g, ColumnExpr) and (
        g.ftype.kind == TypeKind.STRING or te._string_leaf(g))


def _mpp_key_remaps(spec: MPPJoinSpec, ps: "_SideState", bs: "_SideState"):
    """Dict-code remaps for computed STRING group keys over the JOINED
    layout: each key's single source column resolves to its OWNING
    side's store and the remap builds there; the card then re-maps
    codes post-join (K1), inside the same exchange program.  Raises
    MPPIneligible (host rung) when a computed key is not remappable."""
    from ..copr import fusion

    if spec.aggs is None or spec.group_by is None:
        return None
    wp = len(ps.col_order)
    remaps = []
    for g in spec.group_by:
        if not _computed_string_key(g):
            remaps.append(None)
            continue
        refs = _expr_refs(g)
        if refs and all(i < wp for i in refs):
            st, shift = ps, 0
        elif refs and all(i >= wp for i in refs):
            st, shift = bs, wp
        else:
            raise MPPIneligible(
                f"computed group key spans both join sides: {g}")
        try:
            rm = fusion.build_key_remap(
                st.table, st.an.scan, _shift_expr(g, -shift))
        except DeviceUnsupported as e:
            raise MPPIneligible(str(e))
        remaps.append(rebased_remap(rm, rm.src_idx + shift))
    return remaps if any(r is not None for r in remaps) else None


def rebased_remap(rm, src_idx: int):
    """`rm` over another column position (the joined or slot layout).
    It shares `rm`'s device copy of the mapping, which the version
    cache of remaps keeps: a mapping crosses the link once per base
    version."""
    from ..copr import fusion

    out = fusion.KeyRemap(src_idx, rm.mapping, rm.cap, rm.out_dict)
    out._dev = rm._dev
    return out


def remap_operands(remaps, mesh) -> tuple:
    """The mapping operands on every position (an `ops.Shards` each), in
    group-key order."""
    return tuple(ops.Shards(None if d is None else r.on_device(d)
                            for d in mesh.devices)
                 for r in (remaps or ()) if r is not None)


def _compound_pack(ps: "_SideState", bs: "_SideState"):
    """(los, cards) for exact multi-column key packing, or None when the
    packed space overflows int64 (the mix-hash ladder then remains)."""
    if len(ps.side.key_pos) <= 1:
        return None

    def stats(st, kp):
        lo, hi, _null = st.table.column_stats(st.an.scan.columns[kp])
        return (lo, hi)

    pairs = [(stats(ps, kp), stats(bs, kb))
             for kp, kb in zip(ps.side.key_pos, bs.side.key_pos)]
    return ex.compound_pack_spec(pairs)


def _shard_side(an: _Analyzed, col_order, n_local: int):
    """Returns fn(s, datas, valids, del_mask, bounds) -> (cols env,
    selected row mask) for shard s of one side, evaluated pre-exchange:
    the global range bounds clip to the shard's rows [s*n_local,
    (s+1)*n_local)."""

    def prep(s, datas, valids, del_mask, bounds):
        cols = _cols_env(an, col_order, [d[s] for d in datas],
                         [None if v is None else v[s] for v in valids],
                         0, n_local)
        m = _mesh_masks(del_mask[s], local_bounds(bounds, s, n_local), 0,
                        n_local)
        for c in an.conds:
            d, v = compile_expr(c, cols, n_local)
            m = m & v & (d != 0)
        return cols, m

    return prep


def _minmax_identity(d, want_max: bool):
    """The min/max identity the scalar partials start from: +-inf for
    floats, the int64 extremes for everything else (the state widens to
    int64, as the reference's promotion does)."""
    if d.dtype.is_floating_point:
        return d, (float("inf") if not want_max else float("-inf"))
    return d.to(torch.int64), (ex.I64_MAX if not want_max
                               else -ex.I64_MAX - 1)


def scalar_partial_states(aggs, env, row_mask, n: int):
    """One shard's scalar (G=1) partial states of `aggs` over the rows
    `row_mask` keeps: count -> 0-d, sum/avg -> (sum, count), min/max ->
    ([1] partial, count)."""
    states = []
    for a in aggs:
        if a.name == "count":
            if a.args:
                _d, v = compile_expr(a.args[0], env, n)
                states.append((row_mask & v).sum())
            else:
                states.append(row_mask.sum())
            continue
        d, v = compile_expr(a.args[0], env, n)
        mv = row_mask & v
        if a.name in ("sum", "avg"):
            st = a.partial_types()[0]
            dd = _to_state_dtype(d, a.args[0].ftype, st)
            states.append((torch.where(mv, dd, torch.zeros_like(dd)).sum(),
                           mv.sum()))
        else:  # min / max
            dd, sent = _minmax_identity(d, a.name == "max")
            fill = torch.full_like(dd, sent)
            part = torch.where(mv, dd, fill)
            part = part.min() if a.name == "min" else part.max()
            states.append((part.reshape(1), mv.sum()))
    return states


def merge_scalar_states(aggs, per_shard):
    """The cross-shard merge of scalar partials (`per_shard`: None at a
    shard of another process): counts and sums add in shard order
    (`ops.psum`); min/max stay per-shard [S, 1] partials the host
    merges, as the JAX package's do."""
    per_shard = [st for st in ops.gather_shards(per_shard)
                 if st is not None]
    out = []
    for i, a in enumerate(aggs):
        rs = [st[i] for st in per_shard]
        if a.name == "count":
            out.append(ops.psum(rs))
        elif a.name in ("sum", "avg"):
            out.append((ops.psum([r[0] for r in rs]),
                        ops.psum([r[1] for r in rs])))
        else:
            out.append((ops.gather0([r[0] for r in rs]),
                        ops.psum([r[1] for r in rs])))
    return out


def grouped_phase(aggs, group_by, envs, row_masks, n: int, cap_g: int,
                  remaps, rvals, owners=None):
    """Grouped partial aggregation below the exchange, then the merge of
    every shard's partials ON the card: each shard sort-groups its `n`
    joined rows into the static cap_g budget (computed string keys
    re-map their dictionary codes with K1 first) and compacts them; the
    compacted groups are all-gathered (`exchange.replicate`), each shard
    merges them with a second sort-group (the same result on every
    shard) and emits its 1/S slice, and the slices gather on position
    0.  `envs`, `row_masks` and each `rvals` operand are per shard (None
    at a shard of another process, `owners[s]` the process of shard s).
    Returns (per-shard n_uniq, merged n_uniq, merged keys, merged
    states), the merged ones on every process."""
    from ..copr import fusion
    from ..copr.parallel import _key_device

    S = len(envs)
    nk = len(group_by)
    gchunk = cap_g // S
    outs = [None] * S
    for s, (env, row_mask) in enumerate(zip(envs, row_masks)):
        if env is None:
            continue
        key_bits, key_flags = [], []
        rslot = 0
        for gi, g in enumerate(group_by):
            rem = remaps[gi] if remaps is not None else None
            if rem is not None:
                # computed string key: post-join code-space gather
                # through the runtime mapping operand (K1)
                d0, v = env[rem.src_idx]
                d = fusion.remap_codes(d0, rvals[rslot][s], n)
                rslot += 1
            else:
                d, v = compile_expr(g, env, n)
            k = _key_device(d)
            key_bits.append(torch.where(v, k, torch.zeros_like(k)))
            key_flags.append(v.to(torch.int64))
        order, sm, skeys, seg, pos, n_uniq = fusion.sort_group_segments(
            key_bits, key_flags, row_mask, cap_g)
        states = fusion.grouped_partial_states(
            aggs, lambda e, env=env: compile_expr(e, env, n), order, sm,
            seg, cap_g)
        slot_ok = (torch.arange(cap_g, dtype=torch.int64,
                                device=row_mask.device)
                   < torch.clamp(n_uniq, max=cap_g))
        outs[s] = (n_uniq, [k[pos] for k in skeys], states, slot_ok)

    def rep(get):
        return ex.replicate([None if o is None else get(o) for o in outs],
                            owners)

    g_keys = [rep(lambda o, i=i: o[1][i]) for i in range(2 * nk)]
    g_ok = rep(lambda o: o[3])
    g_states = []
    for i, st in enumerate(first_local(outs)[2]):
        if isinstance(st, tuple):
            g_states.append(tuple(rep(lambda o, i=i, j=j: o[2][i][j])
                                  for j in range(len(st))))
        else:
            g_states.append(rep(lambda o, i=i: o[2][i]))
    m_slices = [None] * S
    mn_uniq = None
    for d in range(S):
        if outs[d] is None:
            continue
        mn, m_keys, m_states = fusion.merge_grouped_partials(
            aggs, [k[d] for k in g_keys[:nk]], [k[d] for k in g_keys[nk:]],
            g_ok[d],
            [tuple(x[d] for x in st) if isinstance(st, tuple) else st[d]
             for st in g_states], cap_g)
        if mn_uniq is None:
            mn_uniq = mn

        def slc(y, d=d):
            return y[d * gchunk:(d + 1) * gchunk]

        m_slices[d] = ([slc(k) for k in m_keys],
                       [tuple(slc(x) for x in st) if isinstance(st, tuple)
                        else slc(st) for st in m_states])
    # every shard's slice, in shard order, on the first local position
    m_slices = ops.gather_shards(m_slices)
    m_keys = [_gather_slices([m[0][i] for m in m_slices])
              for i in range(len(m_slices[0][0]))]
    m_states = []
    for i, st in enumerate(m_slices[0][1]):
        if isinstance(st, tuple):
            m_states.append(tuple(_gather_slices([m[1][i][j]
                                                  for m in m_slices])
                                  for j in range(len(st))))
        else:
            m_states.append(_gather_slices([m[1][i] for m in m_slices]))
    return [None if o is None else o[0] for o in outs], mn_uniq, m_keys, \
        m_states


def _gather_slices(parts):
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts])


def _build_mpp_fn(spec: MPPJoinSpec, ps: _SideState, bs: _SideState,
                  mode: str, S: int, cap_p: int, cap_b: int, cap_out: int,
                  cap_g: int, pack=None, remaps=None, local=None,
                  owners=None):
    """The exchange program over the mesh's S shards: scan+filter on both
    sides per shard, partition exchange (all_to_all) or build broadcast
    (all_gather), the two-pass count+emit local join on each shard
    (non-unique and multi-column keys), then row emission, scalar
    partial aggregation (summed across shards), or grouped partial
    aggregation merged ON the card, so only O(G) group rows leave.

    `pack` = (los, cards) composes multi-column keys EXACTLY (stride
    packing over the union of both sides' column stats): no collision
    re-verify, and left-outer multi-key joins become sound on the card.
    `remaps` carries per-group-key dict-code remaps (computed string
    keys); their mapping operands ride the trailing runtime args.

    fn(p_datas, p_valids, p_del, p_bounds, b_datas, b_valids, b_del,
    b_bounds, *extra) — column operands `ops.Shards`, bounds global —
    returns (flags, payload): `flags` is one int64 tensor [partition
    overflow, emission overflow] (+ [per-shard group overflow, merged
    group overflow, merged groups] when grouped), summed across shards,
    that the host reads in ONE transfer; the payload stays on the card
    (rows: one (keep, flat) a shard)."""
    p_an, b_an = ps.an, bs.an
    # capture ONLY scalars/analysis objects in the closure: the program
    # lives in _COMPILED, and closing over the _SideState objects would
    # pin both sides' device tensors against any cache eviction
    p_order, b_order = list(ps.col_order), list(bs.col_order)
    p_key_pos = list(ps.side.key_pos)
    b_key_pos = list(bs.side.key_pos)
    p_prep = _shard_side(p_an, p_order, ps.n_local)
    b_prep = _shard_side(b_an, b_order, bs.n_local)
    louter = spec.kind == "left_outer"
    aggs = spec.aggs
    group_by = spec.group_by
    grouped = aggs is not None and group_by is not None
    # this process's shards (all of them when it runs alone); every
    # per-shard list below is S long with None at the others
    shards = tuple(range(S)) if local is None else tuple(local)
    n_barr = 1 + 2 * len(b_order)
    n_parr = 2 + 2 * len(p_order)

    def mk_keys(cols_env, key_pos):
        """(join key, partition key): the join key is the EXACT packed
        composition when `pack` is set (mix-hash otherwise); the
        partition key is ALWAYS the mix-hash, and both sides agree on it
        either way."""
        keys = [cols_env[kp][0].to(torch.int64) for kp in key_pos]
        mix = ex.combine_keys(keys)
        if pack is not None:
            return ex.pack_keys_exact(keys, pack[0], pack[1]), mix
        return mix, mix

    def key_valid(cols_env, key_pos):
        kv = cols_env[key_pos[0]][1]
        for kp in key_pos[1:]:
            kv = kv & cols_env[kp][1]
        return kv

    def prog(p_datas, p_valids, p_del, p_bounds,
             b_datas, b_valids, b_del, b_bounds, *extra):
        gbudget = extra[0] if grouped else None
        rvals = extra[1:] if grouped else ()

        # ---- build side: filter, partition, exchange ------------------
        b_arrays, bsels, bmixes = [None] * S, [None] * S, [None] * S
        for s in shards:
            b_cols, bm = b_prep(s, b_datas, b_valids, b_del, b_bounds)
            bk, bmix = mk_keys(b_cols, b_key_pos)
            # NULL keys never match
            bsels[s] = bm & key_valid(b_cols, b_key_pos)
            bmixes[s] = bmix
            arrs = [bk]
            for ci in b_order:
                d, v = b_cols[ci]
                arrs.append(d)
                arrs.append(v)
            b_arrays[s] = arrs
        zero = torch.zeros((), dtype=torch.int64,
                           device=bsels[shards[0]].device)
        if mode == "shuffle":
            recv_b, b_ok, b_over = ex.shuffle(b_arrays, bsels, bmixes,
                                              cap_b, owners)
        else:  # broadcast: replicate the whole filtered build side
            recv_b = [ex.replicate(ex.pick(b_arrays, i), owners)
                      for i in range(n_barr)]
            b_ok = ex.replicate(bsels, owners)
            b_over = zero
        builds = {d: ex.sorted_build(recv_b[0][d], b_ok[d]) for d in shards}

        # ---- probe side ----------------------------------------------
        p_arrays, psels, pmixes = [None] * S, [None] * S, [None] * S
        for s in shards:
            p_cols, pm = p_prep(s, p_datas, p_valids, p_del, p_bounds)
            pk, pmix = mk_keys(p_cols, p_key_pos)
            pk_v = key_valid(p_cols, p_key_pos)
            # left outer keeps NULL-key probe rows (they emit with NULL
            # build cols); inner drops them pre-exchange
            psels[s] = pm if louter else pm & pk_v
            pmixes[s] = torch.where(pk_v, pmix, torch.zeros_like(pmix))
            arrs = [torch.where(pk_v, pk, torch.zeros_like(pk)), pk_v]
            for ci in p_order:
                d, v = p_cols[ci]
                arrs.append(d)
                arrs.append(v)
            p_arrays[s] = arrs
        if mode == "shuffle":
            recv_p, p_ok, p_over = ex.shuffle(p_arrays, psels, pmixes,
                                              cap_p, owners)
        else:  # probe rows stay local on the broadcast rung
            recv_p = [ex.pick(p_arrays, i) for i in range(n_parr)]
            p_ok = psels
            p_over = zero

        # ---- two-pass count+emit local join, shard by shard ----------
        overflow = b_over + p_over.to(b_over.device)
        j_overs, rows, envs, row_masks = [None] * S, [None] * S, \
            [None] * S, [None] * S
        for d in shards:
            sbk, bord, nb = builds[d]
            rpk, rpk_v = recv_p[0][d], recv_p[1][d]
            src, bidx, out_valid, matched, j_over = ex.expand_matches(
                sbk, bord, nb, rpk, p_ok[d], rpk_v & p_ok[d], cap_out,
                louter)
            j_overs[d] = j_over
            probe_out = [(recv_p[2 + 2 * j][d][src],
                          recv_p[3 + 2 * j][d][src])
                         for j in range(len(p_order))]
            hit = matched
            if len(p_key_pos) > 1 and pack is None:
                # multi-column keys exchange/sort on a MIX-HASH:
                # candidate spans can hold colliding unequal keys, so
                # re-verify TRUE per-column equality before any row counts
                for kp, kb in zip(p_key_pos, b_key_pos):
                    jp = p_order.index(kp)
                    jb = b_order.index(kb)
                    hit = hit & (probe_out[jp][0].to(torch.int64)
                                 == recv_b[1 + 2 * jb][d][bidx].to(
                                     torch.int64))
            build_out = [(recv_b[1 + 2 * j][d][bidx],
                          hit & recv_b[2 + 2 * j][d][bidx])
                         for j in range(len(b_order))]
            if aggs is None:
                keep = out_valid if louter else out_valid & hit
                rows[d] = (keep, probe_out + build_out)
                continue
            # ---- partial aggregation (inner join only) ---------------
            wp = len(p_order)
            env = {ci: probe_out[j] for j, ci in enumerate(p_order)}
            for j in range(len(b_order)):
                env[wp + j] = build_out[j]
            envs[d] = env
            row_masks[d] = out_valid & hit
        j_over = ops.psum(ops.gather_shards(j_overs)).to(overflow.device)

        if aggs is None:
            return torch.stack([overflow, j_over]), rows
        if grouped:
            n_uniqs, mn_uniq, m_keys, m_states = grouped_phase(
                aggs, group_by, envs, row_masks, cap_out, cap_g, remaps,
                rvals, owners)
            # the BUDGET is a runtime scalar: overflow is detected on the
            # card against it, but only the pow2 capacity shapes the
            # program
            over_l = ops.psum(ops.gather_shards(
                [None if n is None else torch.clamp(n - gbudget, min=0)
                 for n in n_uniqs]))
            over_m = torch.clamp(mn_uniq - gbudget, min=0)
            dev0 = overflow.device
            return (torch.stack([overflow, j_over, over_l.to(dev0),
                                 over_m.to(dev0), mn_uniq.to(dev0)]),
                    (m_keys, m_states))
        return (torch.stack([overflow, j_over]), merge_scalar_states(
            aggs, [None if env is None
                   else scalar_partial_states(aggs, env, rm, cap_out)
                   for env, rm in zip(envs, row_masks)]))

    return prog


# ---------------------------------------------------------------------------
# host-side assembly
# ---------------------------------------------------------------------------


def _to_column(table, an: _Analyzed, pos: int, ft, data: np.ndarray,
               valid: np.ndarray) -> Column:
    """Device env array (widened dtype) -> host Column of `ft`, decoding
    dictionary codes for STRING columns through the side's own store."""
    if ft.kind == TypeKind.STRING:
        from ..store.blockstore import _decode_dict

        store_ci = an.scan.columns[pos]
        obj = _decode_dict(data.astype(np.int64),
                           table.cols[store_ci].dictionary)
        return Column(ft, obj, valid)
    return Column(ft, data.astype(ft.np_dtype), valid)


def select_rows(rows):
    """The kept rows of every (data, valid) pair of every shard, selected
    on each shard's device and read back in shard order: one numpy
    (data, valid) pair a column.  `rows` holds one (keep, [(data, valid),
    ...]) a shard (None at a shard of another process, whose selected
    rows are gathered)."""
    def local(keep, flat):
        sel = torch.nonzero(keep).reshape(-1)
        return [(d[sel].cpu().numpy(), v[sel].cpu().numpy())
                for d, v in flat]

    per = [p for p in ops.gather_shards(
        [None if r is None else local(*r) for r in rows]) if p is not None]
    if len(per) == 1:
        return per[0]
    return [(np.concatenate([p[j][0] for p in per]),
             np.concatenate([p[j][1] for p in per]))
            for j in range(len(per[0]))]


def _assemble_rows(spec: MPPJoinSpec, ps: _SideState, bs: _SideState,
                   rows) -> List[Chunk]:
    louter = spec.kind == "left_outer"
    wp = len(ps.col_order)
    host = select_rows(rows)
    probe_cols, build_cols = [], []
    for j, ci in enumerate(ps.col_order):
        d, v = host[j]
        ft = spec.probe.out_ftypes[ci]
        probe_cols.append(_to_column(ps.table, ps.an, ci, ft, d,
                                     v.astype(np.bool_)))
    for j, ci in enumerate(bs.col_order):
        d, v = host[wp + j]
        ft = spec.build.out_ftypes[ci]
        if louter:
            ft = ft.with_nullable(True)
        build_cols.append(_to_column(bs.table, bs.an, ci, ft, d,
                                     v.astype(np.bool_)))
    cols = (probe_cols + build_cols if spec.probe_is_left
            else build_cols + probe_cols)
    big = Chunk(cols)
    return [c for c in big.split(OUT_CHUNK_ROWS) if c.num_rows]


def read_scalars(states) -> list:
    """Scalar partial states (0-d or [1] tensors, nested in tuples) read
    back in one transfer per dtype; the same nesting of numpy values."""
    flat = []

    def walk(s):
        if isinstance(s, tuple):
            for x in s:
                walk(x)
        else:
            flat.append(s)

    for s in states:
        walk(s)
    by_dtype: dict = {}
    for i, t in enumerate(flat):
        by_dtype.setdefault(t.dtype, []).append(i)
    host = [None] * len(flat)
    for idx in by_dtype.values():
        vals = torch.cat([flat[i].reshape(-1) for i in idx]).cpu().numpy()
        off = 0
        for i in idx:
            k = flat[i].numel()
            host[i] = vals[off:off + k] if flat[i].dim() else vals[off]
            off += k
    it = iter(host)

    def rebuild(s):
        if isinstance(s, tuple):
            return tuple(rebuild(x) for x in s)
        return next(it)

    return [rebuild(s) for s in states]


def _assemble_partials(aggs, states) -> List[Chunk]:
    """Per-agg partial states (read back by read_scalars) -> ONE partial
    row in the same [states...] layout the cop partial-agg paths emit
    (the root final HashAgg merges it)."""
    cols: List[Column] = []
    for a, st in zip(aggs, states):
        pts = a.partial_types()
        if a.name == "count":
            cols.append(Column(pts[0], np.array([int(st)], np.int64)))
        elif a.name in ("sum", "avg"):
            sm, c = st
            c = int(c)
            cols.append(Column(pts[0],
                               np.array([sm]).astype(pts[0].np_dtype),
                               np.array([c > 0])))
            if a.name == "avg":
                cols.append(Column(pts[1], np.array([c], np.int64)))
        else:  # min / max: merge the per-shard partials host-side
            part, c = st
            c = int(c)
            v = part.min() if a.name == "min" else part.max()
            cols.append(Column(pts[0],
                               np.array([v]).astype(pts[0].np_dtype),
                               np.array([c > 0])))
    return [Chunk(cols)]


def read_groups(k: int, keys, states):
    """The first `k` merged groups' keys and states, read back."""
    keys = [t[:k].cpu().numpy() for t in keys]
    states = [tuple(x[:k].cpu().numpy() for x in s) if isinstance(s, tuple)
              else s[:k].cpu().numpy() for s in states]
    return keys, states


def assemble_grouped(aggs, group_by, k: int, keys, states, remaps,
                     decode_string) -> List[Chunk]:
    """Device-merged grouped partials (read back) -> ONE partial chunk in
    the [keys..., states...] layout the root final HashAgg merges.
    Computed-key codes decode through the remap's OUTPUT dictionary;
    plain string keys through `decode_string(g, codes)`, which resolves
    the owning side's store."""
    from ..store.blockstore import _decode_dict

    nk = len(group_by)
    cols: List[Column] = []
    for i, g in enumerate(group_by):
        bits = keys[i][:k]
        flags = keys[nk + i][:k].astype(np.bool_)
        ft = g.ftype
        rem = remaps[i] if remaps is not None else None
        if rem is not None and rem.out_dict is not None:
            # INT-valued remaps carry the computed values in the key
            # bits directly
            data = _decode_dict(bits.astype(np.int64), rem.out_dict)
        elif ft.kind == TypeKind.FLOAT:
            data = bits.astype(np.float64, copy=False)
        elif ft.kind == TypeKind.STRING:
            data = decode_string(g, bits.astype(np.int64))
        else:
            data = bits.astype(ft.np_dtype)
        cols.append(Column(ft, data, flags if not flags.all() else None))
    for a, st in zip(aggs, states):
        pts = a.partial_types()
        if a.name == "count":
            cols.append(Column(pts[0], st[:k].astype(np.int64)))
        elif a.name in ("sum", "avg"):
            s, c = st[0][:k], st[1][:k]
            cols.append(Column(pts[0], s.astype(pts[0].np_dtype), c > 0))
            if a.name == "avg":
                cols.append(Column(pts[1], c.astype(np.int64)))
        else:  # min / max (value, count) — already merged across shards
            v, c = st[0][:k], st[1][:k]
            cols.append(Column(pts[0], v.astype(pts[0].np_dtype), c > 0))
    chunk = Chunk(cols)
    return [chunk] if chunk.num_rows else []


def _assemble_grouped(spec: MPPJoinSpec, ps: _SideState, bs: _SideState,
                      k: int, keys, states, remaps=None) -> List[Chunk]:
    """String group keys come back as dictionary codes and decode
    through the OWNING side's store (probe scan positions < probe width,
    build positions above)."""
    from ..store.blockstore import _decode_dict

    wp = len(ps.col_order)

    def decode_string(g, codes):
        st, ci = (ps, g.index) if g.index < wp else (bs, g.index - wp)
        store_ci = st.an.scan.columns[ci]
        return _decode_dict(codes, st.table.cols[store_ci].dictionary)

    keys, states = read_groups(k, keys, states)
    return assemble_grouped(spec.aggs, spec.group_by, k, keys, states,
                            remaps, decode_string)


def grouped_pushdown_enabled() -> bool:
    """The one home of the TIDB_TPU_MPP_GROUPED knob (the planner's
    pushdown gate and the engine's force-peel comparator both read it):
    default on, "0" disables."""
    return os.environ.get("TIDB_TPU_MPP_GROUPED", "1") != "0"


def _host_grouped_partials(spec: MPPJoinSpec,
                           chunks: List[Chunk]) -> List[Chunk]:
    """The agg-peel rung's host tail: grouped PARTIAL aggregation over
    the device-joined row chunks (the join stayed on the card; only the
    blown-budget agg moved to the host).  Per-chunk partials are fine —
    the parent is a FINAL HashAgg and merges groups across chunks."""
    from ..copr.cpu_engine import grouped_partial_chunks

    REGISTRY.inc("host_join_rows_total", sum(c.num_rows for c in chunks))
    return grouped_partial_chunks(spec.group_by, spec.aggs, chunks)


def read_flags(flags) -> List[int]:
    """The program's overflow scalars, in one transfer."""
    return [int(x) for x in flags.cpu().tolist()]


def _exchange_bytes(mode: str, ps: _SideState, bs: _SideState,
                    cap_p: int, cap_b: int, S: int) -> int:
    """Exchange traffic the program moved (static shapes)."""
    if mode == "shuffle":
        per_pair = 8 + 1  # key + bucket validity
        for _ci, isz in ps.exchange_cols():
            per_pair += isz + 1
        nbytes = S * S * cap_p * per_pair + S * S * cap_p  # + key-valid
        per_pair_b = 8 + 1
        for _ci, isz in bs.exchange_cols():
            per_pair_b += isz + 1
        return nbytes + S * S * cap_b * per_pair_b
    per_row = 8 + 1
    for _ci, isz in bs.exchange_cols():
        per_row += isz + 1
    return S * S * bs.n_local * per_row


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def _run_once(storage, spec: MPPJoinSpec, mode: str) -> List[Chunk]:
    from ..copr.device_health import DEVICE_HEALTH
    from ..lifecycle import dispatch_admission
    from ..trace import annotate

    mesh = get_mesh()
    S = mesh.size
    mesh_ids = mesh.ids
    ps = _SideState(storage, spec.probe, spec.ts, mesh)
    bs = _SideState(storage, spec.build, spec.ts, mesh)
    if mode == "broadcast" and bs.table.base_rows > DEVICE_JOIN_BUILD_MAX:
        raise MPPIneligible(
            f"build side {bs.table.base_rows} rows exceeds broadcast cap")
    slack = _slack()
    cap_p = min(_pow2ceil(int(slack * ps.n_local / S) + 1), ps.n_local)
    cap_b = min(_pow2ceil(int(slack * bs.n_local / S) + 1), bs.n_local)
    # two-pass join emission buffer: sized to the received probe rows
    # times TIDB_TPU_MPP_JOIN_SLACK (>1 buys headroom for duplicate-key
    # expansion; emission overflow steps down the ladder)
    n_recv = S * cap_p if mode == "shuffle" else ps.n_local
    cap_out = max(int(_join_slack() * n_recv), 16)
    grouped = spec.aggs is not None and spec.group_by is not None
    budget, cap_g = _group_budget(spec, S) if grouped else (0, 0)

    # exact compound-key packing for multi-column keys: the union of both
    # sides' column stats strides every key into ONE int64, so equality
    # is exact and LEFT-OUTER multi-key joins are sound on the card; an
    # overflowing key space keeps the mix-hash (inner-only — left-outer
    # then takes the host rung)
    pack = _compound_pack(ps, bs)
    if (spec.kind == "left_outer" and len(spec.probe.key_pos) > 1
            and pack is None):
        raise MPPIneligible(
            "multi-key left-outer join needs exact compound ordering "
            "(packed key space exceeds int64)")
    # computed STRING group keys -> per-side dict-code remaps (runtime
    # mapping operands; MPPIneligible when not remappable)
    remaps = _mpp_key_remaps(spec, ps, bs)

    # column tensors load before the program lookup (programs are
    # specialized on wire dtypes / null patterns, like the mesh scan)
    ps.load()
    bs.load()

    agg_sig = ""
    if spec.aggs is not None:
        agg_sig = json.dumps(
            [[a.name] + [serialize_expr(x) for x in a.args]
             for a in spec.aggs], sort_keys=True)
    group_sig = ""
    if grouped:
        group_sig = json.dumps(
            [serialize_expr(g) for g in spec.group_by], sort_keys=True)
    fp = (f"mpp|{mode}|{spec.kind}|pil={spec.probe_is_left}"
          f"|S={S} devs={mesh_ids}@{mesh.where}"
          f" caps={cap_p},{cap_b},{cap_out}"
          f"|p:{_fingerprint(ps.an, 'filter')}|Tl={ps.Tl}"
          f"|k={spec.probe.key_pos}|wire={ps.wire_sig}"
          f"|b:{_fingerprint(bs.an, 'filter')}|Tl={bs.Tl}"
          f"|k={spec.build.key_pos}|wire={bs.wire_sig}"
          f"|aggs={agg_sig}|gb={group_sig}|capg={cap_g}"
          f"|pack={pack}"
          + (f"|rcaps={[r.cap if r else None for r in remaps]}"
             if remaps else ""))
    fn = _COMPILED.get(fp)
    if fn is None:
        fn = _build_mpp_fn(spec, ps, bs, mode, S, cap_p, cap_b, cap_out,
                           cap_g, pack=pack, remaps=remaps,
                           local=mesh.local, owners=mesh.owners)
        _COMPILED.put(fp, fn)

    # deterministic mid-shuffle fault injection (chaos harness): fires
    # after both sides are device-resident, before the exchange program
    FAILPOINTS.hit("mpp/exchange", mode=mode, device_ids=mesh_ids,
                   kind=spec.kind)
    if grouped:
        # chaos site for the grouped-agg overflow rung: an armed action
        # raises MPPGroupedAggOverflow, driving the same agg-peel path a
        # genuine on-card budget overflow takes
        FAILPOINTS.hit("mpp/grouped_agg_overflow", mode=mode,
                       budget=budget, cap_g=cap_g)

    args = (ps.datas, ps.valids, ps.del_mask, ps.bounds,
            bs.datas, bs.valids, bs.del_mask, bs.bounds)
    if grouped:
        args = args + (budget,) + remap_operands(remaps, mesh)
    # dispatch-time membership guard: a membership move between the mesh
    # build and this exchange raises the typed retriable
    # CoordEpochMismatch; the rung loop rebuilds and re-runs
    _check_membership_epoch()
    with dispatch_admission(DISPATCH_LOCK):
        # admission charges the exchange's device time to the
        # statement's resource group: the flags' readback waits for it
        flags, payload = fn(*args)
        flags = read_flags(flags)
        if spec.aggs is not None and not grouped:
            payload = read_scalars(payload)
    overflow, jover = flags[0], flags[1]
    if overflow:
        raise MPPPartitionOverflow(
            f"{overflow} rows over per-partition capacity "
            f"(cap_p={cap_p}, cap_b={cap_b}, mode={mode})")
    if jover:
        raise MPPPartitionOverflow(
            f"{jover} joined rows over the emission buffer "
            f"(cap_out={cap_out}, mode={mode}): duplicate-key expansion "
            "outgrew the two-pass emit budget")
    if grouped:
        over_l, over_m = flags[2], flags[3]
        if over_l or over_m:
            raise MPPGroupedAggOverflow(
                f"distinct groups over budget {budget} "
                f"(per-shard over {over_l}, merged over {over_m})")

    nbytes = _exchange_bytes(mode, ps, bs, cap_p, cap_b, S)
    REGISTRY.inc("mpp_exchange_bytes_total", float(nbytes))
    annotate(bytes=nbytes, device_ids=list(mesh_ids))
    DEVICE_HEALTH.record_success(mesh_ids)
    if grouped:
        REGISTRY.inc("mpp_grouped_agg_pushed_total")
        annotate(groups=flags[4], group_budget=budget)
        return _assemble_grouped(spec, ps, bs, flags[4], payload[0],
                                 payload[1], remaps=remaps)
    if spec.aggs is not None:
        return _assemble_partials(spec.aggs, payload)
    return _assemble_rows(spec, ps, bs, payload)


def run_mpp_join(storage, spec: MPPJoinSpec) -> Tuple[List[Chunk], str]:
    """`_run_mpp_join` in one program across processes."""
    with statement_program("mpp", spec.kind, [
            (sd.table_id, sd.dag, sd.key_pos)
            for sd in (spec.probe, spec.build)]):
        return _run_mpp_join(storage, spec)


def _run_mpp_join(storage, spec: MPPJoinSpec) -> Tuple[List[Chunk], str]:
    """Run the join on the card; (chunks, mode) on success, raises
    MPPIneligible when the host rung must serve it (a structural cause
    only).  Overflow steps down the ladder internally; a device runtime
    failure retries on the card, then reaches the statement.

    Grouped pushdown has its own fallback rung: a group-budget overflow
    retries the SAME join rung with the aggregation PEELED to a host
    tail over the device-joined rows (mode suffix "+agg-peel"); a
    successful grouped pushdown reports mode suffix "+grouped"."""
    import dataclasses

    from ..coord import CoordEpochMismatch
    from ..errors import TiDBTPUError
    from ..lifecycle import current_scope
    from ..trace import annotate, span

    mode = "shuffle"
    attempts = 0
    # TIDB_TPU_MPP_GROUPED=0 forces the agg-peel rung from the start:
    # the join still runs on the card, every joined row ships to the
    # host and aggregates there — the bench's host-merge comparator
    peel = (spec.group_by is not None and spec.aggs is not None
            and not grouped_pushdown_enabled())
    while True:
        # cancellation seam at every rung transition/retry: a cancelled
        # statement must not start the next exchange program
        FAILPOINTS.hit("exec/cancel", site="mpp", scope=current_scope())
        current_scope().check()
        _check_breaker()
        run_spec = spec
        if peel:
            # the join stays on the card; only the agg leaves for the host
            run_spec = dataclasses.replace(spec, aggs=None, group_by=None)
        try:
            with span("mpp.exchange", rung=mode, kind=spec.kind,
                      grouped=bool(spec.group_by), peel=peel):
                chunks = _run_once(storage, run_spec, mode)
            if peel:
                with span("mpp.agg_peel", rung=mode):
                    chunks = _host_grouped_partials(spec, chunks)
                mode = mode + "+agg-peel"
            elif spec.group_by is not None and spec.aggs is not None:
                mode = mode + "+grouped"
            REGISTRY.inc("mpp_joins_total")
            # rung suffixes use '+'/'-' for human surfaces (EXPLAIN
            # ANALYZE); metric names must stay in the Prometheus
            # grammar [a-zA-Z0-9_:] or the whole /metrics scrape fails
            REGISTRY.inc("mpp_joins_"
                         + mode.replace("+", "_").replace("-", "_")
                         + "_total")
            return chunks, mode
        except MPPGroupedAggOverflow as e:
            REGISTRY.inc("mpp_grouped_agg_overflow_total")
            REGISTRY.inc("mpp_grouped_agg_fallback_total")
            annotate(grouped_agg_overflow=str(e)[:120])
            peel = True
            continue
        except MPPPartitionOverflow as e:
            REGISTRY.inc("mpp_partition_overflow_total")
            if mode == "shuffle":
                mode = "broadcast"  # immune to probe-side skew
                continue
            raise MPPIneligible(f"partition overflow: {e}")
        except CoordEpochMismatch:
            # membership moved between the mesh build and the exchange:
            # rebuild from the new broadcast and re-run the same rung
            if attempts + 1 >= MAX_MESH_ATTEMPTS:
                raise
            attempts += 1
        except (MPPIneligible, KeyboardInterrupt, SystemExit,
                GeneratorExit, TiDBTPUError):
            # semantic errors (kill/quota/lock) keep their meaning; they
            # are never device-health events
            raise
        except BaseException as e:
            if not _handle_mesh_failure(None, e, attempts):
                raise
            attempts += 1

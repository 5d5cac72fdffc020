"""Multi-way device-resident join pipelines: the rung-ladder engine.

The execution half of join-tree compilation.  The planner's join-tree
compiler (planner/jointree.py) orders an n-way equi-join graph and emits
an `MPPJoinTreeSpec`: a base side plus a ladder of RUNGS, each joining
the current intermediate result against one more scan side.  This
module runs that ladder on the card:

- every rung is ONE exchange program (partition/exchange the
  intermediate by the rung's key, filter+partition the build side,
  two-pass count+emit local join — the exchange/local-join primitives
  of mpp/exchange.py);
- the intermediate result BETWEEN rungs is a set of device tensors (one
  (data, validity) pair per joined column plus a live-row mask, one
  tensor a mesh shard): it never leaves the mesh, so a k-way join is k
  dispatches with ZERO host transfers between them (trace-asserted: no
  `copr.transfer` spans between `mpp.rung` spans on a warm cache);
- semi / anti-semi rungs (decorrelated EXISTS/IN subqueries) filter the
  intermediate in place — a single searchsorted span-count when the key
  is single-column and unconditioned, the full pair expansion when
  correlated other-conds must evaluate per candidate pair;
- the final phase either reads the joined rows back, or runs the
  scalar/grouped partial aggregation ON the card (the sort-group +
  merge emitters) so only O(G) rows leave.

Each rung runs in two halves inside one hold of the device door: the
count half exchanges, sorts the build side and counts each shard's
emission; the host reads those counts back (one small tensor) and the
emit half expands into a buffer of the next power of two of the largest,
so the next rung and the final run over the live rows.  A blown
exchange bucket retries THAT RUNG on the broadcast strategy (build side
replicated, intermediate stays local); past that, an emission larger
than the card's share holds, or any structural ineligibility,
MPPIneligible is raised and the caller (MPPTreeReaderExec,
mpp/reader.py) runs the same ladder as chained host hash joins.  The
grouped final is sized from the rows the ladder joined and regrown on
the card when its groups outrun it; only past the card's group limit
does the agg peel to a host tail over the device-joined rows, like the
two-table engine's agg-peel rung.  A device runtime failure retries on
the card, then reaches the statement.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..chunk import Chunk, Column
from ..copr.ir import deserialize_expr, serialize_expr
from ..copr.parallel import (
    DISPATCH_LOCK,
    MAX_MESH_ATTEMPTS,
    _check_breaker,
    _check_membership_epoch,
    _handle_mesh_failure,
    get_mesh,
    statement_program,
)
from ..copr.torch_engine import (_fingerprint, _reindex_expr,
                                 rewrite_for_dict_resolved)
from ..copr.torch_eval import DeviceUnsupported
from ..metrics import REGISTRY
from ..store.fault import FAILPOINTS
from ..types import TypeKind
from . import exchange as ex
from .engine import (
    _COMPILED,
    MPPGroupedAggOverflow,
    MPPIneligible,
    MPPJoinSide,
    OUT_CHUNK_ROWS,
    _computed_string_key,
    _expr_refs,
    _group_budget,
    _group_cap,
    _pow2ceil,
    _shard_side,
    _SideState,
    _assemble_partials,
    card_share_bytes,
    _slack,
    assemble_grouped,
    grouped_phase,
    group_limit,
    grouped_pushdown_enabled,
    merge_scalar_states,
    read_flags,
    read_groups,
    read_scalars,
    rebased_remap,
    remap_operands,
    scalar_partial_states,
    select_rows,
    state_words,
)

#: chaos site: fires before each rung's exchange program (armed actions
#: inject device failures / overflow mid-ladder)
TREE_FAILPOINT = "mpp/tree_rung"


class MPPTreeOverflow(Exception):
    """One rung's exchange bucket or emission buffer blew its static
    capacity; carries the rung index and which capacity blew so the
    ladder can step down THAT rung (partition overflow -> broadcast).
    The emission buffer is sized from the rung's own count pass, so an
    emission overflow means the two halves disagreed: the host chain
    serves the statement."""

    def __init__(self, rung: int, what: str, msg: str):
        super().__init__(msg)
        self.rung = rung
        self.what = what  # "partition" | "emit"


@dataclass
class TreeRung:
    """One ladder step: join the current intermediate against a side."""

    side: int                 # ordinal into MPPJoinTreeSpec.sides
    kind: str                 # inner | left_outer | semi | anti_semi
    left_slots: List[int]     # intermediate slot indices of the join keys
    build_key_pos: List[int]  # scan positions of the build-side keys
    # extra join conditions over the PAIR layout [slots..., build cols at
    # n_slots+j]; evaluated per candidate pair on the card
    other_conds: List = field(default_factory=list)
    est_rows: float = 0.0     # planner estimate (EXPLAIN + budget sizing)


@dataclass
class MPPJoinTreeSpec:
    sides: List[MPPJoinSide]       # join order; side 0 is the base
    rungs: List[TreeRung]          # rung k joins sides[rungs[k].side]
    # final intermediate layout: per slot the (side ordinal, scan pos)
    # that produced it — slots appear in join order, semi/anti sides
    # contribute none
    slot_src: List[Tuple[int, int]]
    out_slots: List[int]           # rows mode: slots in output order
    out_ftypes: list               # ftypes aligned with out_slots
    ts: int = 0
    # final partial aggregation over the slot layout (positions = slots)
    aggs: Optional[list] = None
    group_by: Optional[list] = None
    group_budget: int = 0
    # ([(kind "key" | "agg", index, desc)], k): only the k merged groups
    # that lead by these items leave the card
    topn: Optional[tuple] = None


# ---------------------------------------------------------------------------
# slot bookkeeping
# ---------------------------------------------------------------------------


def _slots_of_prefix(spec: MPPJoinTreeSpec, upto_rung: int) -> int:
    """Slot count available BEFORE rung `upto_rung` runs."""
    n = len(spec.sides[0].out_ftypes)
    for r in range(upto_rung):
        rung = spec.rungs[r]
        if rung.kind in ("inner", "left_outer"):
            n += len(spec.sides[rung.side].out_ftypes)
    return n


def _slot_resolver(spec: MPPJoinTreeSpec, states, n_slots: int,
                   build_state=None):
    """Pair-layout column resolver for rewrite_for_dict_resolved: slots
    resolve through slot_src to their owning side's (table, scan); the
    tail past n_slots is the active rung's build side."""

    def resolve(idx: int):
        if 0 <= idx < n_slots:
            side, sp = spec.slot_src[idx]
            st = states[side]
            return st.table, st.an.scan, sp
        if build_state is not None:
            sp = idx - n_slots
            if 0 <= sp < len(build_state.an.scan.columns):
                return build_state.table, build_state.an.scan, sp
        return None

    return resolve


# ---------------------------------------------------------------------------
# per-rung program
# ---------------------------------------------------------------------------


def _fast_filter(rung: TreeRung, conds_rw) -> bool:
    """The span-count path: a semi/anti rung on a single-column key
    (exact equality after combine_keys' identity) with no pair-level
    conditions to evaluate never touches an emission buffer."""
    return (rung.kind in ("semi", "anti_semi")
            and len(rung.left_slots) == 1 and not conds_rw)


def _build_rung_fn(spec: MPPJoinTreeSpec, r: int, states, mode: str,
                   S: int, n_in: int, cap_p: int, cap_b: int,
                   conds_rw, elide_probe: bool = False, local=None,
                   owners=None):
    """One rung's count half over the mesh's S shards: the exchange,
    the sorted build side and the expansion's count pass.  Inputs: the
    intermediate (one tensor a shard per slot; rung 0 builds it inline
    from side 0's scan) + the build side's cached scan columns
    (`ops.Shards`).  Outputs: (sizes, counted) — `sizes` one int64
    tensor [partition overflow, then each shard's emission rows], and
    `counted` what the emit half (`_build_emit_fn`) reads, left on the
    card.  A fast-filter rung has no emission: its sizes hold each
    shard's rows kept, and `counted` is already (next intermediate
    slots, live-row masks).

    `elide_probe`: the caller proved the intermediate is ALREADY
    hash-partitioned by this rung's key slots (the previous shuffle rung
    used the same ones), so the probe side skips pack+exchange and only
    the build side exchanges.

    `local`: this process's shards (default all S); every per-shard list
    is S long with None at another process's shards (`owners[s]` the
    process of shard s)."""
    rung = spec.rungs[r]
    bs = states[rung.side]
    first = r == 0
    n_slots = _slots_of_prefix(spec, r)
    kind = rung.kind
    louter = kind == "left_outer"
    b_order = list(bs.col_order)
    b_key_pos = list(rung.build_key_pos)
    left_slots = list(rung.left_slots)
    b_prep = _shard_side(bs.an, b_order, bs.n_local)
    p_prep = (_shard_side(states[0].an, states[0].col_order,
                          states[0].n_local) if first else None)
    p_order0 = list(states[0].col_order) if first else None
    fast_filter = _fast_filter(rung, conds_rw)
    shards = tuple(range(S)) if local is None else tuple(local)
    n_parr = 2 + 2 * n_slots
    n_barr = 1 + 2 * len(b_order)

    def prog(*args):
        off = 0
        slots = [None] * S
        if first:
            p_datas, p_valids, p_del, p_bounds = args[:4]
            off = 4
            mask = [None] * S
            for s in shards:
                cols0, m0 = p_prep(s, p_datas, p_valids, p_del, p_bounds)
                slots[s] = [cols0[ci] for ci in p_order0]
                mask[s] = m0
        else:
            for s in shards:
                slots[s] = []
            for _i in range(n_slots):
                for s in shards:
                    slots[s].append((args[off][s], args[off + 1][s]))
                off += 2
            mask = args[off]
            off += 1
        b_datas, b_valids, b_del, b_bounds = args[off:off + 4]

        # ---- probe (intermediate) side -------------------------------
        p_arrays, psels, pmixes, zero = [None] * S, [None] * S, \
            [None] * S, None
        for s in shards:
            sl = slots[s]
            keys = [sl[i][0].to(torch.int64) for i in left_slots]
            kv = sl[left_slots[0]][1]
            for i in left_slots[1:]:
                kv = kv & sl[i][1]
            mix = ex.combine_keys(keys)
            if kind in ("inner", "semi"):
                psels[s] = mask[s] & kv
            else:  # left_outer / anti_semi keep NULL-key rows (unmatched)
                psels[s] = mask[s]
            mix0 = torch.where(kv, mix, torch.zeros_like(mix))
            pmixes[s] = mix0
            arrs = [mix0, kv]
            for d, v in sl:
                arrs.append(d)
                arrs.append(v)
            p_arrays[s] = arrs
            if zero is None:
                zero = torch.zeros((), dtype=torch.int64, device=mix.device)
        if mode == "shuffle" and not elide_probe:
            recv, p_ok, p_over = ex.shuffle(p_arrays, psels, pmixes, cap_p,
                                            owners)
        else:  # broadcast rung, or residency-elided re-shuffle: the
            # intermediate stays local (for elision the build side
            # below still exchanges — equal keys already co-reside)
            recv = [ex.pick(p_arrays, i) for i in range(n_parr)]
            p_ok = psels
            p_over = zero

        # ---- build side ----------------------------------------------
        b_arrays, bsels, bmixes = [None] * S, [None] * S, [None] * S
        for s in shards:
            b_cols, bm = b_prep(s, b_datas, b_valids, b_del, b_bounds)
            bkeys = [b_cols[kp][0].to(torch.int64) for kp in b_key_pos]
            bmix = ex.combine_keys(bkeys)
            bk_v = b_cols[b_key_pos[0]][1]
            for kp in b_key_pos[1:]:
                bk_v = bk_v & b_cols[kp][1]
            bsels[s] = bm & bk_v  # NULL build keys never match
            bmixes[s] = bmix
            arrs = [bmix]
            for ci in b_order:
                d, v = b_cols[ci]
                arrs.append(d)
                arrs.append(v)
            b_arrays[s] = arrs
        if mode == "shuffle":
            recv_b, b_ok, b_over = ex.shuffle(b_arrays, bsels, bmixes,
                                              cap_b, owners)
        else:
            recv_b = [ex.replicate(ex.pick(b_arrays, i), owners)
                      for i in range(n_barr)]
            b_ok = ex.replicate(bsels, owners)
            b_over = zero
        overflow = p_over + b_over.to(p_over.device)

        builds, counted, sizes = [None] * S, [None] * S, [None] * S
        keeps = [None] * S
        for d in shards:
            sbk, bord, nb = ex.sorted_build(recv_b[0][d], b_ok[d])
            rpk, rkv = recv[0][d], recv[1][d]
            if fast_filter:  # span-count semi/anti (no expansion)
                lo = torch.searchsorted(sbk, rpk)
                hi = torch.minimum(torch.searchsorted(sbk, rpk, right=True),
                                   nb)
                matched = (p_ok[d] & rkv) & (hi > lo)
                keeps[d] = p_ok[d] & (matched if kind == "semi"
                                      else ~matched)
                sizes[d] = keeps[d].sum()
                continue
            builds[d] = (sbk, bord)
            counted[d] = ex.count_matches(sbk, nb, rpk, p_ok[d],
                                          rkv & p_ok[d], louter)
            sizes[d] = counted[d][3]
        # partition overflow, then the per-shard sizes, in one gather
        flags = torch.cat([overflow.reshape(1), ops.gather0(
            ops.gather_shards(sizes)).to(overflow.device)])
        if fast_filter:
            out_slots = [[None] * S for _ in range(2 * n_slots)]
            for d in shards:
                for i in range(2 * n_slots):
                    out_slots[i][d] = recv[2 + i][d]
            return flags, (out_slots, keeps)
        return flags, (recv, recv_b, p_ok, builds, counted)

    return prog


def _build_emit_fn(spec: MPPJoinTreeSpec, r: int, states, S: int,
                   cap_out: int, conds_rw, local=None):
    """One rung's emit half over what its count half left on the card:
    the expansion's pass 2 into `cap_out` slots a shard, the multi-key
    re-verify, the pair conditions and the gathers of the next
    intermediate.  Output: (flags, next intermediate slots, live-row
    mask, each one tensor a shard) — the flags one int64 tensor
    [emission overflow, live rows] summed across shards."""
    from ..copr.torch_eval import compile_expr

    rung = spec.rungs[r]
    n_slots = _slots_of_prefix(spec, r)
    kind = rung.kind
    louter = kind == "left_outer"
    filt = kind in ("semi", "anti_semi")
    b_order = list(states[rung.side].col_order)
    b_key_pos = list(rung.build_key_pos)
    left_slots = list(rung.left_slots)
    multi = len(left_slots) > 1
    shards = tuple(range(S)) if local is None else tuple(local)

    def prog(counted_state):
        recv, recv_b, p_ok, builds, counted = counted_state
        out_slots = [[None] * S for _ in range(2 * n_slots + (
            0 if filt else 2 * len(b_order)))]
        keeps, j_overs = [None] * S, [None] * S
        for d in shards:
            sbk, bord = builds[d]
            src, bidx, out_valid, matched, j_overs[d] = ex.emit_matches(
                sbk, bord, counted[d], cap_out)
            hit = matched
            if multi:
                # mix-hash candidates: re-verify TRUE per-column equality
                for sl, kp in zip(left_slots, b_key_pos):
                    jb = b_order.index(kp)
                    hit = hit & (
                        recv[2 + 2 * sl][d][src].to(torch.int64)
                        == recv_b[1 + 2 * jb][d][bidx].to(torch.int64))
            if conds_rw:
                env = {}
                for i in range(n_slots):
                    env[i] = (recv[2 + 2 * i][d][src],
                              recv[3 + 2 * i][d][src])
                for j, ci in enumerate(b_order):
                    env[n_slots + ci] = (recv_b[1 + 2 * j][d][bidx],
                                         hit & recv_b[2 + 2 * j][d][bidx])
                for c in conds_rw:
                    dd, v = compile_expr(c, env, cap_out)
                    hit = hit & v & (dd != 0)

            if filt:
                counts = torch.zeros(recv[0][d].shape[0], dtype=torch.int32,
                                     device=src.device).index_add_(
                    0, src, (hit & out_valid).to(torch.int32))
                matched_any = counts > 0
                keeps[d] = p_ok[d] & (matched_any if kind == "semi"
                                      else ~matched_any)
                for i in range(2 * n_slots):
                    out_slots[i][d] = recv[2 + i][d]
                continue

            # inner / left_outer emission: gather probe slots, append
            # build
            for i in range(n_slots):
                out_slots[2 * i][d] = recv[2 + 2 * i][d][src]
                out_slots[2 * i + 1][d] = recv[3 + 2 * i][d][src]
            for j in range(len(b_order)):
                out_slots[2 * n_slots + 2 * j][d] = \
                    recv_b[1 + 2 * j][d][bidx]
                out_slots[2 * n_slots + 2 * j + 1][d] = \
                    hit & recv_b[2 + 2 * j][d][bidx]
            keeps[d] = out_valid if louter else out_valid & hit
        # per shard (emission overflow, rows kept), summed in one gather
        flags = ops.psum(ops.gather_shards([
            None if keep is None else torch.stack(
                [j_overs[d], keep.sum().to(j_overs[d].device)])
            for d, keep in enumerate(keeps)]))
        return flags, out_slots, keeps

    return prog


# ---------------------------------------------------------------------------
# final phase: rows readback or partial aggregation
# ---------------------------------------------------------------------------


def _tree_key_remaps(spec: MPPJoinTreeSpec, states):
    """Per-group-key dict-code remaps over the SLOT layout: computed
    keys reading a string column resolve to their owning side's store
    and the remap builds there (the tree analog of
    engine._mpp_key_remaps)."""
    from ..copr import fusion

    if spec.aggs is None or spec.group_by is None:
        return None
    remaps = []
    for g in spec.group_by:
        if not _computed_string_key(g):
            remaps.append(None)
            continue
        refs = _expr_refs(g)
        srcs = {spec.slot_src[i] for i in refs}
        if len(srcs) != 1:
            raise MPPIneligible(
                f"computed group key spans join sides: {g}")
        side, sp = next(iter(srcs))
        st = states[side]
        slot = next(iter(refs))
        try:
            rm = fusion.build_key_remap(
                st.table, st.an.scan, _reindex_expr(g, lambda _i: sp))
        except DeviceUnsupported as e:
            raise MPPIneligible(str(e))
        remaps.append(rebased_remap(rm, slot))
    return remaps if any(r is not None for r in remaps) else None


def _build_final_fn(spec: MPPJoinTreeSpec, n_in: int, cap_g: int, aggs_rw,
                    group_rw, remaps, owners=None):
    """The final partial-aggregation program over the finished
    intermediate (one tensor a shard per slot): scalar partials summed
    across shards, or the grouped sort-group + on-card merge over the
    slot layout, then the spec's TopN over the merged groups.
    fn(*slots, mask[, budget, *maps]) returns (flags, payload) as the
    pair engine's program does."""
    n_slots = len(spec.slot_src)
    grouped = group_rw is not None
    topn = spec.topn if grouped else None

    def prog(*args):
        mask = args[2 * n_slots]
        envs = [None if mask[s] is None else
                {i: (args[2 * i][s], args[2 * i + 1][s])
                 for i in range(n_slots)} for s in range(len(mask))]
        off = 2 * n_slots + 1
        if grouped:
            gbudget = args[off]
            rvals = args[off + 1:]
            n_uniqs, mn_uniq, m_keys, m_states = grouped_phase(
                aggs_rw, group_rw, envs, mask, n_in, cap_g, remaps, rvals,
                owners)
            over_l = ops.psum(ops.gather_shards(
                [None if n is None else torch.clamp(n - gbudget, min=0)
                 for n in n_uniqs]))
            over_m = torch.clamp(mn_uniq - gbudget, min=0)
            if topn is not None:
                m_keys, m_states = _top_groups(topn, aggs_rw, m_keys,
                                               m_states, mn_uniq)
            dev0 = over_l.device
            return (torch.stack([over_l, over_m.to(dev0),
                                 mn_uniq.to(dev0)]),
                    (m_keys, m_states))
        return None, merge_scalar_states(
            aggs_rw, [None if env is None
                      else scalar_partial_states(aggs_rw, env, m, n_in)
                      for env, m in zip(envs, mask)])

    return prog


def _top_groups(topn, aggs, keys, states, n_groups):
    """The merged groups reordered so that the first `k` lead by the
    TopN's items (SQL order: NULL below every value), live groups before
    the empty slots, ties in merged order; the first k are kept."""
    items, k = topn
    nk = len(keys) // 2
    cap = keys[0].shape[0]
    dev = keys[0].device
    order = torch.arange(cap, dtype=torch.int64, device=dev)
    low = torch.iinfo(torch.int64).min
    for kind, i, desc in reversed(items):
        if kind == "key":
            v, ok = keys[i], keys[nk + i] != 0
        elif aggs[i].name == "count":
            v, ok = states[i], None
        else:
            v, ok = states[i]
            ok = ok > 0
        v = v.to(torch.int64)
        if ok is not None:
            v = torch.where(ok, v, torch.full_like(v, low))
        order = order[torch.sort(v[order], descending=desc,
                                 stable=True).indices]
    dead = (order >= n_groups.to(dev)).to(torch.int8)
    top = order[torch.sort(dead, stable=True).indices][:k]
    return ([t[top] for t in keys],
            [tuple(x[top] for x in st) if isinstance(st, tuple)
             else st[top] for st in states])


# ---------------------------------------------------------------------------
# host-side assembly
# ---------------------------------------------------------------------------


def _decode_slot(spec, states, slot: int, ft, data: np.ndarray,
                 valid: np.ndarray) -> Column:
    if ft.kind == TypeKind.STRING:
        from ..store.blockstore import _decode_dict

        side, sp = spec.slot_src[slot]
        st = states[side]
        store_ci = st.an.scan.columns[sp]
        obj = _decode_dict(data.astype(np.int64),
                           st.table.cols[store_ci].dictionary)
        return Column(ft, obj, valid)
    return Column(ft, data.astype(ft.np_dtype), valid)


def _assemble_tree_rows(spec, states, mask, flats) -> List[Chunk]:
    """The output slots of the kept rows, selected on each shard's card
    and read back in shard order."""
    host = select_rows([
        None if keep is None else
        (keep, [(flats[2 * i][s], flats[2 * i + 1][s])
                for i in spec.out_slots])
        for s, keep in enumerate(mask)])
    cols = []
    for ft, slot, (d, v) in zip(spec.out_ftypes, spec.out_slots, host):
        cols.append(_decode_slot(spec, states, slot, ft, d,
                                 v.astype(np.bool_)))
    big = Chunk(cols)
    return [c for c in big.split(OUT_CHUNK_ROWS) if c.num_rows]


def _assemble_tree_grouped(spec, states, k: int, keys, sts,
                           remaps=None) -> List[Chunk]:
    from ..store.blockstore import _decode_dict

    def decode_string(g, codes):
        side, sp = spec.slot_src[g.index]
        st = states[side]
        store_ci = st.an.scan.columns[sp]
        return _decode_dict(codes, st.table.cols[store_ci].dictionary)

    keys, sts = read_groups(k, keys, sts)
    return assemble_grouped(spec.aggs, spec.group_by, k, keys, sts, remaps,
                            decode_string)


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def _clone_expr(e):
    return deserialize_expr(serialize_expr(e))


def _run_tree_once(storage, spec: MPPJoinTreeSpec,
                   modes: List[str]) -> List[Chunk]:
    from ..copr.chunking import observe_chunk
    from ..copr.device_health import DEVICE_HEALTH
    from ..lifecycle import dispatch_admission, scope_check
    from ..trace import annotate, span

    mesh = get_mesh()
    S = mesh.size
    mesh_ids = mesh.ids
    states = [_SideState(storage, s, spec.ts, mesh) for s in spec.sides]
    for st in states:
        st.load()

    slack = _slack()
    grouped = spec.aggs is not None and spec.group_by is not None
    remaps = _tree_key_remaps(spec, states) if grouped else None

    # dict-rewrite the per-rung other conds and final agg exprs against
    # each column's OWNING side (string constants -> codes, LIKE /
    # computed predicates -> code sets); rewritten trees enter the
    # program fingerprints, so dictionary changes rebuild correctly
    rung_conds = []
    for r, rung in enumerate(spec.rungs):
        if rung.kind == "left_outer" and rung.other_conds:
            # a probe row whose every candidate pair fails the ON conds
            # must still NULL-extend; the emission path cannot express
            # that — the planner pushes build-side-only ON conds into
            # the scan instead, anything else stays host
            raise MPPIneligible("left-outer rung with pair conditions")
        if rung.kind == "left_outer" and len(rung.left_slots) > 1:
            # defense in depth behind the planner gate: multi-key
            # louter candidates are mix-hash (collision-prone), and a
            # dropped collision pair would still emit a spurious
            # NULL-extended row (keep=out_valid)
            raise MPPIneligible("multi-key left-outer rung")
        n_slots = _slots_of_prefix(spec, r)
        resolver = _slot_resolver(spec, states, n_slots,
                                  states[rung.side])
        try:
            rung_conds.append([
                rewrite_for_dict_resolved(_clone_expr(c), resolver)
                for c in rung.other_conds])
        except DeviceUnsupported as e:
            raise MPPIneligible(f"rung {r} condition: {e}")
    aggs_rw = group_rw = None
    if spec.aggs is not None:
        from ..expr.aggregation import AggDesc

        resolver = _slot_resolver(spec, states, len(spec.slot_src))
        try:
            aggs_rw = [AggDesc(a.name,
                               [rewrite_for_dict_resolved(_clone_expr(x),
                                                          resolver)
                                for x in a.args],
                               a.distinct, a.ftype)
                       for a in spec.aggs]
            if grouped:
                group_rw = [
                    g if (remaps is not None
                          and remaps[i] is not None) else
                    rewrite_for_dict_resolved(_clone_expr(g), resolver)
                    for i, g in enumerate(spec.group_by)]
        except DeviceUnsupported as e:
            raise MPPIneligible(f"final agg: {e}")

    # ---- run the ladder ---------------------------------------------
    inter = None     # flat (data, valid) tensors per slot
    mask = None
    n_in = live = states[0].n_local
    # key-slot tuples the intermediate is hash-partitioned by (empty
    # until the first shuffle rung: rung 0's input is range-partitioned)
    residency: set = set()
    base_fp = (f"mpptree|S={S} devs={mesh_ids}@{mesh.where}"
               f"|base:{_fingerprint(states[0].an, 'filter')}"
               f"|Tl={states[0].Tl}|wire={states[0].wire_sig}")
    for r, rung in enumerate(spec.rungs):
        bs = states[rung.side]
        mode = modes[r]
        # residency elision: a shuffle rung whose key slots match the
        # partitioning the PREVIOUS shuffle rung left behind skips the
        # probe-side exchange entirely — equal keys (and bucket-0 NULL
        # keys) already co-reside, so only the build side moves
        elide = (mode == "shuffle" and inter is not None
                 and tuple(rung.left_slots) in residency)
        cap_p = min(_pow2ceil(int(slack * n_in / S) + 1), max(n_in, 16))
        cap_b = min(_pow2ceil(int(slack * bs.n_local / S) + 1),
                    bs.n_local)
        n_recv = (S * cap_p if mode == "shuffle" and not elide
                  else n_in)
        # the emission buffer is sized from the rung's own count pass,
        # within what the card's share holds of the rung's output columns
        fit = card_share_bytes() // (9 * _slots_of_prefix(spec, r + 1) + 32)
        fast = _fast_filter(rung, rung_conds[r])
        conds_sig = json.dumps(
            [serialize_expr(c) for c in rung_conds[r]], sort_keys=True)
        fp = (base_fp
              + f"|r{r}|{mode}|{rung.kind}|n_in={n_in}"
              f"|caps={cap_p},{cap_b}"
              f"|lk={rung.left_slots}|el={int(elide)}"
              f"|b:{_fingerprint(bs.an, 'filter')}|Tl={bs.Tl}"
              f"|k={rung.build_key_pos}|wire={bs.wire_sig}"
              f"|oc={conds_sig}")
        fn = _COMPILED.get(fp)
        if fn is None:
            fn = _build_rung_fn(spec, r, states, mode, S, n_in, cap_p,
                                cap_b, rung_conds[r], elide_probe=elide,
                                local=mesh.local, owners=mesh.owners)
            _COMPILED.put(fp, fn)
        FAILPOINTS.hit(TREE_FAILPOINT, rung=r, mode=mode,
                       kind=rung.kind, device_ids=mesh_ids)
        # the rung ladder IS the chunk sequence on the MPP path: each
        # rung re-checks scope and resource-group admission, so KILL of
        # a deep join tree lands between rungs
        FAILPOINTS.hit("copr/chunk_dispatch", kind="mpp", chunk=r,
                       total=len(spec.rungs), start=0, end=0)
        if inter is None:
            st0 = states[0]
            args = (st0.datas, st0.valids, st0.del_mask, st0.bounds)
        else:
            args = tuple(inter) + (mask,)
        args = args + (bs.datas, bs.valids, bs.del_mask, bs.bounds)
        scope_check()
        # membership guard before every rung's exchange
        _check_membership_epoch()
        t0 = time.perf_counter()
        with span("mpp.rung", idx=r, rung=mode, kind=rung.kind,
                  elided=int(elide), build_table=bs.side.table_id):
            with dispatch_admission(DISPATCH_LOCK):
                head, counted = fn(*args)
                overflow, *sizes = read_flags(head)
                if overflow:
                    raise MPPTreeOverflow(
                        r, "partition",
                        f"rung {r}: {overflow} rows over partition "
                        f"capacity (cap_p={cap_p}, cap_b={cap_b}, "
                        f"mode={mode})")
                if fast:
                    out_slots, keep = counted
                    live = sum(sizes)
                else:
                    cap_out = _pow2ceil(max(sizes))
                    if cap_out > fit:
                        raise MPPIneligible(
                            f"rung {r}: {max(sizes)} joined rows on a "
                            f"shard need {cap_out} slots, over the "
                            f"{fit} the card's share holds")
                    REGISTRY.inc("mpp_tree_emit_rows_total", sum(sizes))
                    REGISTRY.inc("mpp_tree_emit_slots_total", cap_out * S)
                    annotate(emit_rows=sum(sizes), emit_slots=cap_out * S)
                    efp = fp + f"|emit={cap_out}"
                    emit = _COMPILED.get(efp)
                    if emit is None:
                        emit = _build_emit_fn(spec, r, states, S, cap_out,
                                              rung_conds[r],
                                              local=mesh.local)
                        _COMPILED.put(efp, emit)
                    flags, out_slots, keep = emit(counted)
                    jover, live = read_flags(flags)
                    if jover:
                        raise MPPTreeOverflow(
                            r, "emit",
                            f"rung {r}: {jover} joined rows over the "
                            f"emission buffer its count pass sized "
                            f"(cap_out={cap_out}, mode={mode})")
        # the count half's exchanged and sorted arrays go now, not when
        # the next rung or the final has run over them
        del counted
        observe_chunk("mpp", (time.perf_counter() - t0) * 1000.0,
                      OUT_CHUNK_ROWS)
        inter = list(out_slots)
        mask = keep
        n_in = (n_recv if rung.kind in ("semi", "anti_semi")
                else cap_out)
        REGISTRY.inc("mpp_tree_rungs_total")
        if elide:
            REGISTRY.inc("mpp_tree_reshuffle_elided_total")
        if mode == "shuffle":
            # rows now co-reside hashed by this rung's key; for inner
            # rungs the appended build key columns carry the SAME
            # values (the planner canonicalizes later rungs onto any
            # member of the equality class), so they name the layout
            # too.  NOT valid for left_outer — unmatched rows carry
            # NULL build keys that a real shuffle would send to bucket
            # 0.  Broadcast rungs never move the probe side, so any
            # earlier residency still holds.
            residency = {tuple(rung.left_slots)}
            if rung.kind == "inner":
                base = _slots_of_prefix(spec, r)
                order = list(bs.col_order)
                residency.add(tuple(base + order.index(kp)
                                    for kp in rung.build_key_pos))

    DEVICE_HEALTH.record_success(mesh_ids)

    # ---- final phase -------------------------------------------------
    if spec.aggs is None:
        with span("mpp.tree.readback"):
            return _assemble_tree_rows(spec, states, mask, inter)
    fin_sig = json.dumps(
        [[a.name] + [serialize_expr(x) for x in a.args]
         for a in aggs_rw]
        + ([serialize_expr(g) for g in group_rw] if grouped else []),
        sort_keys=True)
    # groups never outnumber the joined rows: the grouped final starts at
    # the planner's budget or the live rows, whichever is less; a budget
    # overflow re-runs the final alone at the live rows, and only past
    # the card's group limit does the aggregation peel to the host
    budget = limit = 0
    if grouped:
        limit = group_limit(len(spec.group_by), state_words(spec.aggs), S)
        budget = min(_group_budget(spec, S)[0], max(live, 1), limit)
    while True:
        cap_g = _group_cap(budget, S) if grouped else 0
        fp = (base_fp + f"|final|n_in={n_in}|capg={cap_g}|agg={fin_sig}"
              + f"|top={spec.topn}"
              + (f"|rcaps={[r.cap if r else None for r in remaps]}"
                 if remaps else ""))
        fn = _COMPILED.get(fp)
        if fn is None:
            fn = _build_final_fn(spec, n_in, cap_g, aggs_rw, group_rw,
                                 remaps, owners=mesh.owners)
            _COMPILED.put(fp, fn)
        args = tuple(inter) + (mask,)
        if grouped:
            args = args + (budget,) + remap_operands(remaps, mesh)
        scope_check()
        with span("mpp.tree.final", grouped=grouped):
            with dispatch_admission(DISPATCH_LOCK):
                flags, payload = fn(*args)
                if not grouped:
                    # scalar partials: one partial row, as the pair
                    # engine builds it
                    return _assemble_partials(spec.aggs,
                                              read_scalars(payload))
                over_l, over_m, k = read_flags(flags)
        if not (over_l or over_m):
            break
        msg = (f"tree: distinct groups over budget {budget} "
               f"(per-shard over {over_l}, merged over {over_m})")
        if budget >= min(live, limit):
            raise MPPGroupedAggOverflow(msg)
        REGISTRY.inc("mpp_grouped_agg_overflow_total")
        annotate(grouped_agg_overflow=msg[:120])
        budget = min(live, limit)
    REGISTRY.inc("mpp_tree_groups_total", k)
    annotate(groups=k, group_budget=budget)
    if spec.topn is not None:
        k = min(k, spec.topn[1])
    return _assemble_tree_grouped(spec, states, k, payload[0], payload[1],
                                  remaps=remaps)


def run_mpp_jointree(storage,
                     spec: MPPJoinTreeSpec) -> Tuple[List[Chunk], str]:
    """`_run_mpp_jointree` in one program across processes."""
    with statement_program("mpp tree", [
            (sd.table_id, sd.dag, sd.key_pos) for sd in spec.sides]):
        return _run_mpp_jointree(storage, spec)


def _run_mpp_jointree(storage,
                      spec: MPPJoinTreeSpec) -> Tuple[List[Chunk], str]:
    """Run the rung ladder on the card; (chunks, mode) on success, raises
    MPPIneligible when the host chain must serve it (a structural cause
    only).  Per-rung overflow steps that rung down to broadcast;
    grouped-budget overflow peels the agg to a host tail over
    device-joined rows; a device runtime failure retries on the card,
    then reaches the statement."""
    import dataclasses

    from ..coord import CoordEpochMismatch
    from ..errors import TiDBTPUError
    from ..lifecycle import current_scope
    from ..trace import annotate, span

    modes = ["shuffle"] * len(spec.rungs)
    attempts = 0
    peel = (spec.group_by is not None and spec.aggs is not None
            and not grouped_pushdown_enabled())
    while True:
        FAILPOINTS.hit("exec/cancel", site="mpp", scope=current_scope())
        current_scope().check()
        _check_breaker()
        run_spec = spec
        if peel:
            run_spec = dataclasses.replace(spec, aggs=None, group_by=None)
        try:
            with span("mpp.tree", rungs=len(spec.rungs),
                      grouped=bool(spec.group_by), peel=peel):
                chunks = _run_tree_once(storage, run_spec, modes)
            mode = "tree[" + ",".join(m[0] for m in modes) + "]"
            if peel:
                if spec.aggs is not None and spec.group_by is not None:
                    from .engine import _host_grouped_partials

                    with span("mpp.agg_peel", rung=mode):
                        chunks = _host_grouped_partials(spec, chunks)
                mode += "+agg-peel"
            elif spec.group_by is not None and spec.aggs is not None:
                mode += "+grouped"
                if spec.topn is not None:
                    mode += f"+top{spec.topn[1]}"
            REGISTRY.inc("mpp_tree_joins_total")
            return chunks, mode
        except MPPGroupedAggOverflow as e:
            REGISTRY.inc("mpp_grouped_agg_overflow_total")
            REGISTRY.inc("mpp_grouped_agg_fallback_total")
            annotate(grouped_agg_overflow=str(e)[:120])
            peel = True
            continue
        except MPPTreeOverflow as e:
            if e.what == "emit":
                # the emit half disagreed with its own count pass
                REGISTRY.inc("mpp_tree_emit_overflow_total")
            if e.what == "partition":
                REGISTRY.inc("mpp_partition_overflow_total")
                if modes[e.rung] == "shuffle":
                    modes[e.rung] = "broadcast"  # immune to probe skew
                    continue
            raise MPPIneligible(f"tree rung overflow: {e}")
        except DeviceUnsupported as e:
            # a rung/final program met an expression the card cannot
            # evaluate (planner gates are structural, not exhaustive):
            # the host chain owns it
            raise MPPIneligible(str(e))
        except CoordEpochMismatch:
            # membership moved between the mesh build and a rung: rebuild
            # from the new broadcast and re-run the ladder
            if attempts + 1 >= MAX_MESH_ATTEMPTS:
                raise
            attempts += 1
        except (MPPIneligible, KeyboardInterrupt, SystemExit,
                GeneratorExit, TiDBTPUError):
            raise
        except BaseException as e:
            if not _handle_mesh_failure(None, e, attempts):
                raise
            attempts += 1

"""Device-side exchange primitives for the MPP shuffle join.

The partition/exchange shape follows TQP's relational-algebra-on-tensors
mapping (PAPERS.md): a hash shuffle is a static-shape bucket pack plus
one all-to-all per column, and the local join is argsort +
searchsorted — fixed-shape tensor ops on the card.

Static capacities: each (source shard -> destination shard) bucket holds
at most `cap` rows.  Overflow is *counted* on the card and surfaced as a
scalar the host checks (the MeshAggOverflow contract of
copr/parallel.py applied to exchanges); the caller then steps down the
join-strategy ladder.

The exchange runs over the mesh's S shards (`ops.mesh_devices`), each
shard's arrays on its own position's device: `exchange` (all_to_all)
and `replicate` (all_gather) take the per-shard list and return one, as
explicit copies in a fixed order (shard d concatenates what it receives
in source order), so every run moves the same rows to the same slots.
At S = 1 both are a reshape.  When the mesh spans processes each list
holds None at another process's shards (`owners[s]` names the process
of shard s): blocks between one process's shards stay copies, the rest
travel in one `ops.collective.all_to_all` (exchange) or all-gather
(replicate).

Every sort here is STABLE (`torch.sort(..., stable=True)`): the order of
duplicate build keys sets the emission order, and so the order of float
sums and the row first_row picks.  The partition hash is int64 value
arithmetic (wrapping multiplies, arithmetic right shifts) and a floor
mod (`torch.remainder`).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import ops

# splitmix64's multiplicative constants, wrapped into int64 — spreads
# clustered keys (sequential order keys, FK ranges) across partitions so
# the static bucket capacity sees near-uniform load
_MIX = int(np.uint64(0x9E3779B97F4A7C15).astype(np.int64))
_MIX2 = int(np.uint64(0xBF58476D1CE4E5B9).astype(np.int64))

I64_MAX = int(np.iinfo(np.int64).max)


def partition_ids(key, n_parts: int):
    """[0, n_parts) partition id per int64 key, identical on both join
    sides (the ExchangeSender hash of tipb.ExchangeType_Hash): two
    mixing rounds of splitmix64's finalizer shape, value arithmetic
    only."""
    h = key * _MIX
    h = h ^ (h >> 31)  # arithmetic shift: sign bits only perturb, not bias
    h = h * _MIX2
    h = h ^ (h >> 29)
    return torch.remainder(h, n_parts)


def pack_buckets(pid, pack_mask, n_parts: int, cap: int,
                 arrays: Sequence) -> Tuple[List, object, object]:
    """Scatter local rows into [n_parts, cap] destination buckets.

    One stable argsort on partition id groups each destination's rows
    contiguously; bucket d then gathers rows [offset_d, offset_d+cap).
    Returns (bucketed arrays, bucket validity [n_parts, cap], overflow =
    max rows any bucket wanted minus cap, clamped at 0).  Rows beyond a
    bucket's capacity are DROPPED on the card — the overflow scalar is
    how the host learns the result is incomplete and must step down.

    The range `mpp.pack` names its device time in a torch.profiler
    trace (at S = 1 the pack is a stable compaction of every row)."""
    n = pid.shape[0]
    dev = pid.device
    with torch.profiler.record_function("mpp.pack"):
        # unselected rows sort last (pid n_parts), never land in a bucket
        skey = torch.where(pack_mask, pid, torch.full_like(pid, n_parts))
        ssorted, order = torch.sort(skey, stable=True)
        offsets = torch.searchsorted(
            ssorted,
            torch.arange(n_parts + 1, dtype=skey.dtype, device=dev))
        counts = offsets[1:] - offsets[:-1]
        overflow = torch.clamp(counts.max() - cap, min=0)
        slot = torch.arange(cap, dtype=torch.int64, device=dev)
        idx = offsets[:-1][:, None] + slot[None, :]      # [n_parts, cap]
        bucket_valid = slot[None, :] < counts[:, None]
        rows = order[torch.clamp(idx, 0, n - 1)]
        out = [a[rows] for a in arrays]
    return out, bucket_valid, overflow


def _across(owners) -> bool:
    return owners is not None and ops.process_count() > 1


def pick(per_shard: Sequence, i: int) -> List:
    """Item i of every shard's entry (None at another process's
    shards)."""
    return [None if x is None else x[i] for x in per_shard]


def exchange(bucketed: Sequence, owners=None) -> List:
    """all_to_all over the shards: `bucketed[s]` is shard s's [S, cap]
    pack, whose row d is its partition destined for shard d.  Returns
    one [S*cap] array a shard, on that shard's device: row block j of
    shard d's array is the partition shard j sent it."""
    S = len(bucketed)
    if S == 1:
        return [None if b is None else b.reshape(-1) for b in bucketed]
    if _across(owners):
        from ..ops.collective import all_to_all

        return all_to_all(bucketed, owners)
    return [torch.cat([bucketed[s][d].to(bucketed[d].device)
                       for s in range(S)])
            for d in range(S)]


def replicate(local: Sequence, owners=None) -> List:
    """all_gather: every shard receives every shard's array, flattened
    and concatenated in shard order, on its own device (the
    broadcast-join rung: the build side is replicated instead of
    partitioned)."""
    S = len(local)
    if S == 1:
        return [None if x is None else x.reshape(-1) for x in local]
    full = ops.gather_shards(local) if _across(owners) else local
    flat = [x.reshape(-1) for x in full]
    return [None if local[d] is None else
            torch.cat([x.to(local[d].device) for x in flat])
            for d in range(S)]


def shuffle(arrays: Sequence, sel: Sequence, mix: Sequence,
            cap: int, owners=None) -> Tuple[List, List, object]:
    """The hash shuffle of every shard's rows: shard s packs its
    `arrays[s]` (the rows `sel[s]` keeps) into [S, cap] buckets by the
    partition ids of `mix[s]`, and each array goes all_to_all.  Returns
    (received [array][shard], received validity [shard], the buckets'
    overflow summed in shard order)."""
    S = len(arrays)
    packs = [None if arrays[s] is None else
             pack_buckets(partition_ids(mix[s], S), sel[s], S, cap,
                          arrays[s]) for s in range(S)]
    n_arr = len(next(a for a in arrays if a is not None))
    bucketed = pick(packs, 0)
    recv = [exchange(pick(bucketed, i), owners) for i in range(n_arr)]
    over = pick(packs, 2)
    return recv, exchange(pick(packs, 1), owners), \
        ops.psum(ops.gather_shards(over) if _across(owners) else over)


def combine_keys(keys):
    """Fold multiple int64 join-key columns into ONE int64 sort/partition
    key (identity for a single column, so single-key joins keep exact
    equality).  Multi-column combination is a mix-hash: colliding unequal
    keys land in the same sorted span, so callers must re-verify TRUE
    per-column equality on candidate matches."""
    h = keys[0]
    for k in keys[1:]:
        h = (h * _MIX) ^ k ^ ((h >> 29) & 0x7FFFFFFF)
    return h


def pack_keys_exact(keys, los, cards):
    """EXACT compound-key composition: stats-bounded key columns pack into
    ONE int64 by stride multiplication — equal packed keys iff every
    column is equal, so no collision re-verify is needed and dropping
    candidates is sound for LEFT-OUTER joins.  Callers guarantee
    prod(cards) <= 2**62 and that `los`/`cards` cover BOTH sides' value
    ranges."""
    h = torch.zeros_like(keys[0])
    for k, lo, card in zip(keys, los, cards):
        h = h * card + torch.clamp(k - lo, 0, card - 1)
    return h


def compound_pack_spec(stat_pairs, max_bits: int = 62):
    """(los, cards) for pack_keys_exact from per-key ((lo,hi), (lo,hi))
    stat pairs (probe side, build side), or None when the packed space
    exceeds 2**max_bits — callers then keep the mix-hash ladder."""
    los, cards = [], []
    total = 1
    for (p_lo, p_hi), (b_lo, b_hi) in stat_pairs:
        lo = min(p_lo, b_lo)
        hi = max(p_hi, b_hi)
        if hi < lo:
            lo, hi = 0, 0
        card = hi - lo + 1
        total *= card
        if total > (1 << max_bits):
            return None
        los.append(int(lo))
        cards.append(int(card))
    return los, cards


def sorted_build(keys, valid):
    """(sorted keys with invalid rows pushed to +inf, source order,
    valid count) — the device hash table: searchsorted probes against
    the sorted build keys (duplicates stay adjacent, in row order)."""
    sortk = torch.where(valid, keys, torch.full_like(keys, I64_MAX))
    sk, order = torch.sort(sortk, stable=True)
    return sk, order, valid.sum()


def count_matches(sbk, nb, probe_keys, probe_emit, probe_match_ok,
                  louter: bool):
    """Pass 1 of the join expansion (`expand_matches`): each probe row's
    match span in the sorted build keys is [lo, hi) via two
    searchsorteds; cnt = hi - lo candidate matches, emit_cnt the rows it
    emits (a left-outer probe row with no match still emits one).

    Returns (lo, cnt, emit_cnt, total): `total`, the 0-d sum of
    emit_cnt, is the emission buffer the pass-2 half needs."""
    pk = probe_keys.contiguous()
    lo = torch.searchsorted(sbk, pk)
    hi = torch.minimum(torch.searchsorted(sbk, pk, right=True), nb)
    zero = torch.zeros_like(lo)
    cnt = torch.where(probe_match_ok, torch.clamp(hi - lo, min=0), zero)
    emit_cnt = (torch.where(probe_emit, torch.clamp(cnt, min=1), zero)
                if louter else cnt)
    return lo, cnt, emit_cnt, emit_cnt.sum()


def emit_matches(sbk, bord, counted, cap_out: int):
    """Pass 2 of the join expansion over `count_matches`' result: output
    slot t maps back to its source probe row via a searchsorted of
    `arange(cap_out)` over the exclusive prefix sums, so every (probe
    row, match ordinal) pair lands in one of `cap_out` static slots.
    Emissions beyond cap_out are DROPPED on the card; the returned
    overflow scalar is how the host learns the result is incomplete.

    Returns (src, bidx, out_valid, matched, overflow) as
    `expand_matches` does."""
    lo, cnt, emit_cnt, total = counted
    n = cnt.shape[0]
    overflow = torch.clamp(total - cap_out, min=0)
    starts = torch.cumsum(emit_cnt, 0) - emit_cnt
    t = torch.arange(cap_out, dtype=starts.dtype, device=starts.device)
    src = torch.clamp(torch.searchsorted(starts, t, right=True) - 1,
                      0, n - 1)
    j = t - starts[src]
    matched = j < cnt[src]
    bpos = torch.clamp(lo[src] + j, 0, sbk.shape[0] - 1)
    out_valid = t < total
    return src, bord[bpos], out_valid, matched & out_valid, overflow


def expand_matches(sbk, bord, nb, probe_keys, probe_emit, probe_match_ok,
                   cap_out: int, louter: bool):
    """Two-pass count+emit join expansion over NON-UNIQUE build keys:
    `count_matches` then `emit_matches` into `cap_out` slots.

    Left-outer probe rows with no match still emit ONE row (`matched`
    False there — the engine NULL-extends the build columns).

    Returns (src, bidx, out_valid, matched, overflow): per-slot source
    probe row, matched build source row, slot-live mask, true-match-span
    mask, and the clamped overflow count."""
    return emit_matches(sbk, bord, count_matches(
        sbk, nb, probe_keys, probe_emit, probe_match_ok, louter), cap_out)


# ---------------------------------------------------------------------------
# lint kernelcheck: the canonical exchange programs (tidb_tpu's
# mpp/exchange.py:196-464), run once under the op recorder
# ---------------------------------------------------------------------------


def _canonical_join_fn(S: int, cap: int, n_local: int, mode: str):
    """The canonical partition -> exchange -> local-join program shape
    the lint kernelcheck runs (no tables, no engine state): one int64 key
    + one f64 payload per side, inner-join semantics with the production
    two-pass count+emit expansion (non-unique build keys).  Every
    argument holds one tensor a shard."""
    cap_out = S * cap if mode == "shuffle" else n_local

    def shard_fn(pk, pm, bk, bm, pv):
        if mode == "shuffle":
            (rbk, rbv), b_ok, b_over = shuffle(
                [(bk[s], pv[s]) for s in range(S)], bm, bk, cap)
            (rpk,), p_ok, p_over = shuffle(
                [(pk[s],) for s in range(S)], pm, pk, cap)
        else:  # broadcast
            rbk = replicate([torch.where(bm[s], bk[s],
                                         torch.full_like(bk[s], I64_MAX))
                             for s in range(S)])
            rbv = replicate(pv)
            b_ok = replicate(bm)
            rpk, p_ok = list(pk), list(pm)
            b_over = p_over = torch.zeros((), dtype=torch.int64,
                                          device=pk[0].device)
        matched, payload, j_over = [], [], []
        for s in range(S):
            sbk, bord, nb = sorted_build(rbk[s], b_ok[s])
            _src, bidx, _ov, m, jo = expand_matches(
                sbk, bord, nb, rpk[s], p_ok[s], p_ok[s], cap_out, False)
            matched.append(m)
            payload.append(torch.where(m, rbv[s][bidx],
                                       torch.zeros_like(rbv[s][bidx])))
            j_over.append(jo)
        return b_over + p_over, ops.psum(j_over), matched, payload

    return shard_fn


#: canonical join-kernel shape (S, cap, n_local)
_JOIN_KERNEL_SHAPE = (1, 64, 256)


def trace_exchange_kernel(mode: str = "shuffle"):
    """The canonical exchange join at S = 1 on the current device, run
    once on zero keys under the lint's op recorder; returns its OpTrace
    (lint.kernelcheck)."""
    from ..lint.kernelcheck import trace_program

    S, cap, n_local = _JOIN_KERNEL_SHAPE
    dev = ops.device()
    args = (
        [torch.zeros(n_local, dtype=torch.int64, device=dev)],
        [torch.ones(n_local, dtype=torch.bool, device=dev)],
        [torch.zeros(n_local, dtype=torch.int64, device=dev)],
        [torch.ones(n_local, dtype=torch.bool, device=dev)],
        [torch.zeros(n_local, dtype=torch.float64, device=dev)],
    )
    return trace_program(_canonical_join_fn(S, cap, n_local, mode),
                         *args)[1]


def _canonical_tree_fn(S: int, cap: int, n_local: int, cap_out: int):
    """The canonical 3-way rung-ladder program shape (mpp/jointree.py):
    rung 0 joins base(key a, payload) against side B (key a -> key b
    mapping), rung 1 joins the DEVICE-RESIDENT intermediate against side
    C (key b, measure) — both rungs in ONE program, so kernelcheck
    guards the whole ladder's int64 census.  Operand SHIFTS (the caller
    adds a constant to every key column) must run the IDENTICAL op
    sequence: key values are runtime data, never program shape.  Every
    argument holds one tensor a shard."""

    def one_rung(pk, pm, slots, bk, bm, b_payload):
        (rbk, rbv), b_ok, b_over = shuffle(
            [(bk[s], b_payload[s]) for s in range(S)], bm, bk, cap)
        parrs = [tuple([pk[s]] + [a[s] for pair in slots for a in pair])
                 for s in range(S)]
        recv, p_ok, p_over = shuffle(parrs, pm, pk, cap)
        out_slots = [([None] * S, [None] * S) for _ in range(len(slots) + 1)]
        keep, j_over = [None] * S, []
        for s in range(S):
            sbk, bord, nb = sorted_build(rbk[s], b_ok[s])
            src, bidx, out_valid, matched, jo = expand_matches(
                sbk, bord, nb, recv[0][s], p_ok[s], p_ok[s], cap_out,
                False)
            for i in range(len(slots)):
                out_slots[i][0][s] = recv[1 + 2 * i][s][src]
                out_slots[i][1][s] = recv[2 + 2 * i][s][src]
            out_slots[-1][0][s] = rbv[s][bidx]
            out_slots[-1][1][s] = matched
            keep[s] = out_valid & matched
            j_over.append(jo)
        return out_slots, keep, p_over + b_over, ops.psum(j_over)

    def shard_fn(ak, av, bk_a, bk_b, bm, ck, cv, cm):
        ones = [torch.ones_like(a, dtype=torch.bool) for a in ak]
        # rung 0: base(a_key, a_payload) ⋈ B(a_key -> b_key)
        slots0, keep0, ov0, jo0 = one_rung(ak, ones, [(av, ones)], bk_a,
                                           bm, bk_b)
        # rung 1: intermediate(b_key) ⋈ C(b_key, measure) — the
        # intermediate tensors feed straight in, no host boundary
        bkey = [k.to(torch.int64) for k in slots0[1][0]]
        mask1 = [k & m for k, m in zip(keep0, slots0[1][1])]
        slots1, keep1, ov1, jo1 = one_rung(bkey, mask1, slots0, ck, cm, cv)
        total = ops.psum([
            (torch.where(keep1[s], slots1[0][0][s],
                         torch.zeros_like(slots1[0][0][s]))
             * torch.where(keep1[s], slots1[-1][0][s],
                           torch.zeros_like(slots1[-1][0][s]))).sum()
            for s in range(S)])
        return ov0 + ov1, jo0 + jo1, keep1, total

    return shard_fn


#: canonical tree-kernel shape (S, cap, n_local, cap_out) — one source
#: for the program AND the numpy oracle's input size, so a retune can
#: never make executed parity compare different row counts
_TREE_KERNEL_SHAPE = (1, 256, 64, 1024)


def _tree_kernel_fn():
    """The canonical 3-way ladder at S = 1 — shared by
    trace_tree_join_kernel and run_tree_join_kernel so the traced op
    sequence and the executed result can never diverge on shape
    constants.  Returns (fn, n_local)."""
    S, cap, n_local, cap_out = _TREE_KERNEL_SHAPE
    return _canonical_tree_fn(S, cap, n_local, cap_out), n_local


def _tree_kernel_args(n_local: int, shift: int = 0):
    rng = np.random.default_rng(5)
    ak = rng.integers(0, 16, n_local).astype(np.int64) + shift
    av = rng.uniform(0, 1, n_local)
    bk_a = rng.integers(0, 16, n_local).astype(np.int64) + shift
    bk_b = rng.integers(0, 8, n_local).astype(np.int64) + shift
    bm = rng.random(n_local) < 0.5
    ck = rng.integers(0, 8, n_local).astype(np.int64) + shift
    cv = rng.uniform(0, 1, n_local)
    cm = rng.random(n_local) < 0.8
    # host numpy: the program's callers copy to the device, the oracle
    # reads them directly
    return (ak, av, bk_a, bk_b, bm, ck, cv, cm)


def _on_device(arrays):
    """One shard's list per host array, on the current device."""
    dev = ops.device()
    return [[torch.from_numpy(np.ascontiguousarray(a)).to(dev)]
            for a in arrays]


def trace_tree_join_kernel(shift: int = 0):
    """The canonical 3-way ladder at S = 1 on the current device, run once
    under the lint's op recorder; `shift` offsets every key operand —
    lint.kernelcheck runs two shifts and requires identical op
    sequences (key VALUES must never shape the ladder).  Returns the
    OpTrace."""
    from ..lint.kernelcheck import trace_program

    fn, n_local = _tree_kernel_fn()
    return trace_program(
        fn, *_on_device(_tree_kernel_args(n_local, shift)))[1]


def run_tree_join_kernel(shift: int = 0):
    """Execute the canonical ladder (S = 1) and return (partition
    overflow, emit overflow, total) — kernelcheck compares the total
    against the numpy oracle (`tree_join_oracle`)."""
    fn, n_local = _tree_kernel_fn()
    over, jover, _keep, total = fn(
        *_on_device(_tree_kernel_args(n_local, shift)))
    return int(over), int(jover), float(total)


def tree_join_oracle(shift: int = 0) -> float:
    """Numpy reference for run_tree_join_kernel: the same 3-way join
    evaluated row-at-a-time on the host."""
    n_local = _TREE_KERNEL_SHAPE[2]
    ak, av, bk_a, bk_b, bm, ck, cv, cm = _tree_kernel_args(n_local, shift)
    total = 0.0
    for i in range(n_local):
        for j in range(n_local):
            if not bm[j] or bk_a[j] != ak[i]:
                continue
            for k in range(n_local):
                if cm[k] and ck[k] == np.int64(bk_b[j]):
                    total += av[i] * cv[k]
    return float(total)


class _CanonArg:
    """Minimal expression stand-in for the canonical grouped kernel:
    grouped_partial_states only reads `.args[0].ftype` and calls the
    arg_fn closure, which ignores the expression object."""

    def __init__(self, ftype):
        self.ftype = ftype


def _canonical_grouped_fn(S: int, cap_out: int, cap_g: int):
    """Canonical grouped-partial + on-device-merge program: one int64
    group key + one f64 measure over cap_out joined rows — per-shard
    sort-group into cap_g slots, all_gather of the compacted
    (key, state) rows, second sort-merge, per-shard slice emission.
    The group BUDGET is a runtime scalar tensor: kernelcheck asserts the
    op sequence is IDENTICAL across budget values.  Every argument but
    the budget holds one tensor a shard."""
    from ..copr.fusion import (grouped_partial_states,
                               merge_grouped_partials,
                               sort_group_segments)
    from ..expr.aggregation import AggDesc
    from ..types import FieldType, TypeKind

    f64 = FieldType(TypeKind.FLOAT)
    aggs = [AggDesc("count", [], False, FieldType(TypeKind.INT)),
            AggDesc("sum", [_CanonArg(f64)], False, f64)]
    gchunk = cap_g // S

    def shard_fn(gk, gv, meas, mm, gbudget):
        keys, oks, states, over_l = [], [], [], []
        for s in range(S):
            key_bits = [torch.where(gv[s], gk[s], torch.zeros_like(gk[s]))]
            key_flags = [gv[s].to(torch.int64)]
            order, sm, skeys, seg, pos, n_uniq = sort_group_segments(
                key_bits, key_flags, mm[s], cap_g)
            states.append(grouped_partial_states(
                aggs, lambda e, s=s: (meas[s], mm[s]), order, sm, seg,
                cap_g))
            keys.append([k[pos] for k in skeys])
            over_l.append(torch.clamp(n_uniq - gbudget, min=0))
            oks.append(torch.arange(cap_g, dtype=torch.int64,
                                    device=gk[s].device)
                       < torch.clamp(n_uniq, max=cap_g))
        g_keys = [replicate([k[i] for k in keys]) for i in range(2)]
        g_ok = replicate(oks)
        g_cnt = replicate([st[0] for st in states])
        g_sum = replicate([st[1][0] for st in states])
        g_sc = replicate([st[1][1] for st in states])
        out = []
        for s in range(S):
            mn_uniq, m_keys, m_states = merge_grouped_partials(
                aggs, [g_keys[0][s]], [g_keys[1][s]], g_ok[s],
                [g_cnt[s], (g_sum[s], g_sc[s])], cap_g)
            lo = s * gchunk
            out.append((torch.clamp(mn_uniq - gbudget, min=0).reshape(1),
                        mn_uniq.reshape(1),
                        tuple(k[lo:lo + gchunk] for k in m_keys),
                        (m_states[0][lo:lo + gchunk],
                         tuple(x[lo:lo + gchunk] for x in m_states[1]))))
        return ops.psum(over_l), out

    return shard_fn


def trace_grouped_agg_kernel(budget: int = 7):
    """The canonical grouped-partial + merge program at S = 1 on the
    current device, run once under the lint's op recorder; `budget`
    rides the runtime scalar tensor — lint.kernelcheck runs two budgets
    and requires identical op sequences (the budget must never shape
    the program).  Returns the OpTrace."""
    from ..lint.kernelcheck import trace_program

    S, cap_out, cap_g = 1, 256, 32
    dev = ops.device()
    args = (
        [torch.zeros(cap_out, dtype=torch.int64, device=dev)],
        [torch.ones(cap_out, dtype=torch.bool, device=dev)],
        [torch.zeros(cap_out, dtype=torch.float64, device=dev)],
        [torch.ones(cap_out, dtype=torch.bool, device=dev)],
        torch.tensor(budget, dtype=torch.int64, device=dev),
    )
    return trace_program(_canonical_grouped_fn(S, cap_out, cap_g),
                         *args)[1]

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


def expand_matches(sbk, bord, nb, probe_keys, probe_emit, probe_match_ok,
                   cap_out: int, louter: bool):
    """Two-pass count+emit join expansion over NON-UNIQUE build keys.

    Pass 1 (count): each probe row's match span in the sorted build keys
    is [lo, hi) via two searchsorteds; cnt = hi - lo candidate matches.
    Pass 2 (emit): output slot t maps back to its source probe row via a
    searchsorted of `arange(cap_out)` over the exclusive prefix sums —
    every (probe row, match ordinal) pair lands in one of `cap_out`
    static output slots.

    Left-outer probe rows with no match still emit ONE row (`matched`
    False there — the engine NULL-extends the build columns).  Total
    emissions beyond cap_out are DROPPED on the card; the returned
    overflow scalar is how the host learns the result is incomplete.

    Returns (src, bidx, out_valid, matched, overflow): per-slot source
    probe row, matched build source row, slot-live mask, true-match-span
    mask, and the clamped overflow count."""
    n = probe_keys.shape[0]
    pk = probe_keys.contiguous()
    lo = torch.searchsorted(sbk, pk)
    hi = torch.minimum(torch.searchsorted(sbk, pk, right=True), nb)
    zero = torch.zeros_like(lo)
    cnt = torch.where(probe_match_ok, torch.clamp(hi - lo, min=0), zero)
    emit_cnt = (torch.where(probe_emit, torch.clamp(cnt, min=1), zero)
                if louter else cnt)
    total = emit_cnt.sum()
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

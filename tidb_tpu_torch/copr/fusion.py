"""Whole-fragment fusion: one device pass per pushed-down fragment.

Flare (PAPERS.md) showed the order-of-magnitude wins come from running
an ENTIRE stage natively instead of operator-at-a-time; "Query
Processing on Tensor Computation Runtimes" maps full relational
fragments onto single tensor programs.  This module is that idea for
the torch engine:

- **Phase emitters** (`selection_mask`, `dense_group_codes`,
  `dense_agg_results`, `topn_key`, `projection_outputs`, and the
  sort-group pair `sort_group_segments` / `grouped_partial_states`):
  each pushed phase of a fragment — filter, project, group-code,
  aggregate, topN — emits torch ops over a shared context
  (`RegionContext`) instead of owning its own dispatch.  The
  whole-table program (`parallel._build_mesh_core`) composes them, so
  scan→filter→project→agg→topN runs as one sequence of device ops whose
  intermediates never leave the card; the per-tile program
  (`torch_engine._tile_core`) composes the same emitters.  Each mesh
  shard runs them over its own rows; the cross-shard merge of the JAX
  package's psum is `ops.psum`, a sum in shard order
  (`parallel._merge_shard_agg`).

- **Computed keys and dictionary predicates** (`build_key_remap`,
  `dict_pred_codes`): a function of one dictionary-encoded string
  column is evaluated on the host once per DICTIONARY entry, never per
  row; rows then regather their codes through the result on the card
  (`remap_codes`, the hand-written CUDA kernel K1) or test code-set
  membership.

- **Fusion regions + fallback ladder** (`plan_regions`,
  `run_fragment`): a fragment containing one unfusable operator does
  not demote the WHOLE fragment to the CPU interpreter.  The splitter
  finds the longest device-compilable executor prefix (the fused
  region) and peels the remainder into a host tail the CPU engine
  evaluates over the region's output chunks.  The chaos site
  `copr/fusion_split` forces splits at arbitrary boundaries.

- **Cold columns** (`decode_packed`): bit-packed dictionary codes of
  the cold tier unpack on the card with the hand-written CUDA kernel
  (copr/cuda, K2 in PERF.md); a `range` column's decode (code + lo)
  runs in the same kernel pass, a `unique` one's gather after it.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from .. import ops
from ..store.fault import FAILPOINTS
from ..util_concurrency import make_lock
from .ir import DAG
from .torch_eval import DeviceUnsupported, compile_expr

#: chaos site: an armed action may raise DeviceUnsupported to force the
#: splitter to cut the fused region at an arbitrary executor boundary
SPLIT_FAILPOINT = "copr/fusion_split"

#: the measured split-reason inventory: every host-tail split carries one
#: of these labels on `fusion_splits_reason_*_total`, /status and
#: INFORMATION_SCHEMA.TIDB_TPU_FUSION_SPLITS
SPLIT_REASONS = ("unsupported-op", "computed-key", "compound-order",
                 "head-shape", "agg-overflow")


def classify_split_reason(msg: Optional[str]) -> str:
    """Map a DeviceUnsupported message onto the split-reason inventory."""
    m = (msg or "").lower()
    if "group key" in m and ("string" in m or "computed" in m
                             or "remap" in m):
        return "computed-key"
    if "sort key" in m or "compound order" in m or "order key" in m:
        return "compound-order"
    return "unsupported-op"


def note_split(label: Optional[str], boundary: str):
    """Count one region split under its reason label and annotate the
    active trace."""
    from ..metrics import REGISTRY
    from ..trace import annotate

    label = label if label in SPLIT_REASONS else "unsupported-op"
    REGISTRY.inc("fusion_splits_total")
    REGISTRY.inc("fusion_splits_reason_"
                 + label.replace("-", "_") + "_total")
    annotate(fusion_split=boundary, fusion_split_reason=label)


def fusion_enabled() -> bool:
    """Whole-fragment fusion switch (TIDB_TPU_FUSION=0 turns the fused
    program off; the request then leaves the device path)."""
    return os.environ.get("TIDB_TPU_FUSION", "1") != "0"


# ---------------------------------------------------------------------------
# phase emitters
# ---------------------------------------------------------------------------


@dataclass
class RegionContext:
    """The shared context one fused program body emits into.

    Phase emitters read/extend `cols` (the column environment) and AND
    into `mask` (live-row mask).
    """

    an: object                  # torch_engine._Analyzed of the fused region
    cols: dict                  # col index -> (data, valid) tensors
    n: int                      # vector length (padded table rows)
    mask: torch.Tensor          # live-row bool vector
    gofs: Optional[torch.Tensor] = None  # global row offsets
    n_global: int = 0           # total rows (argfirst sentinel)


def selection_mask(ctx: RegionContext):
    """AND every pushed condition into the live-row mask."""
    m = ctx.mask
    for c in ctx.an.conds:
        d, v = compile_expr(c, ctx.cols, ctx.n)
        m = m & v & (d != 0)
    ctx.mask = m
    return m


def dense_group_codes(ctx: RegionContext):
    """Mixed-radix dense group codes; NULL key rows drop from the mask
    (NULL keys are excluded by _Analyzed's dense-mode gate)."""
    an = ctx.an
    gidx = torch.zeros(ctx.n, dtype=torch.int64, device=ctx.mask.device)
    stride = 1
    m = ctx.mask
    for kcol, (klo, card) in zip(an.group_cols, an.group_card):
        d, v = ctx.cols[kcol]
        code = torch.clamp(d.to(torch.int64) - klo, 0, card - 1)
        gidx = gidx + code * stride
        m = m & v
        stride *= card
    ctx.mask = m
    return gidx


def dense_agg_kernel_path(mask, num_groups: int) -> bool:
    """Whether a dense aggregation takes K3 (`copr/cuda.dense_agg`) for
    its integer partial states: on the card, an unbatched mask and no
    more than `UNROLL_G` groups.  The micro-batcher's [B, n] masks,
    wider aggregations and the CPU keep the masked segment reductions
    (K3's plain version is their composition)."""
    from ..ops.segment import UNROLL_G

    return mask.is_cuda and mask.dim() == 1 and num_groups <= UNROLL_G


def dense_agg_results(ctx: RegionContext, gidx):
    """The dense segment reductions for every aggregate in the region:
    (gcount, results) in the layout `parallel._merge_mesh_agg` (or, per
    tile, `torch_engine._merge_device_agg`) folds.  first_row emits the
    first GLOBAL row index per group when the context has row offsets
    (`gofs`), else the first tile-local index.

    The integer states (gcount, every count, every sum with an integer
    state) come from `_int_states`: one K3 launch where
    `dense_agg_kernel_path` holds, else the masked segment reductions.
    Float sums, min, max and first_row values are masked segment
    reductions either way.  The registry counts each call under
    `copr_dense_agg_kernel_total` or `copr_dense_agg_plain_total`."""
    from ..metrics import REGISTRY
    from ..types import TypeKind
    from .torch_engine import _to_state_dtype

    an = ctx.an
    G = an.num_groups
    m = ctx.mask
    kernel = dense_agg_kernel_path(m, G)
    REGISTRY.inc("copr_dense_agg_kernel_total" if kernel
                 else "copr_dense_agg_plain_total")
    spans = ops.SpanOrder(gidx, G)  # one sort for every float sum
    # (int64 values or None, validity, m & validity if made): the
    # operands whose sum and count `_int_states` computes
    operands = []
    plan = []  # per aggregate: (kind, value or None, operand index)
    for a in an.agg.aggs:
        if a.name == "count" and not a.args:
            plan.append(("gcount", None, None))
            continue
        d, v = compile_expr(a.args[0], ctx.cols, ctx.n)
        kind, value, vals, mv = "pair", None, None, None
        if a.name == "count":
            kind = "count"
        elif a.name in ("sum", "avg"):
            st = a.partial_types()[0]
            dd = _to_state_dtype(d, a.args[0].ftype, st)
            if st.kind != TypeKind.FLOAT:
                kind, vals = "sum", dd
            else:
                mv = m & v
                value = ops.masked_segment_sum(dd, gidx, mv, G, spans)
        elif a.name == "min":
            mv = m & v
            value = ops.masked_segment_min(d, gidx, mv, G)
        elif a.name == "max":
            mv = m & v
            value = ops.masked_segment_max(d, gidx, mv, G)
        elif a.name == "first_row":
            plan.append(("value", _first_row(ctx, gidx, m & v, G), None))
            continue
        else:
            continue
        plan.append((kind, value, len(operands)))
        operands.append((vals, v, mv))
    gcount, sums, counts = _int_states(gidx, m, operands, G, kernel)
    results = []
    for kind, value, k in plan:
        if kind == "gcount":
            results.append(gcount)
        elif kind == "value":
            results.append(value)
        elif kind == "count":
            results.append(counts[k])
        else:
            results.append((sums[k] if kind == "sum" else value, counts[k]))
    return gcount, results


def _int_states(gidx, m, operands, G: int, kernel: bool):
    """gcount and, per (values or None, validity, m & validity or None)
    operand, the sum of its values and the count over the rows of `m`
    and its validity (the sum of a count-only operand is not used): one
    K3 launch per `MAX_K` operands when `kernel`, else ops/segment.py's
    masked sums and counts."""
    if not kernel:
        gcount = ops.masked_segment_count(gidx, m, G)
        sums, counts = [], []
        for vals, v, mv in operands:
            mv = m & v if mv is None else mv
            sums.append(None if vals is None
                        else ops.masked_segment_sum(vals, gidx, mv, G))
            counts.append(ops.masked_segment_count(gidx, mv, G))
        return gcount, sums, counts
    # the package's attribute, so that a recorder can stand in for it
    from .cuda import dense_agg
    from .cuda.dense_agg import MAX_K

    m = m.contiguous()
    rows = []
    for i in range(0, max(len(operands), 1), MAX_K):
        part = operands[i:i + MAX_K]
        rows.append(dense_agg(
            gidx, m, [d if d is None else d.contiguous() for d, _, _ in part],
            [v.contiguous() for _, v, _ in part], G).unbind(0))
    return (rows[0][0], [s for r in rows for s in r[1::2]],
            [c for r in rows for c in r[2::2]])


def _first_row(ctx: RegionContext, gidx, mv, G: int):
    if ctx.gofs is not None:
        # first GLOBAL row index (n_global when the group is empty)
        contrib = torch.where(
            mv, ctx.gofs, torch.full_like(ctx.gofs, ctx.n_global))
        return ops.segment_min(contrib, gidx, G)
    # per tile: the tile-local index (TILE when empty)
    return ops.masked_segment_argfirst(gidx, mv, G)


def topn_key(ctx: RegionContext):
    """The TopN sort key with MySQL NULL ordering: first ascending, last
    descending.  The sentinel stays distinguishable from masked-out rows
    (masked_top_k uses -inf for those), so NULLs get a finite extreme:
    -MAX asc (sorts first), -MAX desc (sorts last but still beats masked
    rows).

    Multi-column orderings with a packed compound spec (`an.topn_pack`)
    emit ONE lexicographically exact integer key instead (see
    `compound_topn_key`).  Callers sort the packed key ASCENDING."""
    if ctx.an.topn_pack is not None:
        return compound_topn_key(ctx)
    key_expr, _desc = ctx.an.topn.order_by[0]
    d, v = compile_expr(key_expr, ctx.cols, ctx.n)
    key = d.to(torch.float64)
    return torch.where(v, key, torch.full_like(key, -1.7e308))


def compound_topn_key(ctx: RegionContext):
    """The packed lexicographic key over `an.topn_pack` specs: per key
    (col_idx, lo, hi, slots, desc, has_null), rank ascending-first-wins,
    strides most-significant-first; the product of slots is capped at
    2**52 by the analyzer so the f64 comparison stays exact."""
    key = torch.zeros(ctx.n, dtype=torch.int64, device=ctx.mask.device)
    for col_idx, lo, hi, slots, desc, has_null in ctx.an.topn_pack:
        d, v = ctx.cols[col_idx]
        d = d.to(torch.int64)
        if desc:
            # largest value first; NULLs last (MySQL desc ordering)
            rank = torch.clamp(hi - d, 0, slots - 1)
            if has_null:
                rank = torch.where(v, rank, torch.full_like(rank, slots - 1))
        else:
            # NULLs first ascending: slot 0 reserved when nullable
            if has_null:
                rank = torch.where(v, torch.clamp(d - lo, 0, slots - 2) + 1,
                                   torch.zeros_like(d))
            else:
                rank = torch.clamp(d - lo, 0, slots - 1)
        key = key * slots + rank
    return key.to(torch.float64)


def projection_outputs(ctx: RegionContext):
    """The fused projection expressions (device-evaluated outputs)."""
    return [compile_expr(p, ctx.cols, ctx.n) for p in ctx.an.proj_exprs]


def topn_desc(an) -> bool:
    """The descending flag of the device top-k: packed compound keys
    already fold each key's direction into the rank, so they always sort
    ASCENDING; single keys keep their own flag."""
    if an.topn_pack is not None:
        return False
    return an.topn.order_by[0][1]


# ---------------------------------------------------------------------------
# computed string group keys: device-side dictionary-code re-mapping
# ---------------------------------------------------------------------------


class KeyRemap:
    """One computed group key lowered to a code-space gather.

    `mapping` (pow2-padded to `cap`) rides as a RUNTIME operand of the
    fused program: row code -> computed-key output.  STRING keys map
    code -> output-dictionary code (int32) and `out_dict` (sorted so
    code order == string order) decodes the compacted group keys
    host-side after readback; INT-valued computed keys (LENGTH/ASCII)
    map code -> the computed VALUE directly (int64, `out_dict` None).
    `on_device` uploads the mapping once per device; the remap itself is
    cached per base version, so a mapping crosses the link once per
    base version, not once per query."""

    __slots__ = ("src_idx", "mapping", "cap", "out_dict", "_dev")

    def __init__(self, src_idx: int, mapping: np.ndarray, cap: int,
                 out_dict: Optional[List[str]]):
        self.src_idx = src_idx
        self.mapping = mapping
        self.cap = cap
        self.out_dict = out_dict
        self._dev = {}

    def on_device(self, dev: torch.device) -> torch.Tensor:
        t = self._dev.get(dev)
        if t is None:
            from .parallel import to_device

            t = self._dev.setdefault(dev, to_device(self.mapping, dev))
        return t


def _single_dict_column(expr, scan, table, cols=None):
    """The ONE dict-encoded string column a remappable expression reads,
    or None.  The structural walk is the SHARED
    `pushdown.dict_computable_columns` /
    `pushdown._computed_dict_tree_columns` (one source of truth with the
    planner gate and plancheck); this adds the engine-side identity
    check: a single scan index whose store column is dict-encoded."""
    from ..expr.pushdown import (_computed_dict_tree_columns,
                                 dict_computable_columns)

    if cols is None:
        cols = dict_computable_columns(expr)
        if cols is None:
            cols = _computed_dict_tree_columns(expr)
    if cols is None:
        return None
    idxs = {c.index for c in cols}
    if len(idxs) != 1:
        return None
    idx = next(iter(idxs))
    if not (0 <= idx < len(scan.columns)):
        return None  # join payload column: no store dictionary
    store_ci = scan.columns[idx]
    if store_ci not in table.dict_encoded_cols():
        return None
    return idx


_REMAP_MU = make_lock("copr.fusion:_REMAP_MU")
#: (store_uid, base_version, expr json) -> KeyRemap (or a predicate's
#: code set); the host pays the per-dictionary evaluation ONCE per base
#: version, not once per query.  Bounded: superseded base versions purge
#: per store, and the whole map caps at _REMAP_CACHE_MAX entries (FIFO).
_REMAP_CACHE: dict = {}
_REMAP_CACHE_MAX = 256


def _remap_cache_key(table, expr, prefix: str = ""):
    from .ir import serialize_expr

    return (table.store_uid, table.base_version,
            prefix + json.dumps(serialize_expr(expr), sort_keys=True))


def _remap_cache_put(ck, value):
    with _REMAP_MU:
        while len(_REMAP_CACHE) >= _REMAP_CACHE_MAX:
            _REMAP_CACHE.pop(next(iter(_REMAP_CACHE)))  # FIFO victim
        _REMAP_CACHE[ck] = value


def build_key_remap(table, scan, expr) -> KeyRemap:
    """Lower a computed group key over a dict-encoded column to a
    code-space re-mapping: evaluate the expression once per DICTIONARY
    entry on the host (|dict| rows, not |table| rows), sort-unique the
    outputs into a new dictionary, and hand the code->code mapping to
    the device as a runtime gather operand.  Raises DeviceUnsupported
    with a 'computed group key' message (the computed-key split reason)
    when the expression is not remappable."""
    ck = _remap_cache_key(table, expr)
    with _REMAP_MU:
        hit = _REMAP_CACHE.get(ck)
        if hit is not None:
            return hit
        # drop remaps of superseded base versions for this store
        for k in [k for k in _REMAP_CACHE
                  if k[0] == ck[0] and k[1] != ck[1]]:
            del _REMAP_CACHE[k]
    rm = _build_key_remap_uncached(table, scan, expr)
    _remap_cache_put(ck, rm)
    return rm


def _eval_over_dictionary(table, scan, expr, idx):
    """Evaluate `expr` once per DICTIONARY entry of scan column `idx`
    (the shared recipe of the key-remap and predicate-code lowerings):
    a chunk wide enough for the source index, every other slot a zero
    placeholder — only the source column is ever read (checked by
    _single_dict_column)."""
    from ..chunk import Chunk, Column
    from ..types import ty_string

    store_ci = scan.columns[idx]
    dictionary = table.cols[store_ci].dictionary or []
    if not dictionary:
        raise DeviceUnsupported("computed dict expression over empty "
                                "dictionary")
    nd = len(dictionary)
    vals = np.empty(nd, dtype=object)
    vals[:] = [str(s) for s in dictionary]
    cols = []
    for j in range(idx + 1):
        if j == idx:
            cols.append(Column(ty_string(False), vals))
        else:
            cols.append(Column(scan.ftypes[j],
                               np.zeros(nd, dtype=np.int64)))
    return expr.eval(Chunk(cols)), nd


def _build_key_remap_uncached(table, scan, expr) -> KeyRemap:
    from ..types import TypeKind

    if expr.ftype.kind not in (TypeKind.STRING, TypeKind.INT,
                               TypeKind.UINT):
        raise DeviceUnsupported(
            f"computed group key not dict-remappable: {expr}")
    idx = _single_dict_column(expr, scan, table)
    if idx is None:
        raise DeviceUnsupported(
            f"computed string group key not dict-remappable: {expr}")
    out, nd = _eval_over_dictionary(table, scan, expr, idx)
    if not np.all(out.validity()):
        raise DeviceUnsupported(
            f"computed group key maps entries to NULL: {expr}")
    cap = 2
    while cap < nd:
        cap <<= 1
    if expr.ftype.kind != TypeKind.STRING:
        # INT-valued computed key (LENGTH/ASCII): the mapping carries
        # the computed VALUE per code — no output dictionary, the key
        # bits ARE the values
        mapping = np.zeros(cap, dtype=np.int64)
        mapping[:nd] = [int(x) for x in out.data]
        return KeyRemap(idx, mapping, cap, None)
    outs = [str(x) for x in out.data]
    out_dict = sorted(set(outs))
    rank = {s: i for i, s in enumerate(out_dict)}
    mapping = np.zeros(cap, dtype=np.int32)
    mapping[:nd] = [rank[s] for s in outs]
    return KeyRemap(idx, mapping, cap, out_dict)


def dict_pred_codes(table, scan, expr):
    """Lower a computed predicate over ONE dict-encoded column to its
    matching CODE SET (LIKE / SUBSTR / LENGTH predicates): evaluate the
    whole predicate once per dictionary entry on the host (NULL -> no
    match, SQL filter semantics) and return (src_idx, sorted matching
    codes ndarray, dictionary size).  Raises DeviceUnsupported when not
    lowerable.  Cached per (store, base_version, expr) alongside the key
    remaps."""
    from ..expr.pushdown import dict_pred_source

    cols = dict_pred_source(expr)
    idx = (_single_dict_column(expr, scan, table, cols=cols)
           if cols is not None else None)
    if idx is None:
        raise DeviceUnsupported(
            f"predicate not dict-code-loweable: {expr}")
    ck = _remap_cache_key(table, expr, prefix="pred:")
    with _REMAP_MU:
        hit = _REMAP_CACHE.get(ck)
    if hit is not None:
        return hit
    out, nd = _eval_over_dictionary(table, scan, expr, idx)
    truth = np.zeros(nd, dtype=np.bool_)
    valid = out.validity()
    for i, v in enumerate(out.data):
        if valid[i] and v:
            truth[i] = True  # NULL predicate results drop the row
    res = (idx, np.flatnonzero(truth).astype(np.int64), nd)
    _remap_cache_put(ck, res)
    return res


def remap_codes(codes, mapping, n: int):
    """Code-space gather emitter: dictionary codes -> computed-key
    values through a runtime mapping operand, with the hand-written CUDA
    kernel K1 (`copr.cuda.remap_codes`; its plain torch version on CPU
    tensors)."""
    from .cuda import remap_codes as k1

    return k1(codes.reshape(n), mapping, n)


def decode_packed(packed, dict_arg, bits: int, n: int,
                  kind: str = "unique"):
    """Decode emitter for COLD-TIER columns (tidb_tpu_torch/layout):
    bit-packed dictionary codes -> the column's value vector.

    `packed` holds n * bits / 8 bytes.  The unpack is the hand-written
    CUDA kernel K2 (`copr.cuda.unpack_codes`; its plain torch version on
    CPU tensors).  `dict_arg` is a device operand: for 'range'
    dictionaries the 0-d bias (decode = code + lo), which K2 adds in the
    same pass, so a range column costs one launch and no further op; for
    'unique' (float) dictionaries the value vector, indexed by the codes
    K2 unpacks."""
    from .cuda import unpack_codes

    if kind == "range":
        return unpack_codes(packed.reshape(-1), bits, n, bias=dict_arg)
    code = unpack_codes(packed.reshape(-1), bits, n)
    return dict_arg[code.to(torch.int64)]


# ---------------------------------------------------------------------------
# grouped sort-agg emitters (parallel._build_sort_agg_core)
# ---------------------------------------------------------------------------


def _lexsort(keys):
    """The permutation `jnp.lexsort(keys)` gives: the LAST key is
    primary, ties keep their row order.  torch has no lexsort, so it
    chains stable sorts from the least significant key up."""
    order = None
    for k in keys:
        kk = k if order is None else k[order]
        idx = torch.sort(kk, stable=True).indices
        order = idx if order is None else order[idx]
    return order


def sort_group_segments(key_bits, key_flags, mask, cap, order=None,
                        diff=None):
    """Sort-based grouping into a static `cap`-slot budget.

    Sorts rows by (key bits..., null flags..., selected-first) as
    `jnp.lexsort` orders them (the last key primary), marks group
    boundaries, and clips segment ids to [0, cap).  The 0/1 keys (the
    null flags and the unselected flag) pack into ONE int64 whose
    numeric order is their lexicographic order, so the sort costs one
    stable pass per key plus one.  Callers with a cheaper total order
    (the fd-lookup single-int sort) pass their own `order` and boundary
    `diff` and reuse only the segment layout.

    Returns (order, sm, skeys, seg, pos, n_uniq): the sort permutation,
    sorted selection mask, sorted key arrays, per-row segment ids, the
    first-row-per-group positions (padded with n-1 to `cap`), and the
    TRUE distinct-group count — n_uniq > cap means the budget blew and
    slots past cap-1 hold merged garbage; the caller must treat the
    result as overflowed.  Finding the positions (`torch.nonzero`)
    waits for the card once."""
    n = mask.shape[0]
    dev = mask.device
    if order is None:
        flags = (~mask).to(torch.int64)
        for f in reversed(key_flags):
            flags = flags * 2 + f
        order = _lexsort(list(key_bits) + [flags])
    sm = mask[order]
    skeys = [k[order] for k in list(key_bits) + list(key_flags)]
    if diff is None:
        diff = torch.zeros(n, dtype=torch.bool, device=dev)
        diff[:1] = True
        for k in skeys:
            diff[1:] |= k[1:] != k[:-1]
    boundary = sm & diff
    n_uniq = boundary.sum()
    seg = torch.clamp(torch.cumsum(boundary, 0) - 1, 0, cap - 1)
    first = torch.nonzero(boundary).reshape(-1)[:cap]
    pos = torch.full((cap,), n - 1, dtype=torch.int64, device=dev)
    pos[:first.shape[0]] = first
    return order, sm, skeys, seg, pos, n_uniq


def _segment_spans(seg, cap):
    """[lo, hi) row spans of slots 0..cap-1 over sort-grouped rows, whose
    segment ids never decrease (unselected rows sit last, in the last
    live slot, and overflowing groups share slot cap-1); an empty slot
    has lo == hi."""
    g = torch.arange(cap, dtype=seg.dtype, device=seg.device)
    return (torch.searchsorted(seg, g),
            torch.searchsorted(seg, g, right=True))


def _sorted_segment_sum(x, spans):
    """Per-slot sums of int64 `x` (zero where a row does not count) over
    the contiguous spans: a prefix sum and two gathers."""
    lo, hi = spans
    pre = torch.zeros(x.shape[0] + 1, dtype=torch.int64, device=x.device)
    torch.cumsum(x, 0, out=pre[1:])
    return pre[hi] - pre[lo]


def grouped_partial_states(aggs, arg_fn, order, sm, seg, cap,
                           sgofs=None, n_global=0):
    """Segment-reduce per-group partial states for every aggregate over
    sort-grouped rows (the layouts `_agg_tags` names: count -> [cap],
    sum/avg/min/max -> ([cap], [cap]) value+count, first_row -> [cap]
    global row indices when `sgofs` is given).

    `arg_fn(expr)` evaluates an aggregate argument in the UNSORTED row
    layout; this emitter applies the sort permutation.

    Counts and integer sums (decimal states are scaled int64) reduce the
    sorted, contiguous segments with a prefix sum: exact in any order,
    deterministic, and free of the atomics that a scatter into a few hot
    slots serializes on.  Float sums reduce each span directly
    (`ops.span_sum`): one fixed order from run to run, and no prefix-sum
    difference, which would round differently from a direct sum."""
    from .torch_engine import _to_state_dtype

    spans = _segment_spans(seg, cap)
    lengths = spans[1] - spans[0]

    def count(m):
        return _sorted_segment_sum(m.to(torch.int64), spans)

    results = []
    for a in aggs:
        if a.name == "count":
            if a.args:
                _d, v = arg_fn(a.args[0])
                results.append(count(sm & v[order]))
            else:
                results.append(count(sm))
            continue
        d, v = arg_fn(a.args[0])
        d, mv = d[order], sm & v[order]
        if a.name in ("sum", "avg"):
            st = a.partial_types()[0]
            dd = _to_state_dtype(d, a.args[0].ftype, st)
            contrib = torch.where(mv, dd, torch.zeros_like(dd))
            if dd.dtype == torch.int64:
                total = _sorted_segment_sum(contrib, spans)
            else:
                total = ops.span_sum(contrib, lengths)
            results.append((total, count(mv)))
        elif a.name == "min":
            results.append((
                ops.masked_segment_min(d, seg, mv, cap), count(mv)))
        elif a.name == "max":
            results.append((
                ops.masked_segment_max(d, seg, mv, cap), count(mv)))
        elif a.name == "first_row":
            contrib = torch.where(mv, sgofs,
                                  torch.full_like(sgofs, n_global))
            results.append(ops.segment_min(contrib, seg, cap))
    return results


def merge_grouped_partials(aggs, key_bits, key_flags, row_valid, states,
                           cap):
    """Merge compacted (key, partial-state) rows — the gathered groups
    of an MPP grouped aggregation — into <= cap merged groups: a second
    sort-group over the partial rows, then state-MERGE reductions
    (counts and sums add, min/max fold only partials with a count > 0,
    first_row keeps the least global row index).

    `states` uses grouped_partial_states' layout per agg.  Returns
    (n_uniq, out_keys, merged_states); n_uniq > cap means the merged
    group count blew the budget.  The sums reduce the sorted segments as
    grouped_partial_states does: a prefix sum for counts and integer
    sums, a direct fixed-order sum of each span for floats."""
    order, sm, skeys, seg, pos, n_uniq = sort_group_segments(
        key_bits, key_flags, row_valid, cap)
    spans = _segment_spans(seg, cap)
    lengths = spans[1] - spans[0]

    def add(x, m):
        x = torch.where(m, x[order], torch.zeros_like(x))
        if x.dtype == torch.int64:
            return _sorted_segment_sum(x, spans)
        return ops.span_sum(x, lengths)

    merged = []
    for a, st in zip(aggs, states):
        if a.name == "count":
            merged.append(add(st, sm))
        elif a.name in ("sum", "avg"):
            s, c = st
            merged.append((add(s, sm), add(c, sm)))
        elif a.name in ("min", "max"):
            v, c = st
            mv = sm & (c[order] > 0)  # empty partials carry sentinels
            red = (ops.masked_segment_min if a.name == "min"
                   else ops.masked_segment_max)
            merged.append((red(v[order], seg, mv, cap), add(c, sm)))
        else:  # first_row: the smallest global row index wins
            merged.append(ops.masked_segment_min(st[order], seg, sm, cap))
    out_keys = tuple(k[pos] for k in skeys)
    return n_uniq, out_keys, merged


# ---------------------------------------------------------------------------
# fusion regions: split a fragment at unfusable boundaries
# ---------------------------------------------------------------------------


@dataclass
class FusionPlan:
    """One fragment's fused region plus its host tail."""

    dag: DAG                      # scan + the fused executor prefix
    an: object                    # its _Analyzed
    tail: List = field(default_factory=list)  # host-run executor suffix
    split_reason: Optional[str] = None        # why the region was cut
    reason_label: Optional[str] = None        # SPLIT_REASONS inventory


def plan_regions(dag: DAG, table, max_cut: Optional[int] = None
                 ) -> FusionPlan:
    """Longest device-compilable executor prefix → fused region; the
    suffix becomes the host tail (the per-phase fallback ladder).
    Raises DeviceUnsupported (with the first rejection's reason) when
    not even the bare scan analyzes — the CPU interpreter owns those
    fragments outright.

    A region whose head ends in a device PROJECTION may still carry a
    host tail (the tail reads the projected layout).  Partial-agg and
    topN heads refuse tails: a Limit over whole-table partials would drop groups,
    so those peel to the deepest safe boundary and the split is labelled
    'head-shape'."""
    from .torch_engine import _Analyzed

    execs = dag.executors
    hi = len(execs) if max_cut is None else min(max_cut, len(execs))
    reason: Optional[str] = None
    guard_cut: Optional[int] = None
    for cut in range(hi, 0, -1):
        head, tail = execs[:cut], list(execs[cut:])
        try:
            if cut > 1:
                # chaos: an armed action raises DeviceUnsupported to
                # force the split one boundary earlier
                FAILPOINTS.hit(SPLIT_FAILPOINT, cut=cut,
                               boundary=type(head[-1]).__name__)
            sub = DAG(list(head))
            an = _Analyzed(sub, table)
        except DeviceUnsupported as e:
            if reason is None:
                reason = str(e)
            continue
        if tail and (an.agg is not None or an.topn is not None):
            # partial agg / topn outputs must not feed tail executors (a
            # Limit over whole-table partials would drop groups) — keep
            # peeling; projection heads ARE hybrid-eligible
            if guard_cut is None:
                guard_cut = cut
            continue
        label = None
        if tail:
            label = ("head-shape"
                     if guard_cut is not None and cut < guard_cut
                     else classify_split_reason(reason))
        return FusionPlan(sub, an, tail,
                          split_reason=reason if tail else None,
                          reason_label=label)
    raise DeviceUnsupported(reason or "no device-eligible fused region")


def run_tail(dag: DAG, tail: List, chunks, aux=None):
    """Interpret a host tail over the fused region's output chunks (the
    CPU engine is the tail's executor).  Partial-agg tails stay partial —
    the root executor merges, exactly as for an all-host region."""
    from .cpu_engine import run_dag_on_chunk

    if not tail:
        return chunks
    tail_dag = DAG([dag.scan] + list(tail))
    out = []
    for c in chunks:
        r = run_dag_on_chunk(tail_dag, c, aux)
        if r.num_rows:
            out.append(r)
    return out


def run_fragment(table, dag: DAG, start: int, end: int, deleted,
                 aux=None):
    """Per-region fused execution with the fallback ladder, the rung
    below the whole-table program: run the largest region the per-tile
    program (`torch_engine.run_base_torch`) accepts, stepping the cut
    down one executor per DeviceUnsupported; the host tail runs over
    the region's output.  Raises DeviceUnsupported only when no region
    beyond the bare scan is device-eligible (the caller's CPU
    interpreter is then cheaper than a device scan-only pass).  Any
    other error of the device program reaches the caller."""
    from .torch_engine import run_base_torch

    cut: Optional[int] = None
    while True:
        plan = plan_regions(dag, table, max_cut=cut)
        if plan.tail and len(plan.dag.executors) == 1:
            # a device scan-only region reduces nothing; the CPU
            # interpreter over host blocks is cheaper
            raise DeviceUnsupported(
                plan.split_reason or "no device-eligible fused region")
        try:
            chunks = run_base_torch(table, plan.dag, start, end, deleted,
                                    aux=aux, an=plan.an)
            break
        except DeviceUnsupported:
            if len(plan.dag.executors) == 1:
                raise
            cut = len(plan.dag.executors) - 1
    if plan.tail:
        note_split(plan.reason_label, type(plan.tail[0]).__name__)
        chunks = run_tail(dag, plan.tail, chunks, aux)
    return chunks


# ---------------------------------------------------------------------------
# lint kernelcheck: run whole-fragment mesh programs on canonical inputs
# ---------------------------------------------------------------------------


def trace_fused_fragment(table, dag, n_ranges: int = 1, cold: bool = False,
                         dict_shift: int = 0):
    """Run the whole-fragment MESH program of `parallel._build_mesh_core`
    for one shard of TILE rows on the current device, once, on canonical
    zero inputs under the lint's op recorder; returns its OpTrace (the
    fused-fragment corpus of lint.kernelcheck).  The operands are what
    `parallel._run_mesh_once` hands the program: each column in its wire
    dtype, no validity tensor (the canonical table has no NULL), the
    hoisted predicate parameters, and `n_ranges` range slots.  Raises
    DeviceUnsupported when the fragment has no fused mesh form.

    `cold=True` runs the cold-tier layout class: every packable scan
    column rides as bit-packed codes that unpack through K2, its decode
    operand (the range bias, or the dictionary values) shifted by
    `dict_shift` — two shifts must run the IDENTICAL op sequence (layout
    values are runtime operands, never program shape)."""
    from ..lint.kernelcheck import trace_program
    from ..serving import hoist_conds
    from . import parallel as par
    from . import torch_engine as te

    dag = DAG.from_dict(dag.to_dict())
    plan = plan_regions(dag, table)
    if plan.tail:
        raise DeviceUnsupported(
            plan.split_reason or "no whole-fragment fused form")
    an = plan.an
    kind = "agg" if an.agg is not None else (
        "topn" if an.topn is not None else "filter")
    col_order = an.needed_cols()
    tile = te.TILE
    dev = ops.device()
    datas, valids, col_layout, lvals = [], [], [], []
    for ci in col_order:
        store_ci = an.scan.columns[ci]
        info = None
        if cold:
            from ..layout.coldtier import dict_values, pack_info

            info = pack_info(table, store_ci)
        valids.append(None)
        if info is not None:
            datas.append(torch.zeros((1, tile // (8 // info.bits)),
                                     dtype=torch.uint8, device=dev))
            col_layout.append((info.bits, info.cap, info.kind))
            dt = par.torch_dtype(par._full_dtype(
                table.cols[store_ci].ftype.kind))
            if info.kind == "range":
                lvals.append(torch.tensor(info.lo + dict_shift, dtype=dt,
                                          device=dev))
            else:
                dv = dict_values(table, store_ci, info)
                lvals.append(torch.from_numpy(dv).to(dev) + dict_shift)
        else:
            datas.append(torch.zeros(
                (1, tile), device=dev,
                dtype=par.torch_dtype(par._wire_dtype(table, store_ci))))
            col_layout.append(None)
    if cold and not any(col_layout):
        raise DeviceUnsupported("no cold-packable column in fragment")
    # computed-key remap operands ride the lvals tail AFTER the cold
    # dictionary operands (the ordering _run_mesh_once hands them in)
    for r in (an.key_remaps or ()):
        if r is not None:
            lvals.append(r.on_device(dev))
    hoisted = hoist_conds(an)
    params = None if hoisted is None else tuple(
        torch.from_numpy(h).to(dev) for h in hoisted)
    core = par._build_mesh_core(an, kind, col_order, tile,
                                col_layout=col_layout if cold else None)
    del_mask = torch.ones((1, tile), dtype=torch.bool, device=dev)
    bounds = [(r * 8, r * 8 + 8) for r in range(n_ranges)]
    return trace_program(core, datas, valids, del_mask, bounds,
                         tuple(lvals), (), params, 0)[1]

"""Segmented reductions with selection masks.

The device replacement for the reference's hash-aggregation inner loops
(executor/aggregate.go partial workers): group codes are dense ints, so
partial aggregation is a segment reduction over them.

Sums over few groups (`UNROLL_G` or fewer, every TPC-H Q1-shaped GROUP
BY) take one masked full reduction per group: a tree reduction per group
beats G-way contended atomics on the card.  Above that, integer sums
scatter with ``index_add_`` (int64 addition is exact in any order) and
float sums reduce in one fixed order: a stable sort of the group codes,
then a direct reduction of each contiguous span (`span_sum`), so the
same rows give the same bits on every run — no atomics.  Counts are a
``bincount`` (an exact integer histogram), except for a scalar
aggregate's single group, which is the mask's sum: a bincount into two
bins measured about 4 ms a call over 60 M rows on an H100 (PERF.md).
min/max/argfirst are order-free and use ``scatter_reduce_``.  On the
card, the fused programs' unbatched dense aggregations of at most
`UNROLL_G` groups take their counts and integer sums from one pass of
K3 instead (`copr/cuda.dense_agg`, whose plain version composes these
reductions; chosen in `copr/fusion.dense_agg_results`).

Every masked reduction also takes a batch of masks ``[B, n]`` over one
row layout (the micro-batcher's program, serving/batcher.py): member
b's group g is then segment ``b * G + g`` of one flat segment space and
the result is ``[B, G]``.
"""

from __future__ import annotations

import torch

# Group-count threshold below which sums unroll into one masked full
# reduction per group.
UNROLL_G = 32


def _group_masks(gidx, mask, num_segments: int):
    """Per-group row masks for the unrolled reductions (a scalar
    aggregate's one group is the mask itself)."""
    if num_segments == 1:
        return [mask]
    return [mask & (gidx == g) for g in range(num_segments)]


def _batch_segments(gidx, batch: int, num_segments: int):
    """Flat segment ids of a batch: member b's group g is b * G + g."""
    off = torch.arange(batch, dtype=torch.int64,
                       device=gidx.device)[:, None] * num_segments
    return (gidx + off).reshape(-1)


def span_sum(data, lengths):
    """Sums of consecutive spans of `data` (rows sorted by segment; span
    s holds lengths[s] rows, an empty span sums to 0): each span reduces
    directly in one fixed order, with no atomics and no prefix-sum
    difference (which would round differently from a direct sum)."""
    return torch.segment_reduce(data, "sum", lengths=lengths, unsafe=True)


class SpanOrder:
    """The fixed order in which float sums over one set of group codes
    reduce: a stable sort of the codes and each segment's span length
    (every row, masked-out rows included, so one order serves every
    aggregate over the codes).  Computed on first use and shared: an
    aggregation with k float sums sorts its codes once, not k times.
    For a batch of B members over shared [n] codes, member b's rows
    follow at offset b * n in the same order."""

    __slots__ = ("gidx", "num_segments", "_by_batch")

    def __init__(self, gidx, num_segments: int):
        self.gidx = gidx
        self.num_segments = num_segments
        self._by_batch = {}

    def get(self, batch: int = 0):
        """(order, lengths) over the flat rows; batch 0 = unbatched."""
        hit = self._by_batch.get(batch)
        if hit is None:
            hit = self._by_batch[batch] = self._compute(batch)
        return hit

    def _compute(self, batch: int):
        gidx, G = self.gidx, self.num_segments
        if batch and gidx.dim() == 1:
            order, lengths = self.get(0)
            n = gidx.shape[0]
            off = torch.arange(batch, dtype=torch.int64,
                               device=gidx.device)[:, None] * n
            return (order[None, :] + off).reshape(-1), lengths.repeat(batch)
        flat = _batch_segments(gidx, batch, G) if batch else gidx
        return (torch.argsort(flat, stable=True),
                torch.bincount(flat, minlength=max(batch, 1) * G))


def masked_segment_sum(data, gidx, mask, num_segments: int,
                       spans: SpanOrder = None):
    """sum of data[i] into segment gidx[i] where mask[i].  `spans` is
    the codes' shared `SpanOrder` (made here when not given)."""
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    if num_segments <= UNROLL_G:
        return torch.stack(
            [torch.where(m, data, zero).sum(-1)
             for m in _group_masks(gidx, mask, num_segments)], -1)
    contrib = torch.where(mask, data, zero)
    batch = contrib.shape[0] if contrib.dim() == 2 else 0
    if contrib.dtype.is_floating_point:
        if spans is None:
            spans = SpanOrder(gidx, num_segments)
        order, lengths = spans.get(batch)
        out = span_sum(contrib.reshape(-1)[order], lengths)
    else:
        flat = _batch_segments(gidx, batch, num_segments) if batch else gidx
        out = torch.zeros(max(batch, 1) * num_segments, dtype=contrib.dtype,
                          device=contrib.device)
        out.index_add_(0, flat, contrib.reshape(-1))
    return out.view(batch, num_segments) if batch else out


def masked_segment_count(gidx, mask, num_segments: int):
    """Rows per segment where mask.  Masked-out rows land in a spill bin
    past the last segment, which is dropped."""
    if num_segments == 1:
        return torch.sum(mask, -1, keepdim=True)
    if mask.dim() == 2:
        batch = mask.shape[0]
        return masked_segment_count(
            _batch_segments(gidx, batch, num_segments), mask.reshape(-1),
            batch * num_segments).view(batch, num_segments)
    spill = torch.full_like(gidx, num_segments)
    return torch.bincount(torch.where(mask, gidx, spill),
                          minlength=num_segments + 1)[:num_segments]


def _extreme(dtype, want_max: bool):
    if dtype.is_floating_point:
        return float("inf") if want_max else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if want_max else info.min


def _scatter(contrib, gidx, num_segments: int, fill, reduce: str):
    if contrib.dim() == 2:
        batch = contrib.shape[0]
        return _scatter(contrib.reshape(-1),
                        _batch_segments(gidx, batch, num_segments),
                        batch * num_segments, fill,
                        reduce).view(batch, num_segments)
    out = torch.full((num_segments,), fill, dtype=contrib.dtype,
                     device=contrib.device)
    return out.scatter_reduce_(0, gidx, contrib, reduce=reduce,
                               include_self=True)


def masked_segment_min(data, gidx, mask, num_segments: int):
    big = _extreme(data.dtype, True)
    contrib = torch.where(mask, data, torch.full_like(data, big))
    return _scatter(contrib, gidx, num_segments, big, "amin")


def masked_segment_max(data, gidx, mask, num_segments: int):
    small = _extreme(data.dtype, False)
    contrib = torch.where(mask, data, torch.full_like(data, small))
    return _scatter(contrib, gidx, num_segments, small, "amax")


def masked_segment_argfirst(gidx, mask, num_segments: int):
    """Index of the first masked row per segment (for FIRST_ROW);
    num_rows (= the mask's length) where the segment is empty."""
    n = mask.shape[-1]
    idx = torch.arange(n, dtype=torch.int64, device=gidx.device)
    contrib = torch.where(mask, idx, torch.full_like(idx, n))
    return _scatter(contrib, gidx, num_segments, n, "amin")


def segment_min(data, gidx, num_segments: int):
    """Plain (unmasked) segment min; empty segments hold the dtype max."""
    return _scatter(data, gidx, num_segments,
                    _extreme(data.dtype, True), "amin")

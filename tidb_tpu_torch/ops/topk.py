"""Masked top-k for TopN pushdown.

Reference: TopN coprocessor executor (mocktikv/topn.go).  On device:
build a single sortable key per row, mask invalid rows to -inf, take the
k largest, return flat row indices for the host to gather.
"""

from __future__ import annotations

import torch


def masked_top_k(key, mask, k: int, descending: bool):
    """Return (indices, count) of the top/bottom-k masked rows by `key`.

    key: float64/int64 [n]; mask: bool [n].  The indices come ordered by
    key (best first) and, among equal keys, by row index ascending, so
    the choice among ties is deterministic.  `torch.topk` promises no
    order among ties on a card, so it only finds the k-th best key; the
    rows are then picked by an exact rule: every row strictly better,
    then the lowest-index rows equal to it, sorted stably by key.
    """
    n = key.shape[0]
    k = min(k, n)
    kf = key.to(torch.float64)
    if not descending:
        kf = -kf
    kf = torch.where(mask, kf, torch.full_like(kf, float("-inf")))
    count = torch.clamp(mask.sum(), max=k)
    if k == 0:
        return torch.zeros(0, dtype=torch.int64, device=key.device), count
    kth = torch.topk(kf, k).values[k - 1]
    better = kf > kth
    tie = kf == kth
    need = k - better.sum()
    keep = better | (tie & (torch.cumsum(tie, 0) <= need))
    idx = torch.nonzero(keep).reshape(-1)          # ascending row index
    order = torch.sort(kf[idx], descending=True, stable=True).indices
    return idx[order], count

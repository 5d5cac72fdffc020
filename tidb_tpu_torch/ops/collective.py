"""Per-position tensors and the cross-shard merge of the mesh.

A mesh of S positions runs one program per shard, each on its own
position's device (`ops.mesh_devices`).  What a shard holds travels as
a `Shards` tuple, one tensor per position in shard order.  The
collectives are explicit copies in a fixed order, so a merge of float
partials has the same bits on every run at a fixed S and chunking:

- `psum`: a left fold over positions 0..S-1 on position 0's device;
- `on_positions`: one operand on every position (one copy per distinct
  device, shared by the positions that device holds).

The exchange's all_to_all and all_gather live beside the bucket pack
(`mpp.exchange.exchange` / `replicate`).
"""

from __future__ import annotations

from typing import Sequence

import torch


class Shards(tuple):
    """One tensor per mesh position, in shard order (shard s lives on
    position s's device).  `nbytes` counts each distinct tensor once:
    positions that share a device may share an operand."""

    @property
    def nbytes(self) -> int:
        seen, n = set(), 0
        for t in self:
            if id(t) not in seen:
                seen.add(id(t))
                n += int(t.nbytes)
        return n


def on_positions(t: torch.Tensor, devices: Sequence[torch.device]) -> Shards:
    """`t` on every position's device: one copy per distinct device."""
    copies = {}
    out = []
    for d in devices:
        x = copies.get(d)
        if x is None:
            x = copies[d] = t if t.device == d else t.to(d)
        out.append(x)
    return Shards(out)


def psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The cross-shard sum: parts[0] + parts[1] + ... in shard order, on
    position 0's device (float partials add in one fixed order)."""
    acc = parts[0]
    for x in parts[1:]:
        acc = acc + x.to(acc.device)
    return acc


def gather0(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-shard partials stacked [S, ...] on position 0's device (one
    readback for a host-side merge, as min/max merge)."""
    dev = parts[0].device
    return torch.stack([x.to(dev) for x in parts])

"""Device kernels (torch).

The one device choice of the package lives here, where the JAX package
configures x64: SQL semantics need int64 handles and sums and float64
aggregation, and torch keeps both natively on the card.

- the default device is ``cuda``; asking for it on a machine without a
  CUDA device raises instead of quietly running on the host;
- ``use_device("cpu")`` pins the CPU (the tests do this): every entry
  point then runs the plain PyTorch versions of the kernels;
- the mesh is a list of positions (`mesh_devices`): one per visible card
  by default, or S on one device with ``use_device(dev, shards=S)`` (the
  CPU tests run 8, the JAX package's 8 virtual CPU devices).
"""

from __future__ import annotations

import torch

from ..errors import DeviceUnavailableError

_DEVICE = torch.device("cuda")
#: mesh positions placed on the pinned device (None: one per visible card)
_SHARDS = None


def use_device(dev, shards=None) -> torch.device:
    """Pin the device every entry point runs on (``"cuda"`` or ``"cpu"``);
    returns it.  Raises when CUDA is asked for and absent.

    `shards` = S places S mesh positions on that one device (the CPU
    tests run ``use_device("cpu", shards=8)``, the JAX package's 8
    virtual CPU devices); without it the mesh has one position per
    visible card (``"cuda"``), or the one device named (``"cuda:1"``,
    ``"cpu"``)."""
    global _DEVICE, _SHARDS
    d = torch.device(dev)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "CUDA device requested but none is available")
    if shards is not None and int(shards) < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    _DEVICE = d
    _SHARDS = None if shards is None else int(shards)
    return d


def device() -> torch.device:
    """The device entry points run on (position 0's device).  Raises
    when it is CUDA and no CUDA device exists (no silent CPU route)."""
    if _DEVICE.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device: call tidb_tpu_torch.ops.use_device('cpu') "
            "to run on the host")
    return _DEVICE


def mesh_devices():
    """[(position_id, torch.device), ...]: every mesh position, in
    shard order.  A device may hold several positions (`use_device(...,
    shards=S)`); by default each visible card is one position."""
    d = device()
    if d.type == "cuda":
        if _SHARDS is not None or d.index is not None:
            card = torch.device("cuda", d.index or 0)
            return [(i, card) for i in range(_SHARDS or 1)]
        return [(i, torch.device("cuda", i))
                for i in range(max(torch.cuda.device_count(), 1))]
    return [(i, d) for i in range(_SHARDS or 1)]


def device_ids():
    """Stable ids of the mesh positions (the health registry's, the
    column caches' and the trace's device ids)."""
    return tuple(pid for pid, _ in mesh_devices())


def position_device(pid: int) -> torch.device:
    """The torch device of mesh position `pid`."""
    for p, d in mesh_devices():
        if p == pid:
            return d
    raise KeyError(f"no mesh position {pid}")


def positions_on_card(card: int):
    """Every position placed on physical card `card` (an error the
    runtime attributes to a card trips each of them)."""
    return tuple(pid for pid, d in mesh_devices()
                 if d.type == "cuda" and (d.index or 0) == card)


from .segment import (  # noqa: E402
    masked_segment_sum,
    masked_segment_count,
    masked_segment_min,
    masked_segment_max,
    masked_segment_argfirst,
    segment_min,
    span_sum,
    SpanOrder,
)
from .topk import masked_top_k  # noqa: E402
from .collective import Shards, gather0, on_positions, psum  # noqa: E402

__all__ = [
    "use_device",
    "device",
    "device_ids",
    "mesh_devices",
    "position_device",
    "positions_on_card",
    "masked_segment_sum",
    "masked_segment_count",
    "masked_segment_min",
    "masked_segment_max",
    "masked_segment_argfirst",
    "SpanOrder",
    "segment_min",
    "span_sum",
    "masked_top_k",
    "Shards",
    "gather0",
    "on_positions",
    "psum",
]

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
  CPU tests run 8, the JAX package's 8 virtual CPU devices);
- once ``torch.distributed`` is initialized (`copr.parallel.
  _maybe_init_multihost`) the mesh spans every process: process p's L
  local positions carry the global ids p*L ... p*L+L-1, and every
  process places the same L.
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


def process_count() -> int:
    """Processes of the mesh: the torch.distributed world once it is
    initialized, else 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the mesh (0 when it runs alone)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _local_devices():
    """This process's positions' devices, in local order."""
    d = device()
    if d.type == "cuda":
        if _SHARDS is not None or d.index is not None:
            card = torch.device("cuda", d.index or 0)
            return [card] * (_SHARDS or 1)
        return [torch.device("cuda", i)
                for i in range(max(torch.cuda.device_count(), 1))]
    return [d] * (_SHARDS or 1)


def local_positions():
    """[(position_id, torch.device), ...]: this process's positions, in
    shard order, with their global ids."""
    return [(pid, d) for pid, d in mesh_devices() if d is not None]


def position_owner(pid: int) -> int:
    """The process that holds global position `pid`."""
    return pid // len(_local_devices())


def mesh_devices():
    """[(position_id, torch.device or None), ...]: every mesh position
    of every process, in shard order; a position of another process
    has None for its device.  A device may hold several positions
    (`use_device(..., shards=S)`); by default each visible card is one
    position."""
    devs = _local_devices()
    me, L = process_index(), len(devs)
    return [(p * L + i, devs[i] if p == me else None)
            for p in range(process_count()) for i in range(L)]


def device_ids():
    """Stable global ids of this process's positions (the health
    registry's, the column caches' and the trace's device ids)."""
    return tuple(pid for pid, _ in local_positions())


def position_device(pid: int) -> torch.device:
    """The torch device of local mesh position `pid`."""
    for p, d in local_positions():
        if p == pid:
            return d
    raise KeyError(f"no local mesh position {pid}")


def positions_on_card(card: int):
    """Every local position placed on physical card `card` (an error the
    runtime attributes to a card trips each of them)."""
    return tuple(pid for pid, d in local_positions()
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
from .collective import (  # noqa: E402
    Shards,
    agree,
    gather0,
    gather_shards,
    on_positions,
    program,
    psum,
)

__all__ = [
    "use_device",
    "device",
    "device_ids",
    "local_positions",
    "mesh_devices",
    "position_owner",
    "process_count",
    "process_index",
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
    "agree",
    "gather0",
    "gather_shards",
    "on_positions",
    "program",
    "psum",
]

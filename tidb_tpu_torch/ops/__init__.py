"""Device kernels (torch).

The one device choice of the package lives here, where the JAX package
configures x64: SQL semantics need int64 handles and sums and float64
aggregation, and torch keeps both natively on the card.

- the default device is ``cuda``; asking for it on a machine without a
  CUDA device raises instead of quietly running on the host;
- ``use_device("cpu")`` pins the CPU (the tests do this): every entry
  point then runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import torch

from ..errors import DeviceUnavailableError

_DEVICE = torch.device("cuda")


def use_device(dev) -> torch.device:
    """Pin the device every entry point runs on (``"cuda"`` or ``"cpu"``);
    returns it.  Raises when CUDA is asked for and absent."""
    global _DEVICE
    d = torch.device(dev)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "CUDA device requested but none is available")
    _DEVICE = d
    return d


def device() -> torch.device:
    """The device entry points run on.  Raises when it is CUDA and no
    CUDA device exists (no silent CPU route)."""
    if _DEVICE.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device: call tidb_tpu_torch.ops.use_device('cpu') "
            "to run on the host")
    return _DEVICE


def device_ids():
    """Stable ids of the devices the mesh runs on (one card: S = 1)."""
    d = device()
    return (d.index or 0,) if d.type == "cuda" else (-1,)


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

__all__ = [
    "use_device",
    "device",
    "device_ids",
    "masked_segment_sum",
    "masked_segment_count",
    "masked_segment_min",
    "masked_segment_max",
    "masked_segment_argfirst",
    "SpanOrder",
    "segment_min",
    "span_sum",
    "masked_top_k",
]

"""K3, the dense aggregation's integer partial states in one pass, as a
hand-written CUDA kernel.

``dense_agg(gidx, mask, values, valids, num_groups)`` computes,
for G = num_groups <= ``MAX_G`` dense group codes and K operands, one
``[1 + 2K, G]`` int64 tensor:

- row 0: ``gcount[g]``, the rows with ``mask`` and ``gidx == g``;
- row 1 + 2k: the sum of ``values[k]`` over those rows with
  ``valids[k]`` (0 for a count-only operand, whose ``values[k]`` is
  None), wrapping mod 2**64 as torch's int64 sum does;
- row 2 + 2k: the count of those rows.

A masked row's code is non-negative; a code of G or more counts
nowhere, and a masked-out row's code is not read.  With one group no
code is read: every masked row is group 0.  It replaces no TPU kernel:
the JAX package composes jnp ops here (tidb_tpu/copr/fusion.py
``dense_agg_results`` over tidb_tpu/ops/segment.py); the CUDA source is
``csrc/dense_agg.cu``.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it takes ``dense_agg_plain``, the composition of ops/segment.py's
masked sums and counts that the kernel replaces.  ``dense_agg.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ... import ops
from .build import load

#: operands one launch takes, and the most groups (ops/segment.py
#: UNROLL_G): the kernel's kernel-parameter struct and slot arrays
MAX_K = 32
MAX_G = 32


def dense_agg_plain(gidx, mask, values, valids, num_groups: int):
    """The plain PyTorch version: the masked segment sums and counts of
    ops/segment.py, one per state, stacked."""
    G = num_groups
    rows = [ops.masked_segment_count(gidx, mask, G)]
    for v, ok in zip(values, valids):
        mv = mask & ok
        rows.append(torch.zeros(G, dtype=torch.int64, device=mask.device)
                    if v is None else ops.masked_segment_sum(v, gidx, mv, G))
        rows.append(ops.masked_segment_count(gidx, mv, G))
    return torch.stack(rows)


def _check(gidx, mask, values, valids, G: int):
    def vec(t, what, dtype):
        if t.dtype != dtype:
            raise TypeError(f"dense_agg: {what} must be {dtype}, "
                            f"got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"dense_agg: {what} must be [{n}], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"dense_agg: {what} must be contiguous")
        if t.device != mask.device:
            raise ValueError(f"dense_agg: {what} on {t.device}, mask on "
                             f"{mask.device}")

    if mask.dim() != 1:
        raise ValueError(f"dense_agg: mask must be one-dimensional, got "
                         f"{tuple(mask.shape)}")
    n = mask.shape[0]
    vec(mask, "mask", torch.bool)
    vec(gidx, "gidx", torch.int64)
    if not 1 <= G <= MAX_G:
        raise ValueError(f"dense_agg: num_groups must be 1..{MAX_G}, "
                         f"got {G}")
    if len(values) != len(valids) or len(valids) > MAX_K:
        raise ValueError(f"dense_agg: {len(values)} values and "
                         f"{len(valids)} validities; at most {MAX_K} "
                         "operands, one validity each")
    for k, (v, ok) in enumerate(zip(values, valids)):
        vec(ok, f"valids[{k}]", torch.bool)
        if v is not None:
            vec(v, f"values[{k}]", torch.int64)
    if mask.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dense_agg: unsupported device {mask.device}")


def _lib():
    lib = load("dense_agg")
    fn = lib.tidb_dense_agg
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def dense_agg(gidx, mask, values, valids, num_groups: int):
    """Every integer partial state of a dense aggregation in one pass:
    a [1 + 2K, num_groups] int64 tensor on the mask's device (row 0 the
    group counts, rows 1 + 2k and 2 + 2k operand k's sum and count)."""
    _check(gidx, mask, values, valids, num_groups)
    if mask.device.type == "cpu":
        return dense_agg_plain(gidx, mask, values, valids, num_groups)
    fn = _lib()
    K, n = len(valids), mask.shape[0]
    out = torch.zeros((1 + 2 * K, num_groups), dtype=torch.int64,
                      device=mask.device)
    vals = (ctypes.c_void_p * K)(
        *[None if v is None else v.data_ptr() for v in values])
    oks = (ctypes.c_void_p * K)(*[ok.data_ptr() for ok in valids])
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        rc = fn(gidx.data_ptr(), mask.data_ptr(), vals, oks, K, num_groups,
                n, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dense_agg: CUDA launch failed (error {rc})")
    if n > 0:
        dense_agg.launches += 1
    return out


dense_agg.launches = 0

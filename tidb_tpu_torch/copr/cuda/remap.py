"""K1, the computed group key's code-space gather, as a hand-written
CUDA kernel.

``remap_codes(codes, mapping, n)`` regathers dictionary codes through a
runtime mapping: ``out[i] = mapping[clip(codes[i], 0, cap - 1)]`` with
``cap = len(mapping)``.  The mapping is int32 (output-dictionary codes of
a STRING key) or int64 (the values of a LENGTH/ASCII key); the output has
the mapping's dtype.  It replaces the TPU kernel ``remap_codes`` of
tidb_tpu/copr/pallas/kernels.py; the CUDA source is
``csrc/remap_codes.cu``.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it takes ``remap_codes_plain``, the same arithmetic as torch ops.
``remap_codes.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

#: code dtypes the kernel reads as they are (its template instances)
CODE_KINDS = {torch.uint8: 0, torch.int8: 1, torch.int16: 2,
              torch.int32: 3, torch.int64: 4}
#: mapping dtypes, by element size
MAP_KINDS = {torch.int32: 4, torch.int64: 8}


def remap_codes_plain(codes: torch.Tensor, mapping: torch.Tensor, n: int):
    """The plain PyTorch version: clamp the widened codes, then index."""
    cap = mapping.shape[0]
    return mapping[codes.reshape(n).to(torch.int64).clamp(0, cap - 1)]


def _check(codes: torch.Tensor, mapping: torch.Tensor, n: int):
    if codes.dtype not in CODE_KINDS:
        raise TypeError(f"remap_codes: codes must be one of "
                        f"{sorted(map(str, CODE_KINDS))}, got {codes.dtype}")
    if mapping.dtype not in MAP_KINDS:
        raise TypeError(f"remap_codes: mapping must be int32 or int64, "
                        f"got {mapping.dtype}")
    cap = mapping.shape[0] if mapping.dim() == 1 else 0
    if cap < 2 or cap & (cap - 1):
        raise ValueError(f"remap_codes: mapping must be one-dimensional "
                         f"with a power-of-two length >= 2, got "
                         f"{tuple(mapping.shape)}")
    if codes.numel() != n:
        raise ValueError(f"remap_codes: {codes.numel()} codes, not {n}")
    if not (codes.is_contiguous() and mapping.is_contiguous()):
        raise ValueError("remap_codes: codes and mapping must be contiguous")
    if codes.device != mapping.device:
        raise ValueError(f"remap_codes: codes on {codes.device}, mapping "
                         f"on {mapping.device}")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"remap_codes: unsupported device {codes.device}")


def _lib():
    lib = load("remap_codes")
    fn = lib.tidb_remap_codes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def remap_codes(codes: torch.Tensor, mapping: torch.Tensor, n: int):
    """``mapping[clip(codes, 0, cap - 1)]`` for `n` codes; returns a
    tensor of `n` values of mapping's dtype on the codes' device."""
    _check(codes, mapping, n)
    c = codes.reshape(n)
    if c.device.type == "cpu":
        return remap_codes_plain(c, mapping, n)
    fn = _lib()
    out = torch.empty(n, dtype=mapping.dtype, device=c.device)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream(c.device).cuda_stream
        rc = fn(c.data_ptr(), mapping.data_ptr(), out.data_ptr(), n,
                mapping.shape[0], CODE_KINDS[c.dtype],
                MAP_KINDS[mapping.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"remap_codes: CUDA launch failed (error {rc})")
    if n > 0:
        remap_codes.launches += 1
    return out


remap_codes.launches = 0

"""K2, the cold tier's bit-unpack and range decode, as a hand-written
CUDA kernel.

``unpack_codes(packed, bits, n)`` turns bit-packed little-endian codes
(the layout of ``layout.coldtier.pack_codes``) back into one uint8 code
per row: ``code[j] = (packed[j // vpb] >> ((j % vpb) * bits)) & mask``
with ``vpb = 8 // bits``.  ``unpack_codes(packed, bits, n, bias=b)``
also decodes a `range` dictionary in the same pass:
``code.to(b.dtype) + b``, with `b` a 0-d int32 or int64 tensor on
packed's device (read by the kernel through its pointer: no host sync).
It replaces the TPU kernel ``unpack_codes`` of
tidb_tpu/copr/pallas/kernels.py and the range branch of the decode
that follows it; the CUDA source is ``csrc/unpack_codes.cu``.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it takes ``unpack_codes_plain``, the same arithmetic as torch
ops.  ``bits == 8`` without a bias is the identity and launches
nothing; with a bias it launches the kernel (widen and add in one
pass).  ``unpack_codes.launches`` counts kernel launches of both forms.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load

#: bias dtypes the kernel takes (the output has the bias's dtype)
BIAS_DTYPES = (torch.int32, torch.int64)


def unpack_codes_plain(packed: torch.Tensor, bits: int, n: int,
                       bias: torch.Tensor | None = None):
    """The plain PyTorch version: broadcast shift, mask and reshape;
    with a bias, then the widening and the add."""
    vpb = 8 // bits
    code = packed.reshape(-1)
    if vpb > 1:
        shifts = torch.arange(vpb, dtype=torch.uint8,
                              device=code.device) * bits
        code = ((code[:, None] >> shifts[None, :])
                & ((1 << bits) - 1)).reshape(n)
    if bias is None:
        return code
    return code.to(bias.dtype) + bias


def _check(packed: torch.Tensor, bits: int, n: int, bias):
    if bits not in (1, 2, 4, 8):
        raise ValueError(f"unpack_codes: bits must be 1, 2, 4 or 8, "
                         f"got {bits}")
    if packed.dtype != torch.uint8:
        raise TypeError(f"unpack_codes: packed must be uint8, "
                        f"got {packed.dtype}")
    if not packed.is_contiguous():
        raise ValueError("unpack_codes: packed must be contiguous")
    if packed.numel() * (8 // bits) != n:
        raise ValueError(
            f"unpack_codes: {packed.numel()} packed bytes at {bits} bits "
            f"hold {packed.numel() * (8 // bits)} rows, not {n}")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unpack_codes: unsupported device "
                         f"{packed.device}")
    if bias is None:
        return
    if bias.dtype not in BIAS_DTYPES:
        raise TypeError(f"unpack_codes: bias must be int32 or int64, "
                        f"got {bias.dtype}")
    if bias.dim() != 0:
        raise ValueError(f"unpack_codes: bias must be 0-d, got shape "
                         f"{tuple(bias.shape)}")
    if bias.device != packed.device:
        raise ValueError(f"unpack_codes: bias on {bias.device}, packed "
                         f"on {packed.device}")


def _lib():
    lib = load("unpack_codes")
    fn = lib.tidb_unpack_codes
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def unpack_codes(packed: torch.Tensor, bits: int, n: int,
                 bias: torch.Tensor | None = None):
    """Unpack `n` codes of `bits` bits from `packed` (uint8, n*bits/8
    bytes); returns `n` uint8 codes on packed's device, or with `bias`
    `n` values ``code + bias`` of bias's dtype."""
    _check(packed, bits, n, bias)
    p = packed.reshape(-1)
    if bits == 8 and bias is None:
        return p
    if p.device.type == "cpu":
        return unpack_codes_plain(p, bits, n, bias)
    fn = _lib()
    out = torch.empty(n, dtype=torch.uint8 if bias is None else bias.dtype,
                      device=p.device)
    # the kernel writes 16-byte vectors; the caching allocator's blocks
    # are aligned far beyond that
    if out.data_ptr() % 16:
        raise RuntimeError("unpack_codes: output not 16-byte aligned")
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        rc = fn(p.data_ptr(), out.data_ptr(),
                None if bias is None else bias.data_ptr(), n, bits,
                out.element_size(), stream)
    if rc != 0:
        raise RuntimeError(f"unpack_codes: CUDA launch failed (error {rc})")
    if n > 0:
        unpack_codes.launches += 1
    return out


unpack_codes.launches = 0

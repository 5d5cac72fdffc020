"""Compressed device-resident cold tier.

Cold columns stay ON DEVICE, but as compressed blocks: bit-packed
dictionary codes (1/2/4/8 bits per row) instead of full wire arrays.
The dictionary-value vector is a small device operand of the fused
program and the codes unpack on the card with the hand-written CUDA
kernel (`copr/fusion.decode_packed` -> `copr/cuda.unpack_codes`), inside
the query's one `copr.device.execute` — no host->device transfer.  An 8x-64x
smaller footprint is what lets tables larger than the hot-tier byte cap
stay queryable without full-table host reloads.

Two dictionary kinds:

- **range** (ints / dates / store-dict string codes): the value range
  [lo, hi] is itself the dictionary (`arange(lo, hi+1)`) — no probe
  pass, codes are `value - lo`;
- **unique** (floats): a one-time `np.unique` probe per base version
  builds the value dictionary; NDV above 256 means the column is not
  packable and stays hot.

NULL-able columns stay hot (the packed form carries no validity plane).

Chaos site `layout/decompress` fires on every cold-tier access: an armed
action forces the loader down the hot path, and the parity sweep asserts
identical results either way.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..copr.cache import ByteCapCache
from ..types import TypeKind
from ..util_concurrency import make_lock

#: chaos site: armed actions fail the cold access; the loader falls back
#: to the hot tier (parity-preserving, metric-counted)
DECOMPRESS_FAILPOINT = "layout/decompress"

#: widest packed code (one byte); NDV / value ranges above 2**MAX_BITS
#: are not cold-packable
MAX_BITS = 8


def _cold_cap_bytes() -> int:
    return int(os.environ.get("TIDB_TPU_COLD_BYTES", str(2 << 30)))


#: the cold tier itself: byte-capped like the hot mesh cache, FIFO within
#: the tier (cold entries are already the demotion target; past the cold
#: cap the oldest compressed column drops and reloads on demand)
COLD_CACHE = ByteCapCache(_cold_cap_bytes(), name="cold")


@dataclass(frozen=True)
class PackInfo:
    """A column's compression class (fingerprint-relevant parts: bits +
    cap; lo and the dictionary VALUES ride runtime operands)."""

    bits: int        # packed code width (1/2/4/8)
    cap: int         # pow2 dictionary capacity (len(dict_vals))
    kind: str        # 'range' | 'unique'
    lo: int = 0      # range-kind bias


class ColdColumn:
    """One cold-resident column: sharded packed codes + decode operand.

    `packed` holds shard s's [Tl, TILE*bits/8] code bytes on position s's
    device (an `ops.Shards`), so K2 decodes each shard where it lives.
    `operand` is the DEVICE-RESIDENT runtime dispatch argument (it never
    enters the compiled fingerprint), on every position: the scalar bias
    for 'range' dictionaries (decode = code + lo), the value vector for
    'unique' ones.  Built ONCE at compress time — a
    steady-state cold hit ships nothing over the link, not even the
    dictionary.  `nbytes` makes the object directly cacheable by
    ByteCapCache."""

    __slots__ = ("packed", "operand", "dict_vals", "bits", "cap", "kind",
                 "lo")

    def __init__(self, packed, operand, dict_vals: np.ndarray, bits: int,
                 cap: int, kind: str = "unique", lo: int = 0):
        self.packed = packed
        self.operand = operand
        self.dict_vals = dict_vals
        self.bits = bits
        self.cap = cap
        self.kind = kind
        self.lo = lo

    @property
    def nbytes(self) -> int:
        return (int(self.packed.nbytes) + int(self.dict_vals.nbytes)
                + int(self.operand.nbytes))


_mu = make_lock("layout.coldtier:_mu")
#: (store_uid, base_version, store_ci) -> (Optional[PackInfo],
#: Optional[unique-values vector]).  info=None means probed and not
#: packable; the uniq vector is kept for 'unique' kinds so the probe's
#: O(n) pass is paid ONCE per base version — dict_values and the
#: compress path reuse it instead of rescanning
_PACK_INFO: Dict[Tuple[int, int, int], tuple] = {}


def _pow2cap(n: int) -> int:
    c = 2
    while c < n:
        c <<= 1
    return c


def _bits_for(card: int) -> Optional[int]:
    for b in (1, 2, 4, 8):
        if card <= (1 << b):
            return b
    return None


def pack_info(table, store_ci: int) -> Optional[PackInfo]:
    """The column's compression class, or None when not packable
    (NULL-able, wide range, high-NDV).  Cached per base version."""
    return _pack_entry(table, store_ci)[0]


def _pack_entry(table, store_ci: int) -> tuple:
    key = (table.store_uid, table.base_version, store_ci)
    with _mu:
        if key in _PACK_INFO:
            return _PACK_INFO[key]
        # drop probes of superseded versions for this store (bounded)
        for k in [k for k in _PACK_INFO
                  if k[0] == key[0] and k[1] != key[1]]:
            del _PACK_INFO[k]
    entry = _probe(table, store_ci)
    with _mu:
        _PACK_INFO[key] = entry
    return entry


def _probe(table, store_ci: int) -> tuple:
    """(PackInfo | None, unique-values | None) — the probe's one O(n)
    pass yields BOTH the class and the value dictionary."""
    meta = table.cols[store_ci]
    try:
        lo, hi, has_null = table.column_stats(store_ci)
    except Exception:
        return None, None  # host-only payloads (e.g. JSON) never pack
    if has_null or table.base_rows == 0 or hi < lo:
        return None, None
    kind = meta.ftype.kind
    if kind != TypeKind.FLOAT:
        # ints / dates / store-dict string codes: a narrow range IS the
        # dictionary (decode = code + lo, no value table)
        card = hi - lo + 1
        bits = _bits_for(card)
        if bits is not None:
            return PackInfo(bits=bits, cap=_pow2cap(card), kind="range",
                            lo=lo), None
    # wide-range-but-low-NDV columns (floats, scaled decimals like a
    # price ladder): one unique probe per base version.  The union bails
    # after every block, so high-NDV columns pay one 64K-row np.unique,
    # not a full scan.
    uniq = None
    for _off, arrs, _vals in table.iter_base_blocks(
            [store_ci], 0, table.base_rows):
        u = np.unique(arrs[0])
        uniq = u if uniq is None else np.union1d(uniq, u)
        if len(uniq) > (1 << MAX_BITS):
            return None, None
    card = max(len(uniq) if uniq is not None else 0, 1)
    bits = _bits_for(card)
    if bits is None:
        return None, None
    return PackInfo(bits=bits, cap=_pow2cap(card), kind="unique"), uniq


def dict_values(table, store_ci: int, info: PackInfo) -> np.ndarray:
    """The dictionary-value runtime operand, padded to the pow2 cap in
    the column's canonical device dtype (`parallel._full_dtype`)."""
    from ..copr.parallel import _full_dtype

    dt = _full_dtype(table.cols[store_ci].ftype.kind)
    if info.kind == "range":
        # cap <= 2**bits always, so the range covers every slot
        return np.arange(info.lo, info.lo + info.cap,
                         dtype=np.int64).astype(dt)
    # the probe already paid the unique pass; reuse its vector
    uniq = _pack_entry(table, store_ci)[1]
    uniq = uniq if uniq is not None else np.zeros(0, dtype=dt)
    out = np.zeros(info.cap, dtype=dt)
    out[: len(uniq)] = uniq[: info.cap].astype(dt)
    if len(uniq):
        out[len(uniq):] = out[min(len(uniq), info.cap) - 1]
    return out


def pack_codes(codes: np.ndarray, bits: int) -> np.ndarray:
    """Bit-pack uint8 codes (< 2**bits) little-endian within each byte:
    row j lives in byte j // (8//bits) at shift (j % (8//bits)) * bits."""
    vpb = 8 // bits
    if vpb == 1:
        return codes.astype(np.uint8, copy=False)
    c = codes.astype(np.uint16).reshape(-1, vpb)
    shifts = (np.arange(vpb, dtype=np.uint16) * bits)
    return np.bitwise_or.reduce(c << shifts, axis=1).astype(np.uint8)


def compress_column(table, store_ci: int, mesh, n_pad: int,
                    info: Optional[PackInfo] = None) -> ColdColumn:
    """Host-side compress + one packed transfer a shard onto the mesh:
    the cold-tier load.  Raises ValueError when the column is not
    packable (callers fall back to the hot tier)."""
    from .. import ops
    from ..copr import torch_engine as te
    from ..copr.parallel import _full_dtype, on_card, place_shards, torch_dtype

    if info is None:
        info = pack_info(table, store_ci)
    if info is None:
        raise ValueError(f"column {store_ci} is not cold-packable")
    tile = te.TILE
    vpb = 8 // info.bits
    dt = _full_dtype(table.cols[store_ci].ftype.kind)
    if info.kind == "unique":
        packed_vals = dict_values(table, store_ci, info)
    else:
        # range decode uses only the scalar bias; no value table exists
        packed_vals = np.zeros(0, dtype=dt)
    flat = np.zeros(n_pad * tile, dtype=np.uint8)
    off = 0
    for _s, arrs, _vals in table.iter_base_blocks(
            [store_ci], 0, table.base_rows):
        blk = arrs[0]
        n = len(blk)
        if info.kind == "range":
            codes = np.clip(blk.astype(np.int64) - info.lo, 0,
                            info.cap - 1)
        else:
            # packed_vals is in the column's canonical dtype; duplicate
            # pad slots at the tail never shadow a leftmost match
            codes = np.clip(
                np.searchsorted(packed_vals,
                                blk.astype(packed_vals.dtype)), 0,
                info.cap - 1)
        flat[off:off + n] = codes
        off += n
    packed = pack_codes(flat, info.bits).reshape(n_pad, tile // vpb)
    from ..trace import span

    with span("copr.transfer", col=store_ci, tier="cold",
              bits=info.bits) as sp:
        sp.set(bytes=packed.nbytes + max(packed_vals.nbytes, dt.itemsize))
        host = torch.from_numpy(packed)
        if on_card(mesh):
            host = host.pin_memory()
        packed_dev = place_shards(host, mesh, n_pad // mesh.size)
        if info.kind == "range":
            operand = torch.tensor(info.lo, dtype=torch_dtype(dt))
        else:
            operand = torch.from_numpy(packed_vals)
        operand = ops.on_positions(operand, mesh.devices)
    return ColdColumn(packed_dev, operand, packed_vals, info.bits,
                      info.cap, kind=info.kind, lo=info.lo)


def _demote_encoder(kind: str, bits: int, cap: int, lo: int,
                    base_rows: int):
    """The on-card re-encoder of one column class: one shard's wire
    values (first global row `row0`) -> bit-packed codes, byte-for-byte
    the layout `compress_column` builds on the host (pad rows beyond
    base_rows pack to 0)."""
    vpb = 8 // bits

    def encode(d, dvec=None, row0: int = 0):
        flat = d.reshape(-1)
        if dvec is None:
            codes = torch.clamp(flat.to(torch.int64) - lo, 0, cap - 1)
        else:
            codes = torch.clamp(
                torch.searchsorted(dvec, flat.to(dvec.dtype)), 0, cap - 1)
        gofs = torch.arange(row0, row0 + flat.shape[0], dtype=torch.int64,
                            device=flat.device)
        codes = torch.where(gofs < base_rows, codes,
                            torch.zeros_like(codes)).to(torch.uint8)
        if vpb == 1:
            return codes
        c = codes.reshape(-1, vpb)
        out = torch.zeros(c.shape[0], dtype=torch.uint8, device=c.device)
        for s in range(vpb):
            out |= c[:, s] << (s * bits)
        return out

    return encode


def recompress_from_device(table, store_ci: int, n_pad: int,
                           info: Optional[PackInfo],
                           hot_value) -> ColdColumn:
    """Demote a hot column to the cold tier by re-encoding ON THE CARD
    from the evicted wire tensors: each shard's codes compute and
    bit-pack over its already-resident data and stay on its position
    (the layout is the same, so nothing re-shards, nothing reads back
    and no host block is touched).

    Raises when the column is not packable or the hot value is
    unusable."""
    from .. import ops
    from ..copr import torch_engine as te
    from ..copr.parallel import _full_dtype, torch_dtype

    if info is None:
        info = pack_info(table, store_ci)
    if info is None:
        raise ValueError(f"column {store_ci} is not cold-packable")
    shards = hot_value[0]  # the evicted [Tl, TILE] wire tensor a shard
    tile = te.TILE
    vpb = 8 // info.bits
    Tl = n_pad // len(shards)
    dt = _full_dtype(table.cols[store_ci].ftype.kind)
    devices = [None if d is None else d.device for d in shards]
    if info.kind == "unique":
        packed_vals = dict_values(table, store_ci, info)
        operand = ops.on_positions(torch.from_numpy(packed_vals), devices)
    else:
        packed_vals = np.zeros(0, dtype=dt)
        operand = ops.on_positions(
            torch.tensor(info.lo, dtype=torch_dtype(dt)), devices)
    encode = _demote_encoder(info.kind, info.bits, info.cap, info.lo,
                             table.base_rows)
    from ..trace import span

    with span("copr.transfer", col=store_ci, tier="cold-demote",
              bits=info.bits) as sp:
        packed = ops.Shards(
            None if d is None else
            encode(d, operand[s] if info.kind == "unique" else None,
                   row0=s * Tl * tile).reshape(Tl, tile // vpb)
            for s, d in enumerate(shards))
        sp.set(bytes=0)
    return ColdColumn(packed, operand, packed_vals, info.bits, info.cap,
                      kind=info.kind, lo=info.lo)


def evict_device(device_id: int) -> int:
    """Device failover: drop cold entries placed on a mesh holding this
    position (key layout mirrors the mesh cache — position ids at index
    3)."""
    return COLD_CACHE.evict_if(lambda k: device_id in k[3])


def clear():
    COLD_CACHE.clear()

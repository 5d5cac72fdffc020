"""Whole-table coprocessor scans over the device mesh: one fused pass
a shard, merged across shards.

The reference implements a distributed scan fan-out + partial/final
merge (store/tikv/coprocessor.go:220-560 buildCopTasks/worker pool;
executor/aggregate.go:101-169 the partial/final agg split).  Here, as in
the JAX package's shard_map program:

- The mesh is a list of S positions (`ops.mesh_devices`: one per card
  by default, or S on one device); `get_mesh` keeps the positions whose
  breakers admit work and rebuilds when that set changes.
- A table's base tiles form [n_pad, TILE] per column (pow2-padded tile
  count, a multiple of S), shard s holding tiles [s*Tl, (s+1)*Tl) on
  its position's device, cached by `_MeshCache` at the narrowest integer
  width that holds the column.
- The whole scan is the same sequence of torch ops on every shard
  (`_build_mesh_core`): widen, mask, filter and partially aggregate its
  rows.  Sums and counts merge in shard order on position 0's device
  (`ops.psum`); min/max and first-row come back as per-shard partials
  the host merges, as the reference does; so a steady-state aggregation
  moves only G-sized results to the host.  Shards are issued one after
  another and their results (group counts, TopN counts, masks) are read
  once every shard was issued; what a shard's own ops read back
  (`bincount`'s and `nonzero`'s sizes) still syncs inside it.
- Aggregation over arbitrary keys (high NDV, float, NULLable or
  computed keys) groups by sorting (`_build_sort_agg_core`) into a
  static budget of OUT groups per shard and dispatch; every shard's
  partial chunk goes to the root merge (no collective); a blown budget
  re-runs the fragment with the aggregation peeled to a host tail
  (`_peel_agg_rerun`).
- TopN: a masked top-k per shard and dispatch; the host gathers every
  shard's candidate rows and picks the final ones (`run_topn`).
- Filter: the fused mask is computed per shard and only the selected
  global row handles come back; the host gathers those rows.
- Joins (`_apply_probes`): a runtime join filter (JoinProbeIR) ANDs a
  sorted-key membership test into the row mask, and a broadcast lookup
  join (JoinLookupIR) drops misses and gathers the matched build row's
  payload columns, inside the same program as the scan and the partial
  aggregation.  The build keys and payloads move to every position once
  per query (`_join_operands`).
- Failover (`try_run_mesh`): a device failure trips the implicated
  positions' breakers, evicts what they hold and re-runs over the
  rebuilt mesh of survivors; a half-open probe restores the full mesh.

The mesh keeps its name on the SQL surface (`engine:mesh` in EXPLAIN
ANALYZE) so both packages report the same route.

Across processes (`_maybe_init_multihost`: TIDB_TPU_COORDINATOR joins a
torch.distributed group) the mesh spans every process's positions and
every process runs the same statements over the same data (SPMD).  A
process places and runs only its own shards (a shard keeps its global
first row); every shard's results are gathered to every process
(`ops.gather_shards`), so each computes the same merged rows and takes
the same rung decisions.  What chooses the collectives that follow (the
mesh and its epoch, the chunk budget, each column's tier) is process
0's decision (`ops.agree`); columns load in one fixed order and nothing
prefetches in the background.
"""

from __future__ import annotations

import json
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import ops
from ..chunk import Chunk, Column
from ..errors import DeviceUnavailableError
from ..store.fault import FAILPOINTS
from ..store.kv import CopRequest
from ..types import TypeKind
from ..util_concurrency import make_lock
from .device_health import DEVICE_HEALTH, attribute_devices, classify_failure
from .ir import DAG, serialize_expr
from .torch_eval import DeviceUnsupported
from . import torch_engine as te
from .torch_engine import _Analyzed, _fingerprint
from ..ops.collective import first_local

# ONE fused program in flight per process: concurrent statements take
# turns on the card (resource-group admission rides this lock)
DISPATCH_LOCK = make_lock("copr.parallel:DISPATCH_LOCK")

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype of a numpy dtype the engine stores."""
    return _NP_TO_TORCH[np.dtype(dt)]


def to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Copy a host array to `dev` (through pinned memory for a card)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type == "cuda":
        return t.pin_memory().to(dev)
    return t.to(dev)


class _Card:
    """A mesh position id in the shape the health registry selects
    over."""

    __slots__ = ("id",)

    def __init__(self, did: int):
        self.id = did


# ---------------------------------------------------------------------------
# the mesh: positions, health filter, membership epoch
# ---------------------------------------------------------------------------


class Mesh:
    """The positions one program runs over, in shard order: shard s runs
    on `devices[s]` (position `ids[s]`).  Several positions may share a
    device (`ops.use_device(dev, shards=S)`).  Across processes a
    position of another process has device None; `local` lists the
    shards this process runs and `owners[s]` the process holding shard
    s."""

    __slots__ = ("positions", "ids", "devices", "size", "where", "local",
                 "owners")

    def __init__(self, positions):
        self.positions = tuple(positions)
        self.ids = tuple(pid for pid, _ in self.positions)
        self.devices = tuple(d for _, d in self.positions)
        self.size = len(self.positions)
        self.local = tuple(s for s, d in enumerate(self.devices)
                           if d is not None)
        self.owners = tuple(ops.position_owner(pid) for pid in self.ids)
        # the devices behind the ids: a cache or program keyed on ids
        # alone could serve a tensor of another device set
        self.where = ",".join(str(d) for d in self.devices)

    def local_devices(self):
        """The devices of this process's shards."""
        return [d for d in self.devices if d is not None]


_MESH: Optional[Mesh] = None
#: membership epoch the current _MESH was derived from (coord plane):
#: stamped under _MESH_LOCK by get_mesh, compared at every dispatch
_MESH_EPOCH: Optional[int] = None
_MESH_LOCK = make_lock("copr.parallel:_MESH_LOCK")


_DIST_INIT = False


def dist_backend(dev: torch.device) -> str:
    """The process group's backend: TIDB_TPU_DIST_BACKEND when set, else
    ``nccl`` when each process owns its own card and ``gloo`` on the
    host or when processes share a card (NCCL refuses two ranks on one
    device).  Chosen once, before the group forms; nothing switches it
    after an error."""
    import os

    forced = os.environ.get("TIDB_TPU_DIST_BACKEND")
    if forced:
        return forced
    if dev.type != "cuda" or (ops._SHARDS or 1) > 1:
        return "gloo"
    # one position on card `rank`: the layout of one process a card
    rank = int(os.environ.get("TIDB_TPU_PROCESS_ID", "0"))
    return "nccl" if dev.index == rank \
        and torch.cuda.device_count() > rank else "gloo"


def _maybe_init_multihost():
    """Multi-process bring-up seam: when TIDB_TPU_COORDINATOR=host:port
    is set, join the torch.distributed group (TIDB_TPU_NUM_PROCESSES,
    TIDB_TPU_PROCESS_ID; backend from `dist_backend`, collective timeout
    TIDB_TPU_DIST_TIMEOUT_S) before the mesh is built, so the mesh spans
    every process's positions.  With TIDB_TPU_COORD_ADDR also set the
    same processes form the coordination plane: process 0 binds, every
    process registers its global position ids and all block until the
    cluster forms.  Latched only on success (a raise retries on the next
    call); a failed join raises `CollectiveError`, never runs the
    process alone."""
    global _DIST_INIT
    if _DIST_INIT:
        return
    import datetime
    import os

    coord = os.environ.get("TIDB_TPU_COORDINATOR")
    if not coord:
        return
    import torch.distributed as dist

    from ..errors import CollectiveError

    world = int(os.environ.get("TIDB_TPU_NUM_PROCESSES", "1"))
    rank = int(os.environ.get("TIDB_TPU_PROCESS_ID", "0"))
    dev = ops.device()
    backend = dist_backend(dev)
    if not dist.is_initialized():
        if backend == "nccl":
            torch.cuda.set_device(dev)
        try:
            dist.init_process_group(
                backend=backend, init_method=f"tcp://{coord}",
                world_size=world, rank=rank,
                timeout=datetime.timedelta(seconds=float(os.environ.get(
                    "TIDB_TPU_DIST_TIMEOUT_S", "120"))))
        except Exception as e:  # noqa: BLE001 - the store's own types
            raise CollectiveError(
                f"process {rank} of {world} could not join the process "
                f"group at {coord} ({backend}): {type(e).__name__}: "
                f"{e}") from e
    counts = ops.agree(len(ops.local_positions()), op="positions")
    if counts != len(ops.local_positions()):
        raise RuntimeError(
            f"process {rank} places {len(ops.local_positions())} mesh "
            f"positions, process 0 places {counts}: every process must "
            "place the same number")
    _DIST_INIT = True
    addr = os.environ.get("TIDB_TPU_COORD_ADDR")
    if addr:
        from ..coord import activate_env_plane

        activate_env_plane(addr, pid=rank, devices=list(ops.device_ids()),
                           expect=world)


def _eligible_devices():
    """(mesh-eligible positions, membership epoch they derive from).

    One process: every position minus tripped breakers (plus half-open
    probe admissions), published to the coordination plane so /status
    membership stays truthful; an all-tripped set returns every
    position (callers gate on `_check_breaker` first).  Several
    processes: the plane's epoch-numbered membership broadcast, so a
    breaker trip on any process shrinks every process's mesh; before
    the cluster has formed, every position, identically everywhere."""
    from ..coord import get_plane

    plane = get_plane()
    positions = ops.mesh_devices()
    if ops.process_count() > 1:
        # drive the LOCAL breakers even though the broadcast filters:
        # select_devices moves TRIPPED -> PROBING once a cooldown lapses,
        # and that transition reports through the epoch hook, so a
        # probe-eligible position rejoins every process's mesh
        DEVICE_HEALTH.select_devices(
            [_Card(pid) for pid in ops.device_ids()])
        view = plane.view()
        if view.formed and view.members:
            allowed = view.device_ids()
            sel = [p for p in positions if p[0] in allowed]
            if sel:
                return sel, view.epoch
        return positions, view.epoch
    healthy = {c.id for c in DEVICE_HEALTH.select_devices(
        [_Card(pid) for pid, _ in positions])}
    chosen = [p for p in positions if p[0] in healthy] or positions
    plane.publish_local(tuple(pid for pid, _ in chosen))
    return chosen, plane.current_epoch()


def get_mesh() -> Mesh:
    """The process-wide mesh over every eligible position.  It REBUILDS
    whenever the eligible set changes: a tripped breaker shrinks it to
    the survivors, a successful half-open probe restores it (counted on
    `mesh_rebuilds_total`, chaos site `mesh/rebuild`)."""
    global _MESH, _MESH_EPOCH
    _maybe_init_multihost()
    # check-and-rebuild and the eligibility snapshot under one lock: a
    # racing thread holding a pre-trip snapshot must not reinstate a
    # mesh that holds the just-quarantined position
    with _MESH_LOCK:
        positions, epoch = _eligible_devices()
        if ops.process_count() > 1:
            # every process builds process 0's mesh: a broadcast that
            # reached one process first must not split the layout
            ids, epoch = ops.agree(
                (tuple(pid for pid, _ in positions), epoch), op="mesh")
            positions = [p for p in ops.mesh_devices() if p[0] in ids]
        if _MESH is None or _MESH.positions != tuple(positions):
            if _MESH is not None:
                from ..metrics import REGISTRY

                REGISTRY.inc("mesh_rebuilds_total")
            FAILPOINTS.hit("mesh/rebuild",
                           device_ids=tuple(p for p, _ in positions))
            _MESH = Mesh(positions)
        # restamp even when the set is unchanged: an epoch bump without
        # a visible change must not leave a stale stamp behind
        _MESH_EPOCH = epoch
        return _MESH


def mesh_epoch() -> Optional[int]:
    """Membership epoch the current mesh was built from."""
    return _MESH_EPOCH


def _check_membership_epoch():
    """Dispatch-time epoch guard: the chaos site `coord/member_lost`
    lands a membership change exactly here, and a change between mesh
    build and dispatch is detected the same way.  Raises the typed
    retriable CoordEpochMismatch; the caller rebuilds the mesh from the
    new broadcast and re-runs."""
    from ..coord import CoordEpochMismatch, get_plane

    FAILPOINTS.hit("coord/member_lost", epoch=_MESH_EPOCH)
    # across processes the comparison is process 0's, so every process
    # raises (and retries) together
    ep = ops.agree(get_plane().current_epoch(), op="epoch")
    if _MESH_EPOCH is not None and ep != _MESH_EPOCH:
        from ..metrics import REGISTRY

        REGISTRY.inc("coord_epoch_mismatch_total")
        raise CoordEpochMismatch(_MESH_EPOCH, ep)


def _check_breaker():
    """Raise while every position's breaker is open with no probe due.
    Failing cards fail their statements (typed, retriable once the
    cooldown admits a probe) instead of handing them to the host
    engine.  Across processes the membership broadcast filters instead
    (`_eligible_devices`), as the JAX package's gate does."""
    if ops.process_count() > 1:
        return
    if not DEVICE_HEALTH.select_devices(
            [_Card(d) for d in ops.device_ids()]):
        raise DeviceUnavailableError(
            f"every mesh position on {ops.device()} is failing: each "
            "one's breaker is open until the cooldown admits a probe")


def local_bounds(bounds, s: int, n_local: int):
    """The global range bounds clipped to shard s's rows [s*n_local,
    (s+1)*n_local), in the shard's own row coordinates (empty when the
    bounds miss the shard)."""
    r0, r1 = s * n_local, (s + 1) * n_local
    return [(max(a, r0) - r0, min(b, r1) - r0) for a, b in bounds
            if a < r1 and b > r0]


def to_positions(arr: np.ndarray, mesh: Mesh) -> ops.Shards:
    """A host operand on every position (one copy per distinct
    device)."""
    return ops.on_positions(torch.from_numpy(np.ascontiguousarray(arr)),
                            mesh.devices)


def place_shards(host: torch.Tensor, mesh: Mesh, Tl: int) -> ops.Shards:
    """Rows [s*Tl, (s+1)*Tl) of a [n_pad, ...] host tensor (pinned when
    it goes to a card) on position s: the sharded layout of every
    column, mask and packed code array.  Only this process's shards are
    placed (None at the others)."""
    return ops.Shards(None if d is None else host[s * Tl:(s + 1) * Tl].to(d)
                      for s, d in enumerate(mesh.devices))


def on_card(mesh: Mesh) -> bool:
    """True when any of this process's shards lives on a card."""
    return any(d.type == "cuda" for d in mesh.local_devices())


def _layout(base_rows: int, n_shards: int = 1, table=None
            ) -> Tuple[int, int, int]:
    """(n_tiles, n_tiles_padded, tiles_per_shard) for a table.

    With shape buckets on (tidb_tpu_shape_buckets, the default) the tile
    count pads UP to the next power of two, the JAX package's layout:
    padded tiles are zeros and always masked, so results are identical,
    and the cold tier's packing relies on the same n_pad.  The layout
    autotuner can flip a table's tiling to EXACT (`table` given + the
    tuner's tile-bucket decision): under memory pressure the pow2
    padding is wasted capacity."""
    from ..serving import shape_bucket, shape_buckets_enabled

    tile = te.TILE
    n_tiles = max((base_rows + tile - 1) // tile, 1)
    if shape_buckets_enabled() and _tile_bucket(table) == "pow2":
        n_tiles = shape_bucket(n_tiles)
    n_pad = ((n_tiles + n_shards - 1) // n_shards) * n_shards
    return n_tiles, n_pad, n_pad // n_shards


def _tile_bucket(table) -> str:
    """The autotuner's table-level tiling decision ('pow2' default)."""
    if table is None or ops.process_count() > 1:
        # across processes every process must lay the table out alike:
        # the tuner's exact tiling reads local pressure
        return "pow2"
    from ..layout import LAYOUT, layout_enabled

    if not layout_enabled():
        return "pow2"
    try:
        return LAYOUT.tile_bucket(table)
    except Exception:
        return "pow2"  # a tuner hiccup must never reshape a scan


def _full_dtype(kind) -> np.dtype:
    """The dtype compile_expr expects for a column of this kind (what the
    device program widens the wire array to before any arithmetic)."""
    if kind in (TypeKind.DATE, TypeKind.STRING):
        return np.dtype(np.int32)
    if kind == TypeKind.FLOAT:
        return np.dtype(np.float64)
    return np.dtype(np.int64)


def _wire_dtype(table, store_ci: int) -> np.dtype:
    """Narrowest integer dtype that exactly holds the column's base values
    (and 0, the pad value).  Host->device bytes and the card's read
    bytes both scale with wire width, so an int64 column whose values
    fit int8 transfers AND scans 8x cheaper; the program widens after
    the read.  Floats stay f64: narrowing is not generally exact."""
    full = _full_dtype(table.cols[store_ci].ftype.kind)
    if full == np.float64:
        return full
    lo, hi, _ = table.column_stats(store_ci)
    if hi < lo:  # empty: stats sentinel
        return np.dtype(np.int8)
    for cand in (np.int8, np.int16, np.int32):
        info = np.iinfo(cand)
        if info.min <= min(lo, 0) and max(hi, 0) <= info.max:
            return np.dtype(cand) if np.dtype(cand).itemsize \
                < full.itemsize else full
    return full


def _hot_priority(key: tuple) -> float:
    """Value-weighted eviction rank for a hot cache key: the layout
    autotuner's per-column residency priority (lowest evicts first).
    With the layout engine disabled every key ranks equal (FIFO)."""
    from ..layout import LAYOUT, layout_enabled

    if not layout_enabled():
        return 0.0
    return LAYOUT.priority(key[0], key[2])


def _hot_demote(key: tuple, value: tuple):
    """Demote an evicted hot column to the compressed cold tier
    (demote-to-cold before drop).  Only packable columns of a live store
    on the current mesh compress; everything else just drops (and
    reloads — possibly cold — on next access).  The evicted per-shard
    tensors feed the on-card re-encode, so demotion reads back nothing
    and touches no host block."""
    from ..layout import COLD_CACHE, LAYOUT, layout_enabled
    from ..layout.coldtier import pack_info, recompress_from_device
    from ..metrics import REGISTRY

    if not layout_enabled():
        return
    store_uid, base_version, store_ci = key[0], key[1], key[2]
    table = LAYOUT.store_ref(store_uid)
    if table is None or table.base_version != base_version:
        return
    info = pack_info(table, store_ci)
    mesh = _MESH  # snapshot: a moved mesh skips the demote (the next
    if info is None or mesh is None:  # access cold-loads on the new one)
        return
    if key[3] != mesh.ids or key[6] != mesh.where:
        return
    n_pad = key[5]

    COLD_CACHE.get_or_load(
        key + ("cold",),
        lambda: (recompress_from_device(table, store_ci, n_pad, info,
                                        value),))
    LAYOUT.note_demoted(store_uid, store_ci)
    REGISTRY.inc("layout_cold_demotions_total")


def _column_key(table, store_ci: int, mesh: Mesh) -> tuple:
    """The hot tier's key of one column on one mesh: (store_uid,
    base_version, store_ci, position ids, TILE, n_pad, devices).  The
    position ids let `evict_device` drop exactly what a dead position
    holds; n_pad keeps a re-laid table from pairing with a stale shape.
    The cold tier keys the same tuple + ("cold",)."""
    _, n_pad, _ = _layout(table.base_rows, mesh.size, table=table)
    return (table.store_uid, table.base_version, store_ci, mesh.ids,
            te.TILE, n_pad, mesh.where)


class _MeshCache:
    """`_column_key` -> (data, valid or None): each a `Shards`, shard s
    [Tl, TILE] on position s's device.

    The data tensors keep the NARROW wire dtype (see _wire_dtype) and
    the valid slot is None for columns with no NULLs — consumers widen
    on the card / substitute a constant mask.

    This is the HOT tier: capacity comes from TIDB_TPU_HBM_BYTES, and
    eviction is VALUE-WEIGHTED (layout autotuner): the lowest-priority
    column is the victim, and packable victims DEMOTE to the compressed
    cold tier (layout/coldtier) instead of dropping."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        import os as _os2

        from .cache import ByteCapCache

        if capacity_bytes is None:
            capacity_bytes = int(_os2.environ.get(
                "TIDB_TPU_HBM_BYTES", str(8 << 30)))
        self._c = ByteCapCache(capacity_bytes, name="mesh")
        self._c.set_policy(priority_fn=_hot_priority,
                           demote_fn=_hot_demote)

    @property
    def _cache(self):  # introspected by tests
        return self._c.items_view

    def get_column(self, mesh: Mesh, table, store_ci: int):
        key = _column_key(table, store_ci, mesh)
        n_pad = key[5]
        Tl = n_pad // mesh.size

        def load():
            from ..trace import span

            tile = te.TILE
            wire = _wire_dtype(table, store_ci)
            _, _, has_null = table.column_stats(store_ci)
            with span("copr.transfer", col=store_ci,
                      device_ids=list(mesh.ids)) as sp:
                # ONE flat host buffer filled block by block, pinned when
                # it goes to a card, then one copy per shard
                pin = on_card(mesh)
                host = torch.zeros(n_pad * tile, dtype=torch_dtype(wire),
                                   pin_memory=pin)
                flat = host.numpy()
                vhost = vflat = None
                if has_null:
                    vhost = torch.zeros(n_pad * tile, dtype=torch.bool,
                                        pin_memory=pin)
                    vflat = vhost.numpy()
                off = 0
                for _s, arrs, vals in table.iter_base_blocks(
                        [store_ci], 0, table.base_rows):
                    blk, v = arrs[0], vals[0]
                    n = len(blk)
                    flat[off:off + n] = blk  # casts to wire dtype
                    if vflat is not None:
                        vflat[off:off + n] = True if v is None else v
                    off += n
                sp.set(bytes=flat.nbytes
                       + (vflat.nbytes if vflat is not None else 0))
                data = place_shards(host.reshape(n_pad, tile), mesh, Tl)
                valid = None
                if vhost is not None:
                    valid = place_shards(vhost.reshape(n_pad, tile), mesh,
                                         Tl)
                return data, valid

        return self._c.get_or_load(key, load)

    def clear(self):
        self._c.clear()

    def evict_device(self, device_id: int) -> int:
        """Drop every cached column placed on a mesh holding this
        position: a rebuilt mesh never reads a dead position's shards."""
        return self._c.evict_if(lambda k: device_id in k[3])


MESH_CACHE = _MeshCache()


def _hbm_bytes() -> int:
    """Resident device bytes (hot cache + compressed cold tier + the
    per-tile cache) at this instant — stamped on execute spans so a
    finished trace carries its device-memory high-water mark."""
    from ..layout.coldtier import COLD_CACHE

    return (MESH_CACHE._c._bytes + COLD_CACHE._bytes
            + te.DEVICE_CACHE._c._bytes)


# a small shared pool overlaps the host tile build of one column with
# the transfer of another, for foreground queries and the prefetcher
_XFER_POOL = None
_SHUTDOWN = False


def _xfer_pool():
    global _XFER_POOL
    if _XFER_POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        _XFER_POOL = ThreadPoolExecutor(
            max_workers=int(os.environ.get("TIDB_TPU_XFER_THREADS", "4")),
            thread_name_prefix="tidb-tpu-xfer")
    return _XFER_POOL


def _note_shutdown():
    global _SHUTDOWN
    _SHUTDOWN = True


# threading._register_atexit runs BEFORE Py_Finalize joins non-daemon
# threads; this caps the interpreter-exit delay at one column transfer
try:
    threading._register_atexit(_note_shutdown)
except AttributeError:  # pragma: no cover - very old CPython
    import atexit as _atexit

    _atexit.register(_note_shutdown)


def load_columns(mesh: Mesh, table, store_cis):
    """(data, valid) of several columns from the hot tier, loaded
    concurrently on the transfer pool (the MPP sides read here: they
    never go through the cold layout)."""
    return _on_pool(MESH_CACHE.get_column, mesh, table, store_cis)


def _on_pool(get, mesh: Mesh, table, store_cis):
    """`get(mesh, table, ci)` for every column: on the transfer pool, or
    one after another in the given order when the mesh spans processes
    (every process then issues its transfers in one fixed order)."""
    cis = list(store_cis)
    if len(cis) <= 1 or ops.process_count() > 1:
        return [get(mesh, table, ci) for ci in cis]
    # pool workers re-attach to the submitter's span so transfer spans
    # land in the query's trace (contextvars don't cross threads)
    from ..trace import current_span, run_attached

    parent = current_span()
    futs = [_xfer_pool().submit(run_attached, parent, get, mesh, table, ci)
            for ci in cis]
    return [f.result() for f in futs]


def get_layout_column(mesh: Mesh, table, store_ci: int, plan=None):
    """One column through the adaptive layout: ('hot', (data, valid)) or
    ('cold', ColdColumn).  Cold-tier hits/loads/promotions are counted;
    the chaos site `layout/decompress` (and any compression failure)
    falls back to the hot tier, parity-preserved, and counts on
    `layout_cold_fallbacks_total`.  `plan` (a (tier, bits) pair) is the
    tier decision when the caller already took it (`_agreed_plans`)."""
    from ..layout import layout_enabled

    if not layout_enabled():
        return ("hot", MESH_CACHE.get_column(mesh, table, store_ci))
    from ..errors import TiDBTPUError
    from ..layout import COLD_CACHE, compress_column
    from ..layout.coldtier import DECOMPRESS_FAILPOINT
    from ..metrics import REGISTRY

    tier, bits = plan or _column_plan(table, store_ci)
    cold_key = _column_key(table, store_ci, mesh) + ("cold",)
    n_pad = cold_key[5]
    if tier == "cold" and bits:
        try:
            FAILPOINTS.hit(DECOMPRESS_FAILPOINT, col=store_ci, bits=bits)
            hit = COLD_CACHE.peek(cold_key) is not None
            entry = COLD_CACHE.get_or_load(
                cold_key,
                lambda: (compress_column(table, store_ci, mesh, n_pad),),
            )[0]
            REGISTRY.inc("layout_cold_hits_total" if hit
                         else "layout_cold_loads_total")
            return ("cold", entry)
        except TiDBTPUError:
            raise  # kill/deadline/quota keep their meaning
        except Exception:
            # chaos-armed decompress failure or a compression error:
            # serve the column hot — slower, never wrong
            REGISTRY.inc("layout_cold_fallbacks_total")
    elif COLD_CACHE.peek(cold_key) is not None:
        # the tuner re-decided hot (priority rose / pressure passed):
        # promote — drop the compressed copy, load the wire array
        COLD_CACHE.evict_if(lambda k: k == cold_key)
        REGISTRY.inc("layout_cold_promotions_total")
    return ("hot", MESH_CACHE.get_column(mesh, table, store_ci))


def load_layout_columns(mesh: Mesh, table, store_cis):
    """Per-column hot/cold entries for several columns, loaded
    concurrently on the transfer pool.  Across processes every column's
    tier is process 0's decision, and the loads run in order."""
    cis = list(store_cis)
    if ops.process_count() > 1:
        plans = _agreed_plans(table, cis)
        return [get_layout_column(mesh, table, ci, plan)
                for ci, plan in zip(cis, plans)]
    return _on_pool(get_layout_column, mesh, table, cis)


def _column_plan(table, store_ci: int):
    """The tuner's (tier, bits) for a column scanned now."""
    from ..layout import LAYOUT

    LAYOUT.observe(table, store_ci, "scan")
    p = LAYOUT.plan_for(table, store_ci)
    return p.tier, p.bits


def _agreed_plans(table, store_cis):
    """Process 0's (tier, bits) for each column (the tuner's decision
    reads this process's own pressure and history)."""
    from ..layout import layout_enabled

    if not layout_enabled():
        return [("hot", 0)] * len(store_cis)
    return ops.agree([_column_plan(table, ci) for ci in store_cis],
                     op="column tiers")


def prefetch_table(storage, table_id: int, min_rows: int = 1 << 20):
    """Warm the device column cache for a table in the background after a
    bulk load (the TiFlash eager-replica analog).  Concurrent queries
    never double-transfer: ByteCapCache latches in-flight loads per key.
    No-op for small tables."""
    try:
        table = storage.table(table_id)
    except Exception:
        return
    if table.base_rows < min_rows:
        return
    ops.device()  # a missing card raises here, on the caller's thread
    if ops.process_count() > 1:
        # background transfers would interleave with the statements'
        # collectives: queries load in order on demand instead
        return
    try:
        mesh = get_mesh()
    except Exception:
        return

    def run():
        try:
            version = table.base_version
            for ci in range(len(table.cols)):
                if _SHUTDOWN or table.base_version != version:
                    return  # interpreter exiting / data changed under us
                get_layout_column(mesh, table, ci)  # warms the right tier
        except Exception:
            pass  # prefetch is advisory; queries load on demand

    threading.Thread(
        target=run, daemon=False, name="tidb-tpu-prefetch").start()


# all-true deletion masks, byte-capped like the data cache; keyed on the
# mesh's positions so a rebuilt mesh never reads a dead position's mask
_ONES_CACHE = None


def _all_true(mesh: Mesh, n_pad: int) -> ops.Shards:
    global _ONES_CACHE
    if _ONES_CACHE is None:
        from .cache import ByteCapCache

        _ONES_CACHE = ByteCapCache(1 << 30)
    Tl = n_pad // mesh.size
    key = (mesh.ids, n_pad, te.TILE, mesh.where)

    def load():
        # every shard has the same shape: positions on one device share
        # one tensor
        ones = torch.ones((Tl, te.TILE), dtype=torch.bool)
        return (ops.on_positions(ones, mesh.devices),)

    return _ONES_CACHE.get_or_load(key, load)[0]


def _del_mask(deleted, mesh: Mesh, n_pad: int) -> ops.Shards:
    """The deletion mask of a snapshot's `deleted` handles, sharded like
    the columns: the resident all-true one unless rows were MVCC-deleted."""
    if not deleted:
        return _all_true(mesh, n_pad)
    pin = on_card(mesh)
    host = torch.ones(n_pad * te.TILE, dtype=torch.bool, pin_memory=pin)
    host.numpy()[np.fromiter(sorted(deleted), dtype=np.int64,
                             count=len(deleted))] = False
    return place_shards(host.reshape(n_pad, te.TILE), mesh,
                        n_pad // mesh.size)


# ---------------------------------------------------------------------------
# the fused program
# ---------------------------------------------------------------------------

def _key_device(d):
    """Device-side canonical join/group key: float keys stay in VALUE
    domain (-0.0 folded into 0.0), everything else widens to int64.  NaN
    keys are excluded by contract (SQL NULLs are tracked separately)."""
    if d.dtype.is_floating_point:
        return torch.where(d == 0.0, torch.zeros_like(d), d).to(
            torch.float64)
    return d.to(torch.int64)


def _apply_probes(an: _Analyzed, cols, m, pargs, n_local: int):
    """AND the runtime join-filter membership tests into the row mask
    (sorted build keys, searchsorted probe), then run the broadcast
    lookup JOINS: drop misses and extend the column environment at scan
    width + j with the gathered payload of the matched build row.

    `pargs` is `_join_operands`' tuple: per probe (keys, kn), per lookup
    (keys, kn) and a (payload, valid) pair per payload column; keys are
    padded past `kn` with a sentinel, which `pos < kn` keeps from
    matching.  A NULL key never matches.  Returns (mask, the clipped
    build-row position of every row per lookup)."""
    from .torch_eval import compile_expr

    for i, p in enumerate(an.probes):
        keys, kn = pargs[2 * i], pargs[2 * i + 1]
        d, v = compile_expr(p.key, cols, n_local)
        k = _key_device(d)
        pos = torch.searchsorted(keys, k)
        pos_c = torch.clamp(pos, 0, keys.shape[0] - 1)
        m = m & v & (pos < kn) & (keys[pos_c] == k)
    off = 2 * len(an.probes)
    out_idx = len(an.scan.columns)
    lookup_pos = []
    for lk in an.lookups:
        keys, kn = pargs[off], pargs[off + 1]
        off += 2
        d, v = compile_expr(lk.key, cols, n_local)
        k = d.to(torch.int64)
        pos = torch.searchsorted(keys, k)
        pos_c = torch.clamp(pos, 0, keys.shape[0] - 1)
        hit = (pos < kn) & (keys[pos_c] == k) & v
        m = m & hit
        lookup_pos.append(pos_c)
        for _ft in lk.payload_ftypes:
            pl, pv = pargs[off], pargs[off + 1]
            off += 2
            # the matched build row's payload per probe row; misses are
            # dead rows under m and their payload is NULL
            cols[out_idx] = (pl[pos_c], hit & pv[pos_c])
            out_idx += 1
    return m, lookup_pos


def _pow2_pad(k: int) -> int:
    """The padded length of a build-key operand: a power of 2, at least
    16, so programs are shared across build sizes of one bucket."""
    kpad = 16
    while kpad < k:
        kpad <<= 1
    return kpad


def _join_operands(req: CopRequest, an: _Analyzed, mesh: Mesh):
    """The probes' and lookups' runtime operands on every position, read
    from `req.aux` once per query (every dispatch chunk shares them):
    (pargs, kpads) with each operand a `Shards` (the build side is
    broadcast to every shard), or None when a lookup key is a float (the
    caller declines the fused program).  A missing operand raises."""
    from ..errors import ExecutorError

    aux = req.aux or {}
    pargs: list = []
    kpads: List[int] = []

    def keys_operand(arr, dtype, sentinel, k):
        kpad = _pow2_pad(k)
        padded = np.full(kpad, sentinel, dtype=dtype)
        padded[:k] = arr
        pargs.append(to_positions(padded, mesh))
        # kn stays on the card: reading it back would cost a sync
        pargs.append(to_positions(np.array(k, dtype=np.int64), mesh))
        kpads.append(kpad)
        return kpad

    for p in an.probes:
        arr = aux.get(f"probe_keys_{p.filter_id}")
        if arr is None:
            raise ExecutorError(f"missing runtime probe keys {p.filter_id}")
        if p.key.ftype.kind == TypeKind.FLOAT:
            # aux carries canonical int64 BIT patterns
            # (ir.key_bits_int64); the card compares float keys by
            # value, so the bits become values and sort again (bit order
            # is not value order for negatives)
            keys_operand(np.sort(arr.view(np.float64)), np.float64,
                         np.inf, len(arr))
        else:
            keys_operand(arr, np.int64, np.iinfo(np.int64).max, len(arr))
    for lk in an.lookups:
        arr = aux.get(f"probe_keys_{lk.filter_id}")
        payload = aux.get(f"payload_{lk.filter_id}")
        pvalids = aux.get(f"payload_valid_{lk.filter_id}")
        if arr is None or payload is None:
            raise ExecutorError(f"missing join lookup aux {lk.filter_id}")
        if lk.key.ftype.kind == TypeKind.FLOAT:
            return None
        k = len(arr)
        kpad = keys_operand(arr, np.int64, np.iinfo(np.int64).max, k)
        for j, ft in enumerate(lk.payload_ftypes):
            pl = np.zeros(kpad, dtype=_full_dtype(ft.kind))
            pl[:k] = payload[j]
            pv = np.zeros(kpad, dtype=np.bool_)
            src_v = pvalids[j] if pvalids is not None else None
            pv[:k] = True if src_v is None else src_v
            pargs.append(to_positions(pl, mesh))
            pargs.append(to_positions(pv, mesh))
    return tuple(pargs), kpads


class MeshAggOverflow(Exception):
    """A dispatch's distinct-group count exceeded the static output
    budget; the caller peels the aggregation to a host tail."""


def _agg_out_budget() -> int:
    """The sort-mode group budget per dispatch before the clip to the
    dispatch's rows (TIDB_TPU_AGG_OUT, default 2**17)."""
    import os as _os

    return int(_os.environ.get("TIDB_TPU_AGG_OUT", 1 << 17))

def _cols_env(an: _Analyzed, col_order: List[int], datas, valids,
              lo: int, hi: int, params=None, col_layout=None, lvals=()):
    """Column environment for compile_expr over rows [lo, hi): widen the
    narrow wire tensors to the canonical dtype, and substitute a
    constant mask for columns cached without a validity tensor (no
    NULLs).  `params` carries the hoisted predicate parameter vectors
    (pi, pf) for ParamConst slots.

    `col_layout[j]` = (bits, cap, kind) marks column j COLD: datas[j] is
    the bit-packed code bytes and the matching `lvals` entry its decode
    operand (scalar bias for 'range', dictionary vector for 'unique');
    the decode emitter (fusion.decode_packed) unpacks it with the CUDA
    kernel.  `lo` and `hi` are multiples of 8, so a packed slice starts
    on a byte.  Cold columns are NULL-free by the tuner's contract."""
    from . import fusion

    n = hi - lo
    dev = datas[0].device if datas else ops.device()
    env = {}
    lv = 0
    for j, ci in enumerate(col_order):
        lay = col_layout[j] if col_layout is not None else None
        if lay is not None:
            bits, _cap, kind = lay
            vpb = 8 // bits
            packed = datas[j].reshape(-1)[lo // vpb: hi // vpb]
            d = fusion.decode_packed(packed, lvals[lv], bits, n, kind=kind)
            lv += 1
            env[ci] = (d, torch.ones(n, dtype=torch.bool, device=dev))
            continue
        d = datas[j].reshape(-1)[lo:hi]
        target = torch_dtype(_full_dtype(an.scan.ftypes[ci].kind))
        if d.dtype != target:
            d = d.to(target)
        v = valids[j]
        v = (torch.ones(n, dtype=torch.bool, device=dev) if v is None
             else v.reshape(-1)[lo:hi])
        env[ci] = (d, v)
    if params is not None:
        env["__params__"] = params
    return env


from .cache import ProgramCache  # noqa: E402

_COMPILED = ProgramCache("mesh")

#: range slots per fused dispatch: a request with more disjoint ranges
#: takes the per-region fan-out, and chunked dispatch groups at most
#: this many ranges into one pass (the JAX package's program shape)
MESH_RANGE_SLOTS = 4


def _span_of(bounds) -> Tuple[int, int]:
    """Rows [lo, hi) one dispatch touches: the bounds' hull widened to
    multiples of 8 (whole bytes of every packed width)."""
    lo = bounds[0][0] - bounds[0][0] % 8
    hi = bounds[-1][1] + (-bounds[-1][1]) % 8
    return lo, hi


def _mesh_masks(del_mask, bounds, lo: int, hi: int):
    """Live-row mask over rows [lo, hi): the union of the range slots'
    [start, end) clips, ANDed with the deletion mask.  Every one of the
    MESH_RANGE_SLOTS slots is written, the unused ones as empty spans,
    so the program's op sequence does not depend on the range count."""
    m = torch.zeros(hi - lo, dtype=torch.bool, device=del_mask.device)
    pad = [(lo, lo)] * (MESH_RANGE_SLOTS - len(bounds))
    for s, e in list(bounds) + pad:
        # narrow, not a slice assignment: a slot that covers the whole
        # span would skip the slice op and change the op sequence
        m.narrow(0, s - lo, e - s).fill_(True)
    return m & del_mask.reshape(-1)[lo:hi]


def _build_mesh_core(an: _Analyzed, kind: str, col_order: List[int],
                     n_global: int, col_layout=None):
    """The fused whole-fragment program of ONE shard for one fragment
    shape: core(datas, valids, del_mask, bounds, lvals, pargs, params,
    row0), over that shard's tensors, with `bounds` in its own row
    coordinates and `row0` its first global row.

    It evaluates the rows of one dispatch's span (`_span_of(bounds)`),
    builds the union row mask over the range slots, and composes the
    fusion phase emitters (copr/fusion.py) — selection, the join probes
    and lookups (`_apply_probes` over the `pargs` operands), then dense
    group codes and aggregation for `agg`, the top-k for `topn`, or just
    the mask for `filter` — so the fragment is one sequence of device
    ops.  Returns (gcount, results) tensors for dense `agg`, (global row
    handles, count) for `topn` and (first global row, mask) for
    `filter`; sort-mode `agg` is `_build_sort_agg_core`."""
    from . import fusion

    if kind == "agg" and an.agg_mode == "sort":
        return _build_sort_agg_core(an, col_order, n_global,
                                    col_layout=col_layout)

    def region_ctx(datas, valids, del_mask, bounds, lvals, pargs, params,
                   row0):
        lo, hi = _span_of(bounds)
        cols = _cols_env(an, col_order, datas, valids, lo, hi, params,
                         col_layout=col_layout, lvals=lvals)
        row_mask = _mesh_masks(del_mask, bounds, lo, hi)
        gofs = None
        if an.agg is not None and any(a.name == "first_row"
                                      for a in an.agg.aggs):
            # global row offsets: argfirst picks the first GLOBAL row
            gofs = torch.arange(row0 + lo, row0 + hi, dtype=torch.int64,
                                device=row_mask.device)
        ctx = fusion.RegionContext(an=an, cols=cols, n=hi - lo,
                                   mask=row_mask, gofs=gofs,
                                   n_global=n_global)
        fusion.selection_mask(ctx)
        ctx.mask, _pos = _apply_probes(an, cols, ctx.mask, pargs, hi - lo)
        return row0 + lo, ctx

    if kind == "agg":
        def core(datas, valids, del_mask, bounds, lvals, pargs, params,
                 row0):
            _g0, ctx = region_ctx(datas, valids, del_mask, bounds, lvals,
                                  pargs, params, row0)
            gidx = fusion.dense_group_codes(ctx)
            return fusion.dense_agg_results(ctx, gidx)
    elif kind == "topn":
        from ..serving import topn_budget

        desc = fusion.topn_desc(an)
        budget = topn_budget(an.topn.limit)

        def core(datas, valids, del_mask, bounds, lvals, pargs, params,
                 row0):
            g0, ctx = region_ctx(datas, valids, del_mask, bounds, lvals,
                                 pargs, params, row0)
            key = fusion.topn_key(ctx)
            idx, cnt = ops.masked_top_k(key, ctx.mask,
                                        min(budget, ctx.n), desc)
            return idx + g0, cnt
    else:  # filter: the fused selection mask
        def core(datas, valids, del_mask, bounds, lvals, pargs, params,
                 row0):
            g0, ctx = region_ctx(datas, valids, del_mask, bounds, lvals,
                                 pargs, params, row0)
            return g0, ctx.mask
    return core


def _remap_source(col_order, datas, col_layout, cols, idx: int, lo: int,
                  hi: int):
    """The codes K1 reads for scan column `idx`: a hot column's narrow
    wire slice as it is (no widening copy), a cold column's decoded
    codes (K2's output plus the range bias)."""
    j = col_order.index(idx)
    if col_layout is not None and col_layout[j] is not None:
        return cols[idx][0]
    return datas[j].reshape(-1)[lo:hi]


def _fd_sort_lookup(an: _Analyzed) -> bool:
    """True when the single unique-key lookup FUNCTIONALLY DETERMINES
    every group key (the TPC-H Q3 shape: GROUP BY join key, payload...):
    the matched build-row index then serves as the one sort key, so the
    sort is a single int sort instead of one per key column plus the
    flags."""
    from ..expr.expression import ColumnExpr

    if len(an.lookups) != 1 or an.probes or an.agg is None:
        return False
    lk = an.lookups[0]
    key_ser = json.dumps(serialize_expr(lk.key), sort_keys=True)
    width = len(an.scan.columns)
    lo, hi = width, width + len(lk.payload_ftypes)
    for g in an.agg.group_by:
        if isinstance(g, ColumnExpr) and lo <= g.index < hi:
            continue  # payload column: fixed per matched build row
        if json.dumps(serialize_expr(g), sort_keys=True) == key_ser:
            continue  # the join key itself (unique per build row)
        return False
    return True


def _build_sort_agg_core(an: _Analyzed, col_order: List[int],
                         n_global: int, col_layout=None):
    """Sort-based partial aggregation of ONE shard for arbitrary group
    keys (any NDV, float, NULLable, computed keys): core(datas, valids,
    del_mask, bounds, lvals, pargs, params, row0) -> (n_uniq, keys,
    results, OUT).

    Per dispatch: sort rows by (key bits..., null flags...,
    selected-first), mark group boundaries, segment-reduce into a
    static budget of OUT = min(TIDB_TPU_AGG_OUT, span rows) groups, and
    emit compacted (keys, partial states).  No collective: every shard's
    partial chunk goes to the ROOT final HashAgg, which merges them —
    the reference's coprocessor-partial/root-final split
    (executor/aggregate.go:101-169).  Computed keys regather their
    dictionary codes through the remap operands (the lvals tail after
    the cold dictionary operands) with K1."""
    from . import fusion
    from .torch_eval import compile_expr

    agg_ir = an.agg
    n_cold = sum(1 for c in (col_layout or ()) if c is not None)
    remaps = an.key_remaps
    out_budget = _agg_out_budget()
    needs_gofs = any(a.name == "first_row" for a in agg_ir.aggs)
    fd_lookup = _fd_sort_lookup(an)

    def core(datas, valids, del_mask, bounds, lvals, pargs, params, row0):
        lo, hi = _span_of(bounds)
        n_local = hi - lo
        out = min(out_budget, n_local)
        cols = _cols_env(an, col_order, datas, valids, lo, hi, params,
                         col_layout=col_layout, lvals=lvals)
        m = _mesh_masks(del_mask, bounds, lo, hi)
        ctx = fusion.RegionContext(an=an, cols=cols, n=n_local, mask=m,
                                   n_global=n_global)
        m = fusion.selection_mask(ctx)
        m, lookup_pos = _apply_probes(an, cols, m, pargs, n_local)
        key_bits, key_flags = [], []
        rslot = 0
        for gi, g in enumerate(agg_ir.group_by):
            rem = remaps[gi] if remaps is not None else None
            if rem is not None:
                # computed key: code-space gather through the runtime
                # mapping operand (K1)
                codes = _remap_source(col_order, datas, col_layout, cols,
                                      rem.src_idx, lo, hi)
                v = cols[rem.src_idx][1]
                d = fusion.remap_codes(codes, lvals[n_cold + rslot],
                                       n_local)
                rslot += 1
            else:
                d, v = compile_expr(g, cols, n_local)
            # float keys group in VALUE domain (-0.0 folds into 0.0);
            # NULL rows get a fixed key so the flag alone separates them
            k = _key_device(d)
            key_bits.append(torch.where(v, k, torch.zeros_like(k)))
            key_flags.append(v.to(torch.int64))
        order = diff = None
        if fd_lookup:
            # every group key is determined by the matched build row:
            # one stable sort of its index replaces the keyed sorts;
            # unselected rows sort last, at the padded build length
            kpad = pargs[0].shape[0]
            sortk = torch.where(m, lookup_pos[0],
                                torch.full_like(lookup_pos[0], kpad))
            ssort, order = torch.sort(sortk, stable=True)
            diff = torch.ones(n_local, dtype=torch.bool, device=m.device)
            diff[1:] = ssort[1:] != ssort[:-1]
        order, sm, skeys, seg, pos, n_uniq = fusion.sort_group_segments(
            key_bits, key_flags, m, out, order=order, diff=diff)
        out_keys = [k[pos] for k in skeys]
        sgofs = None
        if needs_gofs:
            sgofs = order + (row0 + lo)  # global row of each sorted row
        results = fusion.grouped_partial_states(
            agg_ir.aggs, lambda e: compile_expr(e, cols, n_local),
            order, sm, seg, out, sgofs=sgofs, n_global=n_global)
        return n_uniq, out_keys, results, out

    return core


def _readback(x):
    if isinstance(x, tuple):
        return tuple(t.cpu().numpy() for t in x)
    return x.cpu().numpy()


def _shard_calls(core, mesh_size: int, n_local: int, datas, valids,
                 del_mask, bounds, lvals, pargs, params):
    """Issue `core` on every local shard the bounds touch, in shard
    order, each on its own position's tensors; nothing is read back in
    between (launches are asynchronous, so the shards of a multi-card
    mesh overlap up to the size reads inside a shard's own ops).
    Returns every touched shard's output in shard order, those of other
    processes gathered (`ops.gather_shards`) after the local shards
    were issued."""
    outs = [None] * mesh_size
    for s in range(mesh_size):
        sb = local_bounds(bounds, s, n_local)
        if not sb or del_mask[s] is None:
            # the dispatch touches none of this shard's rows, or the
            # shard is another process's
            continue
        outs[s] = core(
            [d[s] for d in datas],
            [None if v is None else v[s] for v in valids],
            del_mask[s], sb, tuple(x[s] for x in lvals),
            tuple(x[s] for x in pargs),
            None if params is None else tuple(x[s] for x in params),
            s * n_local)
    return outs


def _gathered(outs, local=None):
    """The touched shards' outputs of every process, in shard order:
    `local` first maps this process's outputs (what crosses processes);
    other processes' arrive through `ops.gather_shards`."""
    if local is not None:
        outs = [None if o is None else local(o) for o in outs]
    return [o for o in ops.gather_shards(outs) if o is not None]


def _merge_shard_agg(an: _Analyzed, parts):
    """The cross-shard merge of dense partials (`parts`: every touched
    shard's, gathered): gcount, counts and sums
    add in shard order on position 0's device (`ops.psum`); min/max
    values and first-row indices come back as per-shard [S, G] partials
    that the host merges after the readback, as the JAX package does
    (its compiler lowers only Sum all-reduces)."""
    gcount = ops.psum([p[0] for p in parts])
    results = []
    for si, a in enumerate(an.agg.aggs):
        rs = [p[1][si] for p in parts]
        if a.name in ("min", "max"):
            results.append((ops.gather0([r[0] for r in rs]),
                            ops.psum([r[1] for r in rs])))
        elif a.name == "first_row":
            results.append(ops.gather0(rs))
        elif isinstance(rs[0], tuple):
            results.append(tuple(ops.psum([r[i] for r in rs])
                                 for i in range(len(rs[0]))))
        else:
            results.append(ops.psum(rs))
    return gcount, results


def _build_mesh_fn(an: _Analyzed, kind: str, col_order: List[int],
                   mesh: Mesh, tiles_per_shard: int, col_layout=None):
    """The fused program over every shard plus its readback, traced as
    one `copr.device.execute` span and one `copr.readback` span.

    fn(datas, valids, del_mask, bounds, lvals, pargs, params) takes
    `Shards` operands and global range bounds and returns (gcount,
    [(tag, result), ...]) as numpy for `agg` (merged across shards),
    the candidate global row handles for `topn` and the selected global
    row handles (int64 numpy, ascending) for `filter`."""
    from ..trace import span

    S = mesh.size
    n_local = tiles_per_shard * te.TILE
    n_global = S * n_local
    core = _build_mesh_core(an, kind, col_order, n_global,
                            col_layout=col_layout)

    def run(datas, valids, del_mask, bounds, lvals, pargs, params):
        return _shard_calls(core, S, n_local, datas, valids, del_mask,
                            bounds, lvals, pargs, params)

    if kind == "agg" and an.agg_mode == "sort":
        return _wrap_sort_agg(an, run)
    if kind == "agg":
        tags = te._agg_tags(an.agg)

        def wrapped(datas, valids, del_mask, bounds, lvals, pargs, params):
            with span("copr.device.execute", hbm_bytes=_hbm_bytes()):
                gcount, results = _merge_shard_agg(an, _gathered(run(
                    datas, valids, del_mask, bounds, lvals, pargs,
                    params)))
            with span("copr.readback") as sp:
                gcount = _readback(gcount)
                results = [_readback(r) for r in results]
                sp.set(bytes=int(gcount.nbytes) + sum(
                    sum(x.nbytes for x in r) if isinstance(r, tuple)
                    else r.nbytes for r in results))
            merged = []
            for a, tag, r in zip(an.agg.aggs, tags, results):
                if tag == "minmax":
                    part, cnt = r  # part: [S', G] per-shard partials
                    part = part.min(0) if a.name == "min" else part.max(0)
                    r = (part, cnt)
                elif tag == "argfirst":
                    r = r.min(0)
                merged.append((tag, r))
            return gcount, merged

        return wrapped

    if kind == "topn":
        def wrapped(datas, valids, del_mask, bounds, lvals, pargs, params):
            with span("copr.device.execute", hbm_bytes=_hbm_bytes()):
                parts = _gathered(run(datas, valids, del_mask, bounds,
                                      lvals, pargs, params))
            with span("copr.readback") as sp:
                # every shard's candidates, read once all were issued
                cnts = [int(c) for _h, c in parts]
                out = np.concatenate(
                    [h[:c].cpu().numpy() for (h, _c), c in zip(parts, cnts)]
                    or [np.zeros(0, np.int64)])
                sp.set(bytes=out.nbytes)
            return out

        return wrapped

    def wrapped(datas, valids, del_mask, bounds, lvals, pargs, params):
        with span("copr.device.execute", hbm_bytes=_hbm_bytes()):
            handles = _gathered(
                run(datas, valids, del_mask, bounds, lvals, pargs, params),
                lambda p: torch.nonzero(p[1]).reshape(-1) + p[0])
        with span("copr.readback") as sp:
            # shards hold ascending row blocks: shard order keeps the
            # handles ascending
            out = np.concatenate([h.cpu().numpy() for h in handles]
                                 or [np.zeros(0, np.int64)])
            sp.set(bytes=out.nbytes)
        return out

    return wrapped


def _wrap_sort_agg(an: _Analyzed, run):
    """The sort-mode program plus its readback: every shard's group count
    first (read once every shard was issued), then only the first
    min(n_uniq, OUT) slots of every key and state of each shard (nothing
    more once a budget blew — the caller raises).  Returns one dict per
    shard, in shard order."""
    from ..trace import span

    tags = te._agg_tags(an.agg)

    def wrapped(datas, valids, del_mask, bounds, lvals, pargs, params):
        with span("copr.device.execute", hbm_bytes=_hbm_bytes()):
            # across processes a shard sends only its first min(n_uniq,
            # OUT) slots
            parts = _gathered(
                run(datas, valids, del_mask, bounds, lvals, pargs, params),
                _compact_sort_part if ops.process_count() > 1 else None)
        outs = []
        with span("copr.readback") as sp:
            ks = [int(p[0]) for p in parts]
            blown = any(k > p[3] for k, p in zip(ks, parts))
            nbytes = 0
            for k, (_n, keys, results, out) in zip(ks, parts):
                if blown:
                    keys, results = [], []
                else:
                    keys = [t[:k].cpu().numpy() for t in keys]
                    results = [tuple(x[:k].cpu().numpy() for x in r)
                               if isinstance(r, tuple)
                               else r[:k].cpu().numpy() for r in results]
                nbytes += sum(x.nbytes for x in keys) + sum(
                    sum(x.nbytes for x in r) if isinstance(r, tuple)
                    else r.nbytes for r in results)
                outs.append({"OUT": out, "n_uniq": k, "keys": keys,
                             "results": list(zip(tags, results))})
            sp.set(bytes=nbytes)
        return outs

    return wrapped


def _compact_sort_part(p):
    """A sort-mode shard output cut to its first min(n_uniq, OUT)
    slots (the slots the readback takes)."""
    n, keys, results, out = p
    k = min(int(n), out)
    return (n, [t[:k] for t in keys],
            [tuple(x[:k] for x in r) if isinstance(r, tuple) else r[:k]
             for r in results], out)


def _sort_agg_chunks(outs: list, table, an: _Analyzed) -> List[Chunk]:
    """Every shard's compacted groups -> one partial chunk a shard [keys...,
    states...] in the layout the CPU engine emits (the root final agg
    merges).  Raises MeshAggOverflow when a shard's group budget blew."""
    from ..store.blockstore import _decode_dict

    for s, out in enumerate(outs):
        if out["n_uniq"] > out["OUT"]:
            raise MeshAggOverflow(f"shard {s}: {out['n_uniq']} groups > "
                                  f"budget {out['OUT']}")
    chunks: List[Chunk] = []
    nk = len(an.agg.group_by)
    for out in outs:
        k_s = out["n_uniq"]
        if k_s == 0:
            continue
        cols: List[Column] = []
        for i, g in enumerate(an.agg.group_by):
            bits = out["keys"][i]
            flags = out["keys"][nk + i].astype(np.bool_)
            ft = g.ftype
            rem = an.key_remaps[i] if an.key_remaps else None
            if rem is not None and rem.out_dict is not None:
                # computed-key codes decode through the remap's OUTPUT
                # dictionary (sorted, so code order == string order);
                # INT-valued remaps carry the computed values directly
                data = _decode_dict(bits.astype(np.int64), rem.out_dict)
            elif ft.kind == TypeKind.FLOAT:
                data = bits.astype(np.float64, copy=False)
            elif ft.kind == TypeKind.STRING:
                store_ci = an.scan.columns[g.index]
                data = _decode_dict(bits.astype(np.int64),
                                    table.cols[store_ci].dictionary)
            else:
                data = bits.astype(ft.np_dtype)
            cols.append(Column(ft, data, flags if not flags.all() else None))
        for a, (tag, r) in zip(an.agg.aggs, out["results"]):
            pts = a.partial_types()
            if tag == "count":
                cols.append(Column(pts[0], r.astype(np.int64)))
            elif tag == "sumcount":
                sm_, c = r
                cols.append(Column(pts[0], sm_.astype(pts[0].np_dtype),
                                   c > 0))
                if a.name == "avg":
                    cols.append(Column(pts[1], c.astype(np.int64)))
            elif tag == "minmax":
                v, c = r
                if a.args[0].ftype.kind == TypeKind.STRING:
                    store_ci = an.scan.columns[a.args[0].index]
                    obj = _decode_dict(v.astype(np.int64),
                                       table.cols[store_ci].dictionary)
                    cols.append(Column(pts[0], obj, c > 0))
                else:
                    cols.append(Column(pts[0], v.astype(pts[0].np_dtype),
                                       c > 0))
            elif tag == "argfirst":
                vals, valid = _gather_first_values(table, an, a.args[0], r,
                                                   k_s)
                cols.append(Column(pts[0], vals, valid))
        chunks.append(Chunk(cols))
    return chunks


def _peel_agg_rerun(storage, req, tid: int, dag: DAG, reason: str):
    """MeshAggOverflow rung: re-run the SAME fragment with the fused
    region cut just before the aggregation — the scan+selection head
    streams from the card and the agg runs as a host tail over the
    still-partial chunks.  Returns the filter-stream generator, or None
    when no device head remains (a scan-only head reduces nothing; the
    caller then leaves the fragment to the per-region rung)."""
    from .ir import AggregationIR

    cut = next((i for i, x in enumerate(dag.executors)
                if isinstance(x, AggregationIR)), 0)
    if cut <= 1:
        return None
    from ..metrics import REGISTRY
    from ..trace import annotate

    REGISTRY.inc("mesh_agg_peel_total")
    annotate(mesh_agg_peel=reason[:80])
    # the forced cut analyzes cleanly (no DeviceUnsupported), so the
    # split label is supplied: a data-dependent budget overflow, not an
    # unsupported operator
    return _run_mesh_once(storage, req, tid, max_cut=cut,
                          forced_label="agg-overflow")


def _compile_labeled(fn, kind: str):
    """Wrap a freshly built program so its first dispatch records a
    copr.compile span (cache=miss); later calls pass straight through."""
    state = {"first": True}

    def call(*args, **kwargs):
        if state["first"]:
            state["first"] = False
            from ..trace import span

            with span("copr.compile", cache="miss", kind=kind):
                return fn(*args, **kwargs)
        return fn(*args, **kwargs)

    return call


# ---------------------------------------------------------------------------
# entry: run a CopRequest's base scan on the card
# ---------------------------------------------------------------------------

# initial run + up to two retries per request after a consumed device
# failure (an OOM that evicted the caches); beyond that the error
# surfaces to the statement
MAX_MESH_ATTEMPTS = 3


def _failed_positions(exc: BaseException):
    """The mesh positions a failure implicates: a `DeviceFailure`'s
    payload names positions; an id parsed from a runtime's message names
    a physical card, and trips every position that card holds."""
    ids = attribute_devices(exc)
    if getattr(exc, "device_ids", ()):
        return ids
    out = []
    for card in ids:
        for pid in ops.positions_on_card(card):
            if pid not in out:
                out.append(pid)
    return tuple(out)


def _evict_position(did: int):
    """Drop everything cached on mesh position `did`: hot and cold
    columns and masks of every mesh that held it, and its tiles."""
    from ..layout import coldtier

    MESH_CACHE.evict_device(did)
    coldtier.evict_device(did)
    te.DEVICE_CACHE.evict_device(did)
    if _ONES_CACHE is not None:
        _ONES_CACHE.evict_if(lambda k, d=did: d in k[0])


def _handle_mesh_failure(req: CopRequest, exc: BaseException,
                         attempts: int) -> bool:
    """Consume one device runtime failure; True when the request may
    retry on a (possibly rebuilt) mesh.  Device-attributed errors trip
    the breaker of every implicated position and evict what it holds, so
    the retry rebuilds the mesh over the survivors; device-memory OOM
    evicts the caches wholesale (device memory is a cache over host
    blocks) and trips nothing.  Unclassifiable errors are NOT consumed:
    they surface as they are.  The trip and eviction run even on the last
    attempt: the next statement must not run on a dead position."""
    from ..layout import coldtier
    from ..metrics import REGISTRY

    kind = classify_failure(exc)
    if kind is None:
        return False
    dead = _failed_positions(exc)
    for did in dead:
        DEVICE_HEALTH.record_error(did, exc)
        _evict_position(did)
    if kind == "oom":
        REGISTRY.inc("mesh_hbm_oom_total")
        MESH_CACHE.clear()
        coldtier.clear()
        te.DEVICE_CACHE.clear()
        if _ONES_CACHE is not None:
            _ONES_CACHE.clear()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    if attempts + 1 >= MAX_MESH_ATTEMPTS or ops.process_count() > 1:
        # across processes a retry on this process alone would pair its
        # collectives with the next statement's on the others: the
        # error reaches the statement (the program's abort fails it on
        # every process), and the trip reaches every process's mesh
        # through the membership epoch
        return False
    REGISTRY.inc("mesh_failover_retries_total")
    import logging

    logging.getLogger("tidb_tpu.copr").warning(
        "device %s failure (positions %s): retrying over the surviving "
        "positions: %s", kind, list(dead) or "unattributed", exc)
    return True


def statement_program(name: str, *key):
    """The `ops.program` a statement's collectives run in across
    processes, tagged with `key` (the request's plan and ranges: data
    every process holds alike).  Joins the process group first, so a
    statement is never split between one process and several."""
    _maybe_init_multihost()
    return ops.program(name, json.dumps(key, sort_keys=True, default=str)
                       if ops.process_count() > 1 else "")


def try_run_mesh(storage, req: CopRequest, table_id=None):
    """`_try_run_mesh` in one program across processes: there the lazy
    filter stream is drained inside the program (its gathers are the
    statement's collectives), so the result is a list."""
    with statement_program(
            "mesh", req.dag,
            [(kr.table_id, kr.start, kr.end) for kr in req.ranges]):
        out = _try_run_mesh(storage, req, table_id)
        if out is None or ops.process_count() == 1:
            return out
        return list(out)


def _try_run_mesh(storage, req: CopRequest, table_id=None):
    """Run the whole request over the mesh with device failover; None if
    the plan is ineligible (the caller falls back to the per-region
    fan-out, and `req.mesh_reject_reason` says why in EXPLAIN ANALYZE).

    Failover ladder (README "Fault-tolerance model"): a runtime failure
    trips the implicated positions' breakers, evicts what they hold,
    REBUILDS the mesh over the survivors and re-runs there.  Runtime
    failures never turn into None: when every breaker is open the
    statement gets `DeviceUnavailableError` (no host step-down).

    Returns an ITERABLE of chunks: a list for agg, a ONE-SHOT lazy
    generator for filters (streamed gathers — iterate exactly once; a
    device error before the first chunk retries, after rows were
    emitted it surfaces to the consumer)."""
    from ..coord import CoordEpochMismatch

    dag = DAG.from_dict(req.dag)
    tid = table_id if table_id is not None else dag.scan.table_id
    range_tids = sorted({kr.table_id for kr in req.ranges})
    if range_tids and (len(range_tids) > 1 or range_tids[0] != tid):
        # partitioned table: ranges address partition stores, not the
        # logical id in the DAG — one program per partition, chained
        return _mesh_over_partitions(storage, req, range_tids)
    _check_breaker()
    attempts = 0
    while True:
        try:
            out = _run_mesh_once(storage, req, tid)
        except CoordEpochMismatch:
            # membership moved between mesh build and dispatch: rebuild
            # from the new broadcast and re-run; never a breaker trip
            if attempts + 1 >= MAX_MESH_ATTEMPTS:
                raise
            attempts += 1
            continue
        except BaseException as e:
            if not _handle_mesh_failure(req, e, attempts):
                raise
            _check_breaker()
            attempts += 1
            continue
        if out is not None and not isinstance(out, list):
            # lazy filter stream: iteration gets the same failover loop
            return _guarded_stream(storage, req, tid, out, attempts)
        return out


def _guarded_stream(storage, req: CopRequest, tid: int, gen, attempts: int):
    """Wrap a one-shot filter stream in the failover loop: a device
    failure BEFORE the first chunk rebuilds the mesh and restarts the
    stream from scratch; after rows were emitted a retry would duplicate
    them, so the error surfaces."""
    from ..coord import CoordEpochMismatch

    while True:
        emitted = False
        try:
            if gen is None:
                gen = _run_mesh_once(storage, req, tid)
                if gen is None or isinstance(gen, list):
                    raise RuntimeError(
                        "mesh retry declined: "
                        f"{getattr(req, 'mesh_reject_reason', 'ineligible')}")
            for c in gen:
                emitted = True
                yield c
            return
        except CoordEpochMismatch:
            if emitted or attempts + 1 >= MAX_MESH_ATTEMPTS:
                raise
            attempts += 1
            gen = None
        except BaseException as e:
            handled = _handle_mesh_failure(req, e, attempts)
            if emitted or not handled:
                raise
            _check_breaker()
            attempts += 1
            gen = None


def _observe_fragment(table, an: _Analyzed):
    """Feed the fragment's column USAGE to the layout autotuner: which
    store columns serve as filter inputs, group keys, aggregate
    arguments and probe keys (the signal the residency priority
    weighs)."""
    from ..layout import LAYOUT, layout_enabled

    if not layout_enabled():
        return
    width = len(an.scan.columns)

    def obs(exprs, kind):
        refs: set = set()
        for e in exprs:
            e.collect_columns(refs)
        for i in refs:
            if i < width:
                LAYOUT.observe(table, an.scan.columns[i], kind)

    obs(an.conds, "filter")
    obs([p.key for p in an.probes] + [lk.key for lk in an.lookups],
        "probe_key")
    if an.agg is not None:
        obs(an.agg.group_by, "agg_key")
        obs([x for a in an.agg.aggs for x in a.args], "agg_arg")


def _run_mesh_once(storage, req: CopRequest, tid: int,
                   max_cut: Optional[int] = None,
                   forced_label: Optional[str] = None):
    """One attempt at running the request over the current mesh; None if
    ineligible.  Raises on runtime failures — try_run_mesh owns the
    retry.

    `max_cut` caps the fused region at an executor boundary — the
    MeshAggOverflow peel re-enters here with the cut just before the
    aggregation; `forced_label` names the split reason for such forced
    cuts (the region analyzes cleanly, so plan_regions cannot classify
    them itself)."""
    dag = DAG.from_dict(req.dag)
    table = storage.table(tid)
    if table.base_rows == 0 or table.base_ts > req.ts:
        req.mesh_reject_reason = "empty table or stale snapshot"
        return None
    if len(req.ranges) > MESH_RANGE_SLOTS:
        req.mesh_reject_reason = f"{len(req.ranges)} disjoint ranges"
        return None  # many disjoint ranges: per-region fan-out handles it
    from .fusion import fusion_enabled, plan_regions

    if not fusion_enabled():
        req.mesh_reject_reason = "whole-fragment fusion disabled"
        return None
    # fusion-region planning (copr/fusion.py): the longest device-
    # compilable executor prefix becomes the fused program; an unfusable
    # suffix runs as a host tail over the region's output
    try:
        plan = plan_regions(dag, table, max_cut=max_cut)
    except DeviceUnsupported as e:
        req.mesh_reject_reason = str(e)
        return None
    if plan.tail and len(plan.dag.executors) == 1:
        req.mesh_reject_reason = (
            plan.split_reason or "fragment not device-eligible")
        return None
    if plan.tail and forced_label and plan.split_reason is None:
        plan.reason_label = forced_label
    an, tail = plan.an, plan.tail
    kind = "agg" if an.agg is not None else (
        "topn" if an.topn is not None else "filter")
    # hoist predicate constants into runtime parameter vectors
    # (serving/params.py): the fingerprint serializes slots, so
    # parameter-different queries reuse the same cached program
    from ..serving import hoist_conds

    hoisted = hoist_conds(an)
    mesh = get_mesh()
    S = mesh.size
    devs = mesh.ids
    _n_tiles, n_pad, Tl = _layout(table.base_rows, S, table=table)
    col_order = an.needed_cols()
    _observe_fragment(table, an)
    # the join operands: sorted build keys (and lookup payloads), padded
    # to a pow2 bucket so programs are shared across build sizes
    joins = _join_operands(req, an, mesh)
    if joins is None:
        req.mesh_reject_reason = "float lookup key"
        return None
    pargs, kpads = joins

    # column tensors load BEFORE the program lookup: the program is
    # specialized on each column's wire dtype / null pattern AND its
    # layout class (cold columns arrive as packed codes + a decode
    # operand).  Loads run on the transfer pool.
    datas, valids, col_layout, lvals, wire_sig = [], [], [], [], []
    for tier, entry in load_layout_columns(
            mesh, table, [an.scan.columns[ci] for ci in col_order]):
        if tier == "cold":
            datas.append(entry.packed)
            valids.append(None)
            col_layout.append((entry.bits, entry.cap, entry.kind))
            # the decode operand is already on the card: a cold hit
            # ships nothing over the link
            lvals.append(entry.operand)
            wire_sig.append(
                (f"cold{entry.bits}c{entry.cap}{entry.kind[0]}", True))
        else:
            d, v = entry
            datas.append(d)
            valids.append(v)
            col_layout.append(None)
            wire_sig.append((str(first_local(d).dtype), v is None))
    # computed-key remap operands ride the lvals tail AFTER the cold
    # dictionary operands (the ordering _build_sort_agg_core reads);
    # each mapping is uploaded once per base version (KeyRemap caches
    # its device copy, and the remap itself is cached per version)
    for r in (an.key_remaps or ()):
        if r is not None:
            lvals.append(ops.Shards(None if d is None else r.on_device(d)
                                    for d in mesh.devices))
    lvals = tuple(lvals)
    if not any(col_layout):
        col_layout = None

    fp = (_fingerprint(an, kind)
          + f"|mesh S={S} Tl={Tl} devs={devs}@{mesh.where} "
          + f"cols={col_order} "
          + f"kpads={kpads} wire={wire_sig}"
          + (f"|hp={len(hoisted[0])},{len(hoisted[1])}"
             if hoisted is not None else ""))
    if kind == "agg" and an.agg_mode == "sort":
        # the OUT budget shapes the program: a re-tuned TIDB_TPU_AGG_OUT
        # must not reuse a program built with the old budget
        fp += f"|aggout={_agg_out_budget()}"
    from ..trace import annotate, span

    annotate(device_ids=list(devs))
    fn = _COMPILED.get(fp)
    if fn is None:
        fn = _build_mesh_fn(an, kind, col_order, mesh, Tl,
                            col_layout=col_layout)
        _COMPILED.put(fp, fn)
        fn = _compile_labeled(fn, kind)
    else:
        with span("copr.compile", cache="hit", kind=kind):
            pass
    params = None
    if hoisted is not None:
        params = (to_positions(hoisted[0], mesh),
                  to_positions(hoisted[1], mesh))

    # one delta pass for the whole table
    deleted, inserted = table.delta_overlay(req.ts, 0, 1 << 62)
    del_mask = _del_mask(deleted, mesh, n_pad)

    from ..metrics import REGISTRY

    REGISTRY.inc("mesh_scans_total")

    # every requested range runs in the fused program: clip the bounds
    # host-side and hand them to its range slots
    bounds = []
    for kr in req.ranges:
        lo, hi = max(kr.start, 0), min(kr.end, table.base_rows)
        if lo < hi:
            bounds.append((lo, hi))

    if kind == "filter":
        return _stream_filter(req, table, an, fn, datas, valids, del_mask,
                              inserted, params, devs=devs, bounds=bounds,
                              tail=tail, dag=dag, lvals=lvals, pargs=pargs,
                              split_label=plan.reason_label)

    from ..lifecycle import dispatch_admission, scope_check
    from .chunking import chunk_bounds, chunk_budget_rows, observe_chunk

    chunks: List[Chunk] = []
    agg_accum = None
    topn_parts: List[Chunk] = []
    if bounds:
        # cancellation seam around the dispatch sequence
        scope_check()
        # deterministic mid-scan fault injection (chaos harness)
        FAILPOINTS.hit("mesh/device_error", kind=kind, device_ids=devs,
                       start=bounds[0][0], end=bounds[-1][1])
        FAILPOINTS.hit("mesh/hbm_oom", kind=kind, start=bounds[0][0],
                       end=bounds[-1][1])
        _check_membership_epoch()
        # interruptible chunked dispatch: the same program runs over
        # range sub-bounds sized to the tidb_tpu_dispatch_chunk_ms
        # budget, touching only each chunk's rows.  Partial states fold
        # across chunks: sort-agg chunks are root-merged partials, dense
        # agg accumulates via _merge_mesh_agg, TopN keeps every chunk's
        # candidates for the host's final pick
        # a float SUM/AVG takes the fixed budget: its chunk edges, and
        # the order the host adds the float partials in, then depend on
        # the statement alone, not on what the process ran before
        sub_bounds = chunk_bounds(
            bounds, ops.agree(chunk_budget_rows(
                kind, fixed=_has_float_sum(an)), op="chunk budget"),
            MESH_RANGE_SLOTS)
        n_chunks = len(sub_bounds)

        def _chunk_dispatch(ci, sub):
            if ci:
                # between-chunk seam: KILL/timeout/mem-quota/shutdown
                scope_check()
            FAILPOINTS.hit("copr/chunk_dispatch", kind=kind, chunk=ci,
                           total=n_chunks, start=sub[0][0],
                           end=sub[-1][1])
            rows = sum(hi - lo for lo, hi in sub)
            t0 = time.perf_counter()
            with span("copr.chunk", kind=kind, chunk=ci, rows=rows):
                # admission re-acquired per chunk: a depleted resource
                # group yields the device at every chunk boundary
                with dispatch_admission(DISPATCH_LOCK):
                    out = fn(datas, valids, del_mask, sub, lvals, pargs,
                             params)
            observe_chunk(kind, (time.perf_counter() - t0) * 1000.0, rows)
            return out

        if kind == "agg" and an.agg_mode == "sort":
            try:
                for ci, sub in enumerate(sub_bounds):
                    chunks.extend(_sort_agg_chunks(
                        _chunk_dispatch(ci, sub), table, an))
            except MeshAggOverflow as e:
                # data-dependent, by design: too many distinct groups
                # per dispatch.  Re-enter with the AGG PEELED to the
                # host tail (scan+selection stays on the card and
                # streams); earlier chunks' partials are discarded —
                # the peel re-runs the WHOLE region
                peeled = _peel_agg_rerun(storage, req, tid, dag, str(e))
                if peeled is not None:
                    return peeled
                req.mesh_reject_reason = str(e)
                return None
        elif kind == "agg":
            for ci, sub in enumerate(sub_bounds):
                gcount, results = _chunk_dispatch(ci, sub)
                agg_accum = _merge_mesh_agg(agg_accum, gcount, results,
                                            table, an)
        else:  # topn
            for ci, sub in enumerate(sub_bounds):
                handles = _chunk_dispatch(ci, sub)
                if len(handles):
                    topn_parts.append(table.gather_chunk(
                        list(an.scan.columns), handles))
        scope_check()  # post-dispatch seam: expired statements stop here

    # delta rows (committed inserts/updates) go through the CPU engine
    res = _delta_chunk(req, dag, an, inserted)
    if res is not None:
        (topn_parts if kind == "topn" else chunks).append(res)
    if agg_accum is not None:
        chunks.insert(0, te._device_agg_to_chunk(agg_accum, table, an))
    if topn_parts:
        from .cpu_engine import run_topn

        merged = topn_parts[0]
        for p in topn_parts[1:]:
            merged = merged.append(p)
        chunks = [run_topn(an.topn.order_by, an.topn.limit, merged)]

    from .engine import _merge_tail

    # the program completed: reset error streaks and close any
    # half-open breaker that just survived its probe
    DEVICE_HEALTH.record_success(devs)
    return [c for c in _merge_tail(dag, chunks) if c.num_rows > 0]


# max selected rows gathered host-side per streamed chunk (kv.Request
# Streaming / distsql stream.go: bounded-memory result consumption)
STREAM_ROWS = 1 << 16


def _stream_filter(req, table, an, fn, datas, valids, del_mask, inserted,
                   params=None, devs=(), bounds=(), tail=None, dag=None,
                   lvals=(), pargs=(), split_label=None):
    """Generator over a filter's result chunks: the fused mask runs on
    the card per dispatch chunk, then STREAM_ROWS-sized host gathers on
    demand (distsql/stream.go:33-124).  When the fusion splitter peeled
    a host tail off the fragment, each streamed chunk runs the tail
    through the CPU interpreter before it is yielded."""
    from ..lifecycle import dispatch_admission, scope_check
    from ..metrics import REGISTRY
    from ..trace import span
    from .chunking import chunk_bounds, chunk_budget_rows, observe_chunk
    from .fusion import note_split, run_tail

    remaining = an.limit
    if bounds:
        scope_check()  # seam before the dispatch sequence
        FAILPOINTS.hit("mesh/device_error", kind="filter",
                       device_ids=devs, start=bounds[0][0],
                       end=bounds[-1][1])
        FAILPOINTS.hit("mesh/hbm_oom", kind="filter", start=bounds[0][0],
                       end=bounds[-1][1])
        _check_membership_epoch()
        if tail:
            note_split(split_label, type(tail[0]).__name__)
        sub_bounds = chunk_bounds(
            bounds, ops.agree(chunk_budget_rows("filter"),
                              op="chunk budget"),
            MESH_RANGE_SLOTS)
        n_chunks = len(sub_bounds)
        for ci, sub in enumerate(sub_bounds):
            if ci:
                scope_check()  # between-chunk cancellation seam
            FAILPOINTS.hit("copr/chunk_dispatch", kind="filter",
                           chunk=ci, total=n_chunks, start=sub[0][0],
                           end=sub[-1][1])
            crows = sum(hi - lo for lo, hi in sub)
            t0 = time.perf_counter()
            with span("copr.chunk", kind="filter", chunk=ci, rows=crows):
                with dispatch_admission(DISPATCH_LOCK):
                    handles = fn(datas, valids, del_mask, sub, lvals,
                                 pargs, params)
            observe_chunk("filter", (time.perf_counter() - t0) * 1000.0,
                          crows)
            if remaining is not None:
                handles = handles[:remaining]
                remaining -= len(handles)
            for off in range(0, len(handles), STREAM_ROWS):
                scope_check()  # between streamed host gathers
                hsub = handles[off: off + STREAM_ROWS]
                chunk = table.gather_chunk(list(an.scan.columns), hsub)
                if an.proj_exprs is not None:
                    # dict-rewritten exprs expect coded strings; gather
                    # decodes, so project from the original projection IR
                    chunk = Chunk([
                        _eval_to_column(p, chunk)
                        for p in an.projection.exprs
                    ])
                if tail:
                    for tc in run_tail(dag, tail, [chunk], req.aux):
                        REGISTRY.inc("mesh_stream_chunks_total")
                        yield tc
                    continue
                REGISTRY.inc("mesh_stream_chunks_total")
                yield chunk
            if remaining is not None and remaining <= 0:
                break
    DEVICE_HEALTH.record_success(devs)
    res = _delta_chunk(req, None, an, inserted)
    if res is not None:
        yield res


def _delta_chunk(req, dag, an, inserted) -> Optional[Chunk]:
    """Committed delta rows in range, run through the CPU engine's DAG
    interpreter (shared by the materialized and streaming paths)."""
    if not inserted:
        return None
    in_range = {
        h: v for h, v in inserted.items()
        if any(kr.start <= h < kr.end for kr in req.ranges)
    }
    if not in_range:
        return None
    from .cpu_engine import run_dag_on_chunk

    if dag is None:
        dag = DAG.from_dict(req.dag)
    hs = sorted(in_range)
    cols = []
    for out_i, store_ci in enumerate(an.scan.columns):
        ft = an.scan.ftypes[out_i]
        vals = [in_range[h][store_ci] for h in hs]
        cols.append(Column.from_values(ft, vals))
    res = run_dag_on_chunk(dag, Chunk(cols), req.aux)
    return res if res.num_rows else None


def _eval_to_column(expr, chunk: Chunk) -> Column:
    v = expr.eval(chunk)
    return Column(expr.ftype, v.data, v.validity())


def _has_float_sum(an: _Analyzed) -> bool:
    """True when the fragment aggregates a float SUM or AVG, whose
    chunk partials the host adds in floating point."""
    return an.agg is not None and any(
        a.name in ("sum", "avg") and a.ftype.kind == TypeKind.FLOAT
        for a in an.agg.aggs)


def _mesh_over_partitions(storage, req: CopRequest, tids):
    """One program per partition store; empty/stale partitions
    contribute nothing; any ineligible non-empty partition rejects the
    whole request (the fan-out path then covers every partition)."""
    import dataclasses
    import itertools

    from ..lifecycle import scope_check

    outs = []
    for tid in tids:
        scope_check()  # between per-partition programs
        sub = dataclasses.replace(
            req, ranges=[kr for kr in req.ranges if kr.table_id == tid])
        table = storage.table(tid)
        if table.base_rows == 0 and not table.delta:
            continue
        out = try_run_mesh(storage, sub, table_id=tid)
        if out is None:
            req.mesh_reject_reason = (
                f"partition {tid}: "
                f"{getattr(sub, 'mesh_reject_reason', 'ineligible')}")
            return None
        outs.append(out)
    return itertools.chain.from_iterable(outs)


def _merge_mesh_agg(accum, gcount: np.ndarray, results, table, an: _Analyzed):
    """Fold one dispatch's final arrays into the accum layout
    `_device_agg_to_chunk` expects (chunks and ranges accumulate)."""
    if accum is None:
        accum = {"gcount": gcount.copy(), "states": []}
        first = True
    else:
        accum["gcount"] += gcount
        first = False
    for si, (tag, r) in enumerate(results):
        if first:
            accum["states"].append([tag, None, None])
        slot = accum["states"][si]
        if tag == "count":
            slot[1] = r if slot[1] is None else slot[1] + r
        elif tag == "sumcount":
            s, c = r
            if slot[1] is None:
                slot[1], slot[2] = s.copy(), c.copy()
            else:
                slot[1] += s
                slot[2] += c
        elif tag == "minmax":
            v, c = r
            if slot[1] is None:
                slot[1], slot[2] = v.copy(), c.copy()
            else:
                a = an.agg.aggs[si]
                pick = np.minimum if a.name == "min" else np.maximum
                have_old = slot[2] > 0
                have_new = c > 0
                both = have_old & have_new
                slot[1] = np.where(both, pick(slot[1], v),
                                   np.where(have_new, v, slot[1]))
                slot[2] += c
        elif tag == "argfirst":
            # r: per-group min global row index (sentinel >= base_rows when
            # the group is empty in this range)
            arg = an.agg.aggs[si].args[0]
            vals, valid = _gather_first_values(table, an, arg, r,
                                               an.num_groups)
            if slot[1] is None:
                slot[1], slot[2] = vals, valid
            else:
                need = ~slot[2] & valid
                slot[1] = np.where(need, vals, slot[1])
                slot[2] = slot[2] | valid
    return accum


def _gather_first_values(table, an: _Analyzed, arg, idx: np.ndarray, G: int):
    """(values[G], valid[G]) for first_row partials: gather only the store
    columns the argument reads, not the whole scan width."""
    from ..expr.expression import ColumnExpr

    have = idx < table.base_rows
    sel = np.flatnonzero(have)
    st = arg.ftype
    if st.kind == TypeKind.STRING:
        vals = np.empty(G, dtype=object)
        vals[:] = ""
    else:
        vals = np.zeros(G, dtype=st.np_dtype)
    valid = np.zeros(G, dtype=np.bool_)
    if len(sel):
        if isinstance(arg, ColumnExpr):
            rows = table.gather_chunk(
                [an.scan.columns[arg.index]], idx[sel]
            )
            col = rows.col(0)
            vals[sel] = col.data
            valid[sel] = col.validity()
        else:
            rows = table.gather_chunk(list(an.scan.columns), idx[sel])
            v = arg.eval(rows)
            vals[sel] = v.data
            valid[sel] = v.validity()
    return vals, valid

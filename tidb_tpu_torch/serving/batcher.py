"""Query micro-batching: N identical-shape statements, one device dispatch.

The continuous-batching idea from inference serving applied to SQL: a
point/agg statement's device cost is dominated by per-dispatch overhead
(launches + readback round trips), not by the arithmetic, so N
concurrent clients issuing the same SHAPE of statement should cost ~one
dispatch sequence, not N.  The batcher keys waiting statements by their
hoisted-parameter program fingerprint (serving/params.py) + table
version + ranges; the first arrival becomes the LEADER and holds a
bounded window (`tidb_tpu_microbatch_window_ms`, early-closed at
`tidb_tpu_microbatch_max` members) during which identical-fingerprint
arrivals join.  The leader then runs ONE batched per-tile program
(`torch_engine._tile_core`, batched) over the stacked parameter vectors,
reads each tile's results back in one copy, and scatters per-member
results back.

Lifecycle contract: every member waits scope-interruptibly — a KILLed
or deadline-expired member raises immediately and is masked out of the
batch (its slot still computes; nobody reads it).  The batch follows
the device-failure rules of every device rung (copr/parallel.py): an
open breaker fails it with `DeviceUnavailableError`, and a classified
device failure (OOM, an attributed card fault) trips the breaker,
evicts the device caches and re-runs the batch on the card.  A runtime
error that remains (chaos site `serving/batch_dispatch`) reaches every
live member's statement and counts on `serving_batch_errors_total`: as
everywhere in this package, a failing device program never hands its
statements to another rung unseen.  Only structural causes (an
ineligible DAG, `DeviceUnsupported`, an MVCC delta, too many tiles)
decline with None, before or instead of a batch.

Eligibility is strict so batched results equal solo runs: single
non-partitioned table, no MVCC delta in range, dense-mode aggregation or
bare filter, no joins/probes/projection/topn.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..metrics import REGISTRY
from ..store.fault import FAILPOINTS
from ..util_concurrency import make_lock, witness_wait_check

log = logging.getLogger("tidb_tpu.serving")

#: host gather slice for batched filter results (mirrors distsql streaming)
STREAM_ROWS = 1 << 16

#: largest table (in tiles) the batcher will serve: the batched path runs
#: a per-tile dispatch loop, which amortizes well for point/agg shapes
#: but must not pull huge analytic scans off the one-dispatch whole-table
#: program (and it bounds the leader's dispatch-loop length, which is the
#: batch's cancellation granularity)
import os as _os  # noqa: E402

MAX_BATCH_TILES = int(_os.environ.get("TIDB_TPU_MICROBATCH_MAX_TILES", "64"))


class _Member:
    """One waiting statement's slot in a batch."""

    __slots__ = ("pi", "pf", "scope", "event", "result", "error",
                 "batch_size", "wait_ns", "limit")

    def __init__(self, pi: np.ndarray, pf: np.ndarray, scope,
                 limit: Optional[int] = None):
        self.pi = pi
        self.pf = pf
        self.scope = scope
        self.limit = limit
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.batch_size = 1
        self.wait_ns = 0


class _Group:
    """One key's open batch.  Its queue state (`members`, `closed`)
    belongs to the BATCHER's mutex, not a lock of its own — declared
    for lint.concur's cross-object guard rule.  `full` is the lock-free
    leader-wakeup Event: reads/waits on it never need the mutex."""

    __slots__ = ("members", "closed", "full")
    _guarded_by_ = "serving.batcher:MicroBatcher._mu"

    def __init__(self):
        self.members: List[_Member] = []
        self.closed = False
        self.full = threading.Event()


class MicroBatcher:
    """Per-fingerprint batching queues.  The leader (first arrival for a
    key) owns the window and the dispatch; followers park on their slot
    event with scope-interruptible waits."""

    def __init__(self):
        self._mu = make_lock("serving.batcher:MicroBatcher._mu")
        self._groups: Dict[tuple, _Group] = {}

    def submit(self, key: tuple, member: _Member, window_s: float,
               max_batch: int, runner):
        """Join (or open) the batch for `key`; returns the member's
        result or raises its error.  `runner(live_members)` is invoked
        once per batch by the leader and must fill each live member's
        `result`."""
        t0 = time.perf_counter_ns()
        with self._mu:
            g = self._groups.get(key)
            if g is not None and not g.closed \
                    and len(g.members) < max_batch:
                g.members.append(member)
                if len(g.members) >= max_batch:
                    g.full.set()
                leader = False
            else:
                g = _Group()
                g.members.append(member)
                self._groups[key] = g
                leader = True
        if not leader:
            return self._await(member, t0)
        # ---- leader: hold the window, then dispatch -------------------
        # the wait wakes on batch-full, the window deadline, OR the
        # leader's own cancel/deadline (a KILLed leader must not sit out
        # the window; it closes the group early and is masked below)
        wait_s = window_s
        rem = member.scope.remaining_s()
        if rem is not None:
            wait_s = min(wait_s, rem)
        deadline = time.monotonic() + max(wait_s, 0.0)
        while not g.full.is_set() and not member.scope.cancelled():
            left = deadline - time.monotonic()
            if left <= 0:
                break
            self._window_wait(g, min(left, 0.02))
        with self._mu:
            g.closed = True
            if self._groups.get(key) is g:
                del self._groups[key]
            members = list(g.members)
        # a cancelled member is masked out of the dispatch: it never
        # blocks the batch, and its own wait raises its scope error
        live = [m for m in members if not m.scope.cancelled()]
        now = time.perf_counter_ns()
        for m in members:
            m.batch_size = len(members)
            m.wait_ns = now - t0
        try:
            if live:
                REGISTRY.inc("serving_batches_total")
                REGISTRY.inc("serving_batched_stmts_total", len(live))
                REGISTRY.observe("serving_batch_size", len(live))
                runner(live)
        except BaseException as e:  # noqa: BLE001 — scattered to members
            REGISTRY.inc("serving_batch_errors_total")
            for m in live:
                if m.result is None and m.error is None:
                    m.error = e
        finally:
            for m in members:
                m.event.set()
        return self._await(member, t0)

    def _window_wait(self, g: "_Group", timeout_s: float):
        """The leader's batching-window park: the registry mutex (or any
        ranked lock) held here would stall every statement sharing the
        lock for a full window — the wait-witness trips instead."""
        witness_wait_check("MicroBatcher group.full.wait")
        g.full.wait(timeout_s)

    def _member_wait(self, member: "_Member") -> bool:
        """One poll tick of a parked member (scope-interruptible)."""
        witness_wait_check("MicroBatcher member.event.wait")
        return member.event.wait(0.02)

    def _await(self, member: _Member, t0: int):
        # scope-interruptible park: a killed/deadline member unblocks at
        # the next poll tick instead of waiting out the batch
        while not self._member_wait(member):
            if member.scope.cancelled():
                member.wait_ns = time.perf_counter_ns() - t0
                raise member.scope.error()
        member.scope.check()
        if member.error is not None:
            raise member.error
        return member.result


BATCHER = MicroBatcher()


def _batch_params(live: List[_Member], b_pad: int):
    """Stack per-member parameter vectors to [B_pad, P]; padded slots
    replicate member 0 (their outputs are computed and discarded — the
    pow2 pad keeps the batched program's shapes per batch CLASS)."""
    rows_i = [m.pi for m in live] + [live[0].pi] * (b_pad - len(live))
    rows_f = [m.pf for m in live] + [live[0].pf] * (b_pad - len(live))
    return np.stack(rows_i), np.stack(rows_f)


from ..copr.cache import ProgramCache  # noqa: E402

_BATCHED = ProgramCache("microbatch")


def _get_batched(fp: str, an, kind: str, col_order):
    from ..copr import torch_engine as te

    fn = _BATCHED.get(fp)
    if fn is None:
        fn = te._tile_core(an, kind, col_order, with_params=True,
                           batched=True)
        _BATCHED.put(fp, fn)
    return fn


def _run_batch(ctx: dict, live: List[_Member]):
    """Leader-side batched execution under the device-failure rules of
    every device rung: an open breaker raises `DeviceUnavailableError`;
    a classified device failure (an OOM, an attributed card fault) is
    recorded on the breaker, evicts the device caches and re-runs the
    whole batch on the card, up to `MAX_MESH_ATTEMPTS` runs; then, and
    for any unclassified error at once, the error reaches every
    member."""
    from ..coord import CoordEpochMismatch
    from ..copr.parallel import (MAX_MESH_ATTEMPTS, _check_breaker,
                                 _handle_mesh_failure, get_mesh)
    from ..copr.torch_eval import DeviceUnsupported

    _check_breaker()
    attempts = 0
    while True:
        try:
            # the mesh (and the membership epoch its dispatches check)
            # over the positions the breakers admit
            get_mesh()
            return _run_batch_once(ctx, live)
        except DeviceUnsupported:
            raise  # structural: try_run_batched declines with None
        except CoordEpochMismatch:
            # membership moved: rebuild the mesh and re-run the batch,
            # never a breaker trip
            if attempts + 1 >= MAX_MESH_ATTEMPTS:
                raise
            attempts += 1
        except BaseException as e:
            if not _handle_mesh_failure(None, e, attempts):
                raise
            _check_breaker()
            attempts += 1


def _run_batch_once(ctx: dict, live: List[_Member]):
    """One run of the batch: one batched device program per tile over
    the stacked parameter vectors, one readback per tile for the whole
    batch; each slot's result is set only once every tile completed."""
    from . import shape_bucket
    from ..copr import torch_engine as te
    from ..copr.chunking import observe_chunk
    from ..copr.device_health import DEVICE_HEALTH
    from ..copr.parallel import _check_membership_epoch, to_device
    from ..lifecycle import chunk_admission
    from ..trace import span

    table = ctx["table"]
    an = ctx["an"]
    kind = ctx["kind"]
    col_order = ctx["col_order"]
    B = len(live)
    b_pad = shape_bucket(B)
    PI, PF = _batch_params(live, b_pad)
    fn = _get_batched(ctx["fp"], an, kind, col_order)
    tags = te._agg_tags(an.agg) if kind == "agg" else None
    accums: List[Optional[dict]] = [None] * B
    handles: List[List[np.ndarray]] = [[] for _ in range(B)]
    counts = [0] * B
    # per-member LIMITs: the batch key buckets the limit CLASS (pow2) so
    # `LIMIT 5` and `LIMIT 7` filters share a batch; each member's exact
    # limit applies to its own slot here and at result-slice time
    limits = [m.limit for m in live]
    TILE = te.TILE
    devices = te._tile_devices()
    params: dict = {}
    used_ids = set()

    done = False
    for start, end in ctx["ranges"]:
        if done:
            break
        for tile_start in range((start // TILE) * TILE, end, TILE):
            t0 = max(tile_start, start)
            t1 = min(tile_start + TILE, end)
            if t0 >= t1:
                continue
            # host seam between dispatches: if EVERY member is dead the
            # batch aborts (each member raises its own scope error);
            # individual dead members just stop being waited on
            if all(m.scope.cancelled() for m in live):
                return
            tile_idx = tile_start // TILE
            card = devices[tile_idx % len(devices)]
            dev = te._card_device(card)
            used_ids.add(card.id)
            datas, valids = [], []
            for ci in col_order:
                d, v = te.DEVICE_CACHE.get_tile(
                    table, an.scan.columns[ci], tile_idx, tile_start,
                    min(tile_start + TILE, table.base_rows), dev,
                    card.id)
                datas.append(d)
                valids.append(v)
            if dev not in params:
                params[dev] = (to_device(PI, dev), to_device(PF, dev))
            lo = t0 - tile_start
            hi = t1 - tile_start
            del_mask = te._all_true(dev)  # batch eligibility => no deletes
            FAILPOINTS.hit("serving/batch_dispatch", size=B, tile=tile_idx)
            # membership guard: a lost member between the mesh build and
            # this dispatch raises CoordEpochMismatch out of the batch;
            # `_run_batch` rebuilds the mesh and re-runs the batch
            _check_membership_epoch()
            #
            # resource-group admission: the leader thread carries its own
            # statement scope, so the batch's device time is charged to
            # the LEADER's group — followers ride free (matching TiDB,
            # where the runaway/RU ledger bills the session that issued
            # the physical request)
            bt0 = time.perf_counter()
            with span("copr.device.execute", batch=B, tile=tile_idx):
                with chunk_admission():
                    out = fn(datas, valids, lo, hi, del_mask, *params[dev])
            observe_chunk("batch", (time.perf_counter() - bt0) * 1000.0,
                          int(t1 - t0))
            if kind == "agg":
                gcount, results = out
                with span("copr.readback") as rsp:
                    host = te._np_batch([gcount] + te.agg_leaves(results))
                    rsp.set(bytes=sum(h.nbytes for h in host))
                gh, leaves = host[0], host[1:]
                for b in range(B):
                    accums[b] = te._merge_device_agg(
                        accums[b], gh[b],
                        te.agg_states(tags, results, [x[b] for x in leaves]),
                        table, an, tile_start)
            else:  # filter (no projection by eligibility)
                m_out, _outs = out
                with span("copr.readback") as rsp:
                    # (member, row) pairs of the selected rows, member-major
                    hits = te._np_tree(torch.nonzero(m_out[:B]))
                    rsp.set(bytes=hits.nbytes)
                cuts = np.searchsorted(hits[:, 0], np.arange(B + 1))
                for b in range(B):
                    sel = hits[cuts[b]:cuts[b + 1], 1]
                    if limits[b] is not None:
                        sel = sel[: max(limits[b] - counts[b], 0)]
                    if len(sel):
                        handles[b].append(sel + tile_start)
                        counts[b] += len(sel)
                if all(lm is not None and c >= lm
                       for lm, c in zip(limits, counts)):
                    done = True
                    break

    # every tile program completed: reset the cards' error streaks
    DEVICE_HEALTH.record_success(sorted(used_ids))
    for b, m in enumerate(live):
        if kind == "agg":
            if accums[b] is None:
                m.result = ("agg", [])
            else:
                m.result = ("agg",
                            [te._device_agg_to_chunk(accums[b], table, an)])
        else:
            hs = (np.concatenate(handles[b]) if handles[b]
                  else np.zeros(0, dtype=np.int64))
            m.result = ("filter", hs)


def try_run_batched(storage, req):
    """Serve `req` through the micro-batcher; None when the request is
    structurally ineligible (callers fall through to the whole-table /
    per-region rungs).  Lifecycle errors (kill/timeout/shutdown) and
    runtime errors of the batched device program propagate to the
    statement."""
    from . import effective_window_s, hoist_conds, microbatch_max
    from .. import ops
    from ..copr import torch_engine as te
    from ..copr.ir import DAG
    from ..copr.torch_eval import DeviceUnsupported
    from ..lifecycle import current_scope
    from ..trace import span

    dag = DAG.from_dict(req.dag)
    tid = dag.scan.table_id
    if not req.ranges or any(kr.table_id != tid for kr in req.ranges):
        return None  # partitioned fan-out: solo paths handle it
    if ops.process_count() > 1:
        # a batch's tiles run on this process alone: across processes
        # the statements' collectives must stay in one order
        return None
    try:
        table = storage.table(tid)
    except Exception:
        return None
    if table.base_rows == 0 or table.base_ts > req.ts:
        return None
    if (table.base_rows + te.TILE - 1) // te.TILE > MAX_BATCH_TILES:
        return None  # big analytic scans stay on the one-dispatch program
    try:
        an = te._Analyzed(dag, table)
    except DeviceUnsupported:
        return None
    if an.probes or an.lookups or an.topn is not None:
        return None
    kind = "agg" if an.agg is not None else "filter"
    if kind == "agg" and an.agg_mode != "dense":
        return None
    if kind == "filter" and an.proj_exprs is not None:
        return None
    deleted, inserted = table.delta_overlay(req.ts, 0, 1 << 62)
    if deleted or inserted:
        # members read at different TSOs; only delta-free tables make
        # the base scan ts-independent (and thus batchable)
        return None
    col_order = an.needed_cols()
    hoisted = hoist_conds(an)
    pi, pf = hoisted if hoisted is not None else (
        np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64))
    # the DAG fingerprint serializes columns by SCAN-OUTPUT index + type
    # kind (fine for program identity: the program reads whatever arrays
    # it is fed) — but batch members SHARE the leader's loaded arrays,
    # so the batch key must also pin which STORE columns those indices
    # resolve to, or `where k = ?` and `where g = ?` would merge
    store_cols = tuple(an.scan.columns[ci] for ci in col_order)
    fp = (te._fingerprint(an, kind)
          + f"|cols={col_order}|store={store_cols}"
          + f"|mb|hp={len(pi)},{len(pf)}")
    ranges = tuple(
        (max(kr.start, 0), min(kr.end, table.base_rows))
        for kr in req.ranges
    )
    # LIMIT values hoist out of the batch key into per-member slots: the
    # key carries only the pow2 limit CLASS, so parameter-different
    # LIMITs share one batch and one batched program
    from . import shape_bucket as _bucket

    limit_class = None if an.limit is None else _bucket(an.limit, floor=16)
    key = (fp, table.store_uid, table.base_version, ranges, limit_class,
           te.TILE)
    member = _Member(pi, pf, current_scope(), limit=an.limit)
    ctx = {"table": table, "an": an, "kind": kind,
           "col_order": col_order, "fp": fp, "ranges": ranges}
    with span("serving.batch", kind=kind) as sp:
        try:
            res = BATCHER.submit(key, member, effective_window_s(),
                                 microbatch_max(),
                                 lambda live: _run_batch(ctx, live))
        except DeviceUnsupported as e:
            # structural: the batched program cannot run this shape
            log.info("micro-batch declined: %s", e)
            sp.set(batch=member.batch_size, outcome="unsupported")
            return None
        except BaseException:
            sp.set(batch=member.batch_size, outcome="error")
            raise
        finally:
            REGISTRY.observe("serving_batch_wait_ms", member.wait_ns / 1e6)
        sp.set(batch=member.batch_size,
               wait_ms=round(member.wait_ns / 1e6, 3))
    if res[0] == "agg":
        return [c for c in res[1] if c.num_rows > 0]
    hs = res[1]
    if an.limit is not None:
        hs = hs[: an.limit]
    chunks = []
    for off in range(0, len(hs), STREAM_ROWS):
        c = table.gather_chunk(list(an.scan.columns),
                               hs[off: off + STREAM_ROWS])
        if c.num_rows:
            chunks.append(c)
    return chunks

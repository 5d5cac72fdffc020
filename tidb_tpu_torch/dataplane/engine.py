"""Dataplane dispatch: scatter a coprocessor request over partition
primaries, gather per-partition results in handle order.

The dispatch contract mirrors the mesh engine's: `try_run_dataplane`
returns chunks or None, and None ALWAYS has a correct fallback — every
host still holds the full pre-shard base table, so the per-region local
path answers identically (tests that must prove cross-host execution
assert the `dataplane_queries_total` delta, not just row parity).

Epoch discipline, end to end:

  1. `sync()` re-derives the partition map from the CURRENT broadcast
     (re-sharding if the epoch moved) before any fragment is built.
  2. Every remote fragment carries the map's epoch; the owner re-checks
     against ITS broadcast and answers a typed epoch error on skew.
  3. After the gather, the epoch is re-checked once more — results
     that straddle a membership change are discarded and the whole
     dispatch re-runs under the new map (`PartitionMapMismatch` is
     retriable exactly like `CoordEpochMismatch`).

Failover ladder: each partition routes to its PRIMARY even
when a replica is materialized locally — locality must not hide the
exchange.  When the primary fails, times out against the per-fragment
deadline, or answers a transient error, the dispatcher walks the
replica chain (an equal-jitter `Backoffer` de-synchronizes the
re-probes): next replica — which may be THIS host serving its own warm
replica — and, with the chain exhausted, a local bypass over the
pre-shard base in global coordinates.  A fragment is never lost to one
sick peer.

Hedging: after `TIDB_TPU_DATAPLANE_HEDGE_MS` without an answer the
fragment is re-sent to the next replica; first answer wins, the loser
is called off.  Requests carry a dedup key, so a hedged pair landing on
one server never double-executes, and only the WINNING call's bytes
meter into `dataplane_exchange_bytes_total` — a hedge can waste work
(counted separately) but never double-counts the query's exchange.

Remote fragments are charged to the statement's resource group through
the same `chunk_admission` seam the per-tile device loop uses — an
exchange is a dispatch, fleet quotas must see it.
"""

from __future__ import annotations

import itertools
import logging
import os
import queue
import threading
from typing import Dict, List, Optional, Tuple

from ..errors import TiDBTPUError
from ..metrics import REGISTRY
from .partition import PartitionMap, PartitionMapMismatch
from .rpc import (DataplaneRPCError, DataplaneServer, FragmentIneligible,
                  PeerDeadlineExceeded, PeerWaitCancelled, POOL,
                  default_frag_timeout_s, run_on_card)
from .shard import Dataplane, ShardedTable, partition_tid

log = logging.getLogger("tidb_tpu.dataplane")

#: id(storage) -> (Dataplane, Optional[DataplaneServer])
_ACTIVE: Dict[int, Tuple[Dataplane, Optional[DataplaneServer]]] = {}

#: hedge delay in ms; 0 (default) disables hedged reads
_HEDGE_ENV = "TIDB_TPU_DATAPLANE_HEDGE_MS"

#: per-process fragment sequence — the dedup key must differ across
#: dispatches (retries at a NEW epoch re-execute) but be SHARED by the
#: two halves of a hedged pair (same logical fragment)
_frag_seq = itertools.count(1)


class _PeerLost(RuntimeError):
    """A fragment owner went unreachable mid-dispatch (likely a host
    loss the lease hasn't expired yet) — fall back locally; the next
    epoch bump re-shards."""


def hedge_delay_s() -> float:
    try:
        return max(float(os.environ.get(_HEDGE_ENV, "0")), 0.0) / 1000.0
    except ValueError:
        return 0.0


def activate_dataplane(storage, plane=None, pid: Optional[int] = None,
                       data_dir: Optional[str] = None,
                       n_parts: Optional[int] = None,
                       rf: Optional[int] = None,
                       lazy_replicas: Optional[bool] = None,
                       serve: bool = True) -> Dataplane:
    """Stand up the data plane on this host: shard manager + fragment
    server, with the server's address advertised through the membership
    broadcast so peers can find us without a second discovery system."""
    from ..coord import get_plane

    plane = plane or get_plane()
    if pid is None:
        pid = getattr(plane, "pid", 0)
    dp = Dataplane(storage, plane, pid, data_dir=data_dir,
                   n_parts=n_parts, rf=rf, lazy_replicas=lazy_replicas)
    server = None
    if serve:
        server = DataplaneServer(storage, dp)
        plane.advertise_addr(server.addr)
    _ACTIVE[id(storage)] = (dp, server)
    return dp


def get_dataplane(storage) -> Optional[Dataplane]:
    entry = _ACTIVE.get(id(storage))
    return entry[0] if entry else None


def deactivate_dataplane(storage):
    entry = _ACTIVE.pop(id(storage), None)
    if entry is None:
        return
    dp, server = entry
    if server is not None:
        server.close()
    dp.close()
    if not _ACTIVE:
        # last plane down: nothing left to exchange with — reclaim every
        # pooled socket so tests (and a clean shutdown) leak no fds
        POOL.close_all()


def try_run_dataplane(storage, req) -> Optional[List]:
    """Serve `req` over the sharded data plane, or None when the
    request is not dataplane-eligible (unsharded table, stale shard
    snapshot, runtime payloads) or on any mid-flight failure — the
    caller's local path is always a correct fallback, and every such
    fallback of a sharded table counts on `dataplane_bypass_total`."""
    entry = _ACTIVE.get(id(storage))
    if entry is None:
        return None
    dp, _server = entry
    tids = {kr.table_id for kr in req.ranges}
    if len(tids) != 1:
        return None
    tid = tids.pop()
    st = dp.lookup(tid)
    if st is None:
        return None
    if req.aux:
        # runtime probe payloads (index-join inners) stay on the local
        # per-region path — shipping them per partition would multiply
        # the exchange for no partitioning win
        REGISTRY.inc("dataplane_bypass_total")
        return None
    if not storage.has_table(tid):
        return None
    src = storage.table(tid)
    if src.delta or src.base_version != st.base_version:
        # committed DML / bulk load since the shard snapshot: partitions
        # no longer cover the table — bypass until re-sharded
        REGISTRY.inc("dataplane_bypass_total")
        return None
    for attempt in range(3):
        try:
            pmap = dp.sync()
            if pmap is None:
                # broadcast not formed yet
                REGISTRY.inc("dataplane_bypass_total")
                return None
            # member-leave hygiene: drop pooled sockets to peers no
            # longer in the broadcast (a dead peer must not hold fds)
            POOL.prune(dp.plane.view().addrs.values())
            out = _scatter_gather(dp, st, pmap, req)
            REGISTRY.inc("dataplane_queries_total")
            return out
        except PartitionMapMismatch:
            # membership moved mid-dispatch: rebuild the map (sync()
            # re-shards at the top of the loop) and re-run — the
            # CoordEpochMismatch retry ladder, one layer up
            REGISTRY.inc("dataplane_epoch_retries_total")
            continue
        except _PeerLost:
            REGISTRY.inc("dataplane_peer_lost_total")
            REGISTRY.inc("dataplane_bypass_total")
            return None
        except FragmentIneligible:
            # the card's program declines a fragment: the statement
            # takes the local path whole (on the card as well)
            REGISTRY.inc("dataplane_bypass_total")
            return None
        except TiDBTPUError:
            raise  # semantic errors (kill, quota) surface unchanged
        except Exception:
            REGISTRY.inc("dataplane_errors_total")
            REGISTRY.inc("dataplane_bypass_total")
            log.warning("dataplane dispatch failed; falling back to the "
                        "local path", exc_info=True)
            return None
    REGISTRY.inc("dataplane_errors_total")
    REGISTRY.inc("dataplane_bypass_total")
    return None


def _frag_deadline_s(scope) -> float:
    """Per-fragment deadline: the scope's remaining budget, capped by
    `TIDB_TPU_DATAPLANE_FRAG_TIMEOUT_S` — a stalled peer costs at most
    one rung's deadline, never a statement-length hang."""
    cap = default_frag_timeout_s()
    rem = scope.remaining_s()
    if rem is None:
        return cap
    return max(min(rem, cap), 0.05)


def _exec_local(dp: Dataplane, ptid: int, clips, req) -> List:
    """Run one partition's clips (or the pre-shard base's, for the
    failover bypass) on this host's card (`run_on_card`)."""
    from ..store.kv import CopRequest, KeyRange

    sub = CopRequest(
        dag=req.dag,
        ranges=[KeyRange(ptid, s, e) for s, e in clips],
        ts=req.ts, concurrency=1, keep_order=True,
        engine=req.engine, backoff_budget_ms=req.backoff_budget_ms)
    return run_on_card(dp.storage, sub)


def _remote_once(addr: str, req, ranges, epoch: int, frag: str,
                 deadline_s: float, cancel) -> Tuple[dict, int]:
    conn = POOL.acquire(addr)
    try:
        return conn.exec_fragment(req.dag, ranges, req.ts, epoch,
                                  req.engine, frag=frag,
                                  deadline_s=deadline_s, cancel=cancel)
    finally:
        POOL.release(conn)


def _remote_maybe_hedged(addr: str, hedge_addr: Optional[str],
                         hedge_s: float, req, ranges, epoch: int,
                         frag: str, deadline_s: float, scope
                         ) -> Tuple[dict, int, str]:
    """One fragment against `addr`, optionally re-sent to `hedge_addr`
    after `hedge_s` without an answer.  First answer wins; the loser is
    called off (its sliced wait observes the cancel within one poll) and
    any work it completed anyway is metered as WASTED, never as the
    query's exchange.  Returns (response, bytes, winning addr)."""
    if hedge_addr is None or hedge_s <= 0:
        resp, nb = _remote_once(addr, req, ranges, epoch, frag,
                                deadline_s, scope.cancelled)
        return resp, nb, addr
    answers: queue.Queue = queue.Queue()
    called_off = threading.Event()

    def cancel() -> bool:
        return called_off.is_set() or scope.cancelled()

    def attempt(a: str):
        try:
            resp, nb = _remote_once(a, req, ranges, epoch, frag,
                                    deadline_s, cancel)
            answers.put(("ok", a, resp, nb))
        except BaseException as e:  # noqa: BLE001 - relayed to waiter
            answers.put(("exc", a, e, 0))

    threads = [threading.Thread(target=attempt, args=(addr,),
                                name="dataplane-frag", daemon=True)]
    threads[0].start()
    try:
        first = answers.get(timeout=hedge_s)
    except queue.Empty:
        REGISTRY.inc("dataplane_hedged_fragments_total")
        t2 = threading.Thread(target=attempt, args=(hedge_addr,),
                              name="dataplane-frag-hedge", daemon=True)
        t2.start()
        threads.append(t2)
        try:
            first = answers.get(timeout=deadline_s + 2.0)
        except queue.Empty:  # both attempts wedged past their deadline
            called_off.set()
            for t in threads:
                t.join(timeout=2.0)
            raise PeerDeadlineExceeded(
                "hedged fragment pair exceeded deadline") from None
    called_off.set()
    for t in threads:
        t.join(timeout=2.0)
    second = None
    try:
        second = answers.get_nowait()
    except queue.Empty:
        pass
    # prefer a transport-level success; the first such answer wins
    ranked = [r for r in (first, second) if r is not None]
    winners = [r for r in ranked if r[0] == "ok"]
    if not winners:
        raise first[2]
    win = winners[0]
    for r in ranked:
        if r is not win and r[0] == "ok":
            REGISTRY.inc("dataplane_hedge_wasted_bytes_total", r[3])
    if win[1] != addr:
        REGISTRY.inc("dataplane_hedge_wins_total")
    return win[2], win[3], win[1]


def _serve_partition(dp: Dataplane, st: ShardedTable, pmap: PartitionMap,
                     view, req, p: int, clips, loaded, bo, scope) -> List:
    """The failover ladder for one partition: walk the replica chain
    (primary first; a rung naming THIS host serves its warm replica),
    backing off between failed rungs, and fall through to a local
    bypass over the pre-shard base when every replica is out."""
    from ..distsql.backoff import BackoffBudgetExceeded
    from ..lifecycle import chunk_admission

    frag = "%d:%d:%d:%d:%d" % (dp.pid, next(_frag_seq), st.table_id, p,
                               pmap.epoch)
    chain = pmap.chain(p)
    hedge_s = hedge_delay_s()
    for rung, pid in enumerate(chain):
        scope.check()
        if pid == dp.pid:
            ptid = loaded.get(p)
            if ptid is None:
                # lazy replica (or a promotion this snapshot missed):
                # first touch materializes it
                ptid = dp.ensure_replica(st.table_id, p)
            if ptid is None:
                continue
            if rung > 0:
                REGISTRY.inc("dataplane_replica_reads_total")
            chunks = _exec_local(dp, ptid, clips, req)
            REGISTRY.inc("dataplane_local_fragments_total")
            return chunks
        addr = view.addrs.get(pid)
        if not addr:
            continue
        hedge_addr = None
        if hedge_s > 0:
            for nxt in chain[rung + 1:]:
                if nxt == dp.pid:
                    continue
                cand = view.addrs.get(nxt)
                if cand and cand != addr:
                    hedge_addr = cand
                    break
        ptid = partition_tid(st.table_id, p)
        ranges = [(ptid, s, e) for s, e in clips]
        try:
            with chunk_admission():
                resp, nb, _winner = _remote_maybe_hedged(
                    addr, hedge_addr, hedge_s, req, ranges, pmap.epoch,
                    frag, _frag_deadline_s(scope), scope)
        except PeerWaitCancelled:
            # the bounded-wait contract: a KILL mid-stall surfaces the
            # scope's typed error within one poll slice
            scope.check()
            continue  # called off but scope alive (hedge loser path)
        except (ConnectionError, OSError, PeerDeadlineExceeded,
                DataplaneRPCError) as e:
            REGISTRY.inc("dataplane_failovers_total")
            if rung + 1 < len(chain):
                try:
                    bo.backoff("peer_error", e)
                except BackoffBudgetExceeded:
                    break
            continue
        err = resp.get("err")
        if err == "ineligible":
            raise FragmentIneligible(resp.get("msg", err))
        if err == "epoch":
            raise PartitionMapMismatch(resp.get("built_at"),
                                       resp.get("current"))
        if err:
            # transient exec failure (chaos, overload): the bytes moved
            # bought nothing — meter as waste, hop to the next rung
            REGISTRY.inc("dataplane_rpc_wasted_bytes_total", nb)
            REGISTRY.inc("dataplane_failovers_total")
            if rung + 1 < len(chain):
                try:
                    bo.backoff("peer_error", DataplaneRPCError(
                        f"pid {pid} fragment failed: "
                        f"{resp.get('msg', err)}"))
                except BackoffBudgetExceeded:
                    break
            continue
        REGISTRY.inc("dataplane_exchange_bytes_total", nb)
        return resp.get("chunks") or []
    # every replica is out: the pre-shard base (which every host keeps —
    # it is what fallback parity is measured against) answers in global
    # coordinates, correct at ANY epoch
    scope.check()
    REGISTRY.inc("dataplane_failover_bypass_total")
    lo, _hi = st.part_range(p)
    return _exec_local(
        dp, st.table_id, [(lo + s, lo + e) for s, e in clips], req)


def _scatter_gather(dp: Dataplane, st: ShardedTable, pmap: PartitionMap,
                    req) -> List:
    """Fan the request's ranges over partition primaries; gather chunks
    in partition (== handle) order so keep_order consumers and
    per-region partial-agg merging behave exactly as on the region
    path."""
    from ..distsql.backoff import Backoffer
    from ..lifecycle import current_scope

    # partition -> list of LOCAL (start, end) clips within the partition
    frags: Dict[int, List[Tuple[int, int]]] = {}
    for kr in req.ranges:
        for p in range(st.n_parts):
            lo, hi = st.part_range(p)
            s, e = max(kr.start, lo), min(kr.end, hi)
            if s < e:
                frags.setdefault(p, []).append((s - lo, e - lo))
    if not frags:
        return []

    view = dp.plane.view()
    pmap.check(view.epoch)
    scope = current_scope()
    bo = (Backoffer(req.backoff_budget_ms, scope=scope)
          if req.backoff_budget_ms else Backoffer(scope=scope))
    results: Dict[int, List] = {}
    with dp._mu:
        loaded = dict(st.loaded)
    for p in sorted(frags):
        results[p] = _serve_partition(dp, st, pmap, view, req, p,
                                      frags[p], loaded, bo, scope)

    # the post-gather epoch re-check: results that straddle a
    # membership change are discarded wholesale (partials from two maps
    # must never be merged)
    pmap.check(dp.plane.view().epoch)
    out: List = []
    for p in sorted(results):
        out.extend(results[p])
        REGISTRY.inc("dataplane_partitions_scanned_total")
    return out

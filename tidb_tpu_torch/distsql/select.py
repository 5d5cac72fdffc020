"""distsql: the distributed-query layer between root executors and the
pushdown boundary.

Reference: distsql/request_builder.go:34 (RequestBuilder), distsql/distsql.go:33
(Select), distsql/select_result.go:43 (SelectResult.Next) and the copIterator
worker pool (store/tikv/coprocessor.go:391-560).  The data-parallel scan
fan-out: key ranges split per region into tasks, executed by a bounded worker
pool, results streamed back with optional order preservation (KeepOrder /
sendRate) — DP over storage shards.

Resilience (region_request.go:74-161 + backoff.go analogs):
- per-task retry with typed exponential backoff (Backoffer);
- a device failure at *runtime* (not just DAG-analysis time) retries the
  failed region task on the CPU engine, so one sick chip degrades one
  region's throughput instead of killing the query;
- close() actually cancels: a stop event is honored by queued tasks and
  producer puts, and unstarted futures are cancelled (the reference's
  copIterator Close + killed-flag behavior).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

from ..chunk import Chunk
from ..copr.ir import DAG
from ..errors import TiDBTPUError
from ..store.fault import FAILPOINTS
from ..store.kv import CopRequest, KeyRange
from .backoff import DEFAULT_BUDGET_MS, Backoffer


@dataclass
class RequestBuilder:
    """Fluent builder mirroring distsql.RequestBuilder."""

    dag: Optional[dict] = None
    ranges: List[KeyRange] = field(default_factory=list)
    ts: int = 0
    concurrency: int = 8
    keep_order: bool = False
    streaming: bool = False
    engine: str = "tpu"
    backoff_budget_ms: int = DEFAULT_BUDGET_MS

    def set_dag(self, dag: DAG) -> "RequestBuilder":
        self.dag = dag.to_dict()
        return self

    def set_ranges(self, ranges: List[KeyRange]) -> "RequestBuilder":
        self.ranges = ranges
        return self

    def set_ts(self, ts: int) -> "RequestBuilder":
        self.ts = ts
        return self

    def set_concurrency(self, n: int) -> "RequestBuilder":
        self.concurrency = max(1, n)
        return self

    def set_keep_order(self, keep: bool) -> "RequestBuilder":
        self.keep_order = keep
        return self

    def set_engine(self, engine: str) -> "RequestBuilder":
        self.engine = engine
        return self

    def set_backoff_budget(self, budget_ms: int) -> "RequestBuilder":
        self.backoff_budget_ms = max(0, budget_ms)
        return self

    def build(self) -> CopRequest:
        assert self.dag is not None and self.ranges, "incomplete request"
        return CopRequest(
            dag=self.dag, ranges=self.ranges, ts=self.ts,
            concurrency=self.concurrency, keep_order=self.keep_order,
            streaming=self.streaming, engine=self.engine,
            backoff_budget_ms=self.backoff_budget_ms,
        )


_DONE = object()


class _Closed(Exception):
    """Internal: the consumer closed the result; abandon production."""


class SelectResult:
    """Streaming chunk iterator over the fan-out (select_result.go:43).

    Pull API: next_chunk() -> Chunk | None.  close() cancels outstanding
    work.  Exec summaries accumulate for EXPLAIN ANALYZE.
    """

    def __init__(self, storage, req: CopRequest):
        self.storage = storage
        self.req = req
        self._chunks: "queue.Queue" = queue.Queue(maxsize=max(4, req.concurrency * 2))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._closed = False
        self._rows_returned = 0
        # EXPLAIN ANALYZE attribution: which engine actually served the scan
        self.scan_engine: str = "pending"
        self.total_tasks = 0
        # trace propagation: the producer thread (and its pool workers)
        # re-attach to the span active on the SUBMITTING thread — the
        # contextvar does not cross thread boundaries by itself
        from ..lifecycle import current_scope
        from ..trace import current_span

        self._parent_span = current_span()
        # lifecycle propagation rides the same capture: workers observe
        # the statement's cancel event so KILL/deadline/drain stops
        # queued tasks, retry loops and backoff sleeps, not just the
        # consumer-side Next() boundary
        self._scope = current_scope()
        self._fanout_span = None
        # named so leak checks (tests/chaos harness) can find stragglers
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tidb-tpu-select")
        from .. import ops

        # across processes every process must issue a statement's
        # programs in one order: the producer starts at the first pull
        # (the executor tree's order), not when the reader opens
        self._started = ops.process_count() == 1
        if self._started:
            self._thread.start()

    # ---- producer side -------------------------------------------------
    def _put(self, item):
        """Bounded put that never deadlocks a closed result."""
        while True:
            if self._stop.is_set():
                raise _Closed()
            # a cancelled statement stops producing; the error surfaces
            # to the consumer via _finish_error (the producer catches it)
            self._scope.check()
            try:
                self._chunks.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    def _run_task(self, clip: KeyRange) -> List[Chunk]:
        """One region's cop task: retry transient errors with typed
        backoff.  Each task records a cop.task span (region clip, the
        engine that actually served it, accumulated backoff wait)."""
        from ..lifecycle import attach_scope
        from ..trace import attach, span

        with attach_scope(self._scope), attach(self._fanout_span):
            with span("cop.task", start=clip.start, end=clip.end) as tsp:
                return self._run_task_inner(clip, tsp)

    def _run_task_inner(self, clip: KeyRange, tsp) -> List[Chunk]:
        from ..metrics import REGISTRY

        client = self.storage.get_client()
        bo = Backoffer(budget_ms=self.req.backoff_budget_ms,
                       scope=self._scope)
        engine = self.req.engine
        try:
            while True:
                if self._stop.is_set():
                    raise _Closed()
                # host-side cancellation seam: checked before every
                # dispatch attempt (and inside the backoff sleeps via the
                # Backoffer's scope); exec/cancel is the chaos harness's
                # mid-fan-out kill site
                FAILPOINTS.hit("exec/cancel", site="distsql",
                               scope=self._scope)
                self._scope.check()
                sub = CopRequest(
                    dag=self.req.dag, ranges=[clip], ts=self.req.ts,
                    concurrency=1, keep_order=self.req.keep_order,
                    streaming=self.req.streaming, engine=engine,
                    aux=self.req.aux,
                )
                try:
                    FAILPOINTS.hit("distsql/task_error", range=clip)
                    out: List[Chunk] = []
                    for resp in client.send(sub):
                        out.extend(resp.chunks)
                    REGISTRY.inc("cop_tasks_total")
                    REGISTRY.inc(f"cop_tasks_{engine}_total")
                    tsp.set(engine=engine)
                    return out
                except TiDBTPUError:
                    # semantic error (lock conflict, kill, quota, bad
                    # plan): surfaces to the consumer, never silently
                    # retried here — region-level routing retry already
                    # ran inside CoprClient
                    raise
                except _Closed:
                    raise
                except (KeyboardInterrupt, SystemExit, MemoryError):
                    # fatal process conditions are not transient device
                    # errors: surface instead of burning the retry budget
                    raise
                except BaseException as e:
                    # the region reruns on the same engine: a request
                    # for the device never moves to the host engine here
                    bo.backoff("task_error", e)
        finally:
            if bo.slept_ms:
                tsp.add("backoff_ms", bo.slept_ms)

    def _run(self):
        from ..lifecycle import attach_scope
        from ..trace import NOOP, attach, span

        with attach_scope(self._scope), attach(self._parent_span):
            with span("distsql.fanout", engine=self.req.engine) as sp:
                self._fanout_span = None if sp is NOOP else sp
                try:
                    self._produce()
                finally:
                    sp.set(scan_engine=self.scan_engine,
                           tasks=self.total_tasks)

    def _produce(self):
        try:
            if self.req.engine == "tpu":
                # sharded data plane (tidb_tpu/dataplane): tables
                # partitioned across the fleet scatter over partition
                # owners and gather in handle order; None when the
                # table is unsharded, the shard snapshot is stale, or
                # any fragment fails (the local paths below hold the
                # full base table, so the fallback is always correct)
                from ..dataplane import try_run_dataplane

                dpc = try_run_dataplane(self.storage, self.req)
                if dpc is not None:
                    self.scan_engine = "dataplane"
                    for c in dpc:
                        self._put(c)
                    self._put(_DONE)
                    return
                # micro-batch rung (tidb_tpu/serving): identical-shape
                # point/agg statements arriving within the batching
                # window coalesce into one batched per-tile program;
                # None when ineligible or disabled (a runtime error of
                # the batched program reaches the statement)
                from ..serving import try_run_microbatch

                mb = try_run_microbatch(self.storage, self.req)
                if mb is not None:
                    self.scan_engine = "microbatch"
                    for c in mb:
                        self._put(c)
                    self._put(_DONE)
                    return
                # whole-table device program (copr/parallel.py).  None
                # means the plan is ineligible (an operator not ported
                # yet, an empty table): the per-region fan-out below
                # serves it.  A runtime error on the card is not
                # ineligibility: it surfaces to the statement, so a
                # failing device or kernel never hands its queries to
                # the host engine unseen
                from ..copr.parallel import try_run_mesh

                out = try_run_mesh(self.storage, self.req)
                if out is not None:
                    self.scan_engine = "mesh"
                    for c in out:
                        self._put(c)
                    self._put(_DONE)
                    return
                self.scan_engine = "tile-fanout"
            else:
                self.scan_engine = "cpu"
            # split ranges per region up front: each task is one region's clip
            tasks = []
            for kr in self.req.ranges:
                for region, clipped in self.storage.regions.locate(kr):
                    tasks.append(clipped)
            if not tasks:
                self._put(_DONE)
                return
            self.total_tasks = len(tasks)
            n_workers = min(self.req.concurrency, len(tasks))

            if n_workers == 1:
                for clip in tasks:
                    for c in self._run_task(clip):
                        self._put(c)
                self._put(_DONE)
                return

            pool = ThreadPoolExecutor(max_workers=n_workers)
            futures = [pool.submit(self._run_task, t) for t in tasks]
            try:
                if self.req.keep_order:
                    # task submission order == handle order (locate is
                    # sorted); yield in that order
                    for f in futures:
                        for c in self._task_result(f):
                            self._put(c)
                else:
                    from concurrent.futures import as_completed

                    for f in as_completed(futures):
                        for c in self._task_result(f):
                            self._put(c)
                self._put(_DONE)
            finally:
                for f in futures:
                    f.cancel()
                pool.shutdown(wait=False)
        except _Closed:
            pass
        except BaseException as e:  # surfaced on the consumer side
            self._finish_error(e)

    def _task_result(self, f) -> List[Chunk]:
        """Consume one task future; on its error, FAIL FAST: flag the stop
        event so queued sibling tasks exit at entry and running ones
        abandon their retry loops instead of finishing work (and burning
        backoff budget) for a query that already failed."""
        try:
            return f.result()
        except _Closed:
            raise
        except BaseException:
            if not self._stop.is_set():
                from ..metrics import REGISTRY

                REGISTRY.inc("cop_fanout_failfast_total")
                self._stop.set()
            raise

    def _finish_error(self, e: BaseException):
        """Surface a producer error: a plain _put(_DONE) would raise
        _Closed once the stop flag is set (fail-fast path) and strand the
        consumer on get() — drain and deliver _DONE directly instead."""
        self._err = e
        self._stop.set()
        try:
            while True:
                self._chunks.get_nowait()
        except queue.Empty:
            pass
        try:
            self._chunks.put_nowait(_DONE)
        except queue.Full:  # pragma: no cover - queue just drained
            pass

    # ---- consumer side -------------------------------------------------
    def next_chunk(self) -> Optional[Chunk]:
        if self._closed:
            return None
        if not self._started:
            self._started = True
            self._thread.start()
        item = self._chunks.get()
        if item is _DONE:
            if self._err is not None:
                err, self._err = self._err, None
                self.close()
                raise err
            self.close()
            return None
        self._rows_returned += item.num_rows
        return item

    def __iter__(self) -> Iterator[Chunk]:
        while True:
            c = self.next_chunk()
            if c is None:
                return
            yield c

    def close(self):
        self._closed = True
        self._stop.set()
        # drain so a producer blocked on a full queue unblocks immediately
        try:
            while True:
                self._chunks.get_nowait()
        except queue.Empty:
            pass


def select_dag(storage, dag: DAG, ranges: List[KeyRange], ts: int,
               concurrency: int = 8, keep_order: bool = False,
               engine: str = "tpu", aux: Optional[dict] = None,
               backoff_budget_ms: int = DEFAULT_BUDGET_MS) -> SelectResult:
    req = (
        RequestBuilder()
        .set_dag(dag)
        .set_ranges(ranges)
        .set_ts(ts)
        .set_concurrency(concurrency)
        .set_keep_order(keep_order)
        .set_engine(engine)
        .set_backoff_budget(backoff_budget_ms)
        .build()
    )
    if aux:
        req.aux = aux
    return SelectResult(storage, req)

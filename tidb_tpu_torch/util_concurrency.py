"""Ranked locks + the opt-in lock-order witness.

Every lock in the tree is constructed through `make_lock` / `make_rlock`
with its registry name (`module:Owner.attr`, the key into
`lint.concur.LOCK_RANKS`).  With `TIDB_TPU_LOCKCHECK` unset (the
default, read once at construction) the factories return plain
`threading.Lock` / `threading.RLock` objects — zero overhead, zero
indirection on the hot path.  With `TIDB_TPU_LOCKCHECK=1` (the tier-1
conftest sets it) they return a `RankedLock` wrapper that keeps a
per-thread stack of held locks and raises `LockOrderError` on any
acquisition that does not strictly increase the declared rank — the
runtime half of the concurrency lint: the static pass
(`lint/concur.py`) covers paths tests never take, the witness validates
the declared order against real executions.

Re-entry is permitted only for the SAME RLock object (rank equality
against a different lock is still an error: two locks sharing a rank
may not nest).  Witness bookkeeping (total guarded acquisitions, max
held depth, violations) feeds `/status`'s "lockcheck" section and the
`lockcheck` bench receipt.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, Optional


class LockOrderError(RuntimeError):
    """A lock acquisition inverted the declared rank order (or used an
    unregistered name).  Raised by the witness at the faulty
    acquisition site — the stack trace IS the repro."""


def lockcheck_enabled() -> bool:
    """Witness mode, read at each construction site (module-import
    time for globals — set the env var before importing tidb_tpu)."""
    return os.environ.get("TIDB_TPU_LOCKCHECK", "0") not in ("", "0")


# per-thread stack of currently-held RankedLocks (witness mode only)
_held = threading.local()

# witness counters; guarded by a plain internal lock that is itself
# never held while acquiring a ranked lock (leaf by construction)
# "wait_trips" (held-lock waits, concurrency (a)) is deliberately a
# separate key from "violations": the conftest fixture fails any test
# that bumps violations, while wait trips have their own negative test.
_stats_mu = threading.Lock()
_STATS = {"acquisitions": 0, "max_depth": 0, "violations": 0,
          "wait_trips": 0}

# per-lock acquire contention (concurrency (c)): name -> [contended
# acquisitions, total wait ms, log2 wait-ms bucket counts].  Buckets are
# exponent-indexed at 2^(i-1)..2^i ms; index 0 holds sub-1ms waits.
_CONTENTION_BUCKETS = 16
_CONTENTION: Dict[str, list] = {}


def _record_contention(name: str, wait_ms: float):
    b = 0
    ms = wait_ms
    while ms >= 1.0 and b < _CONTENTION_BUCKETS - 1:
        ms /= 2.0
        b += 1
    with _stats_mu:
        rec = _CONTENTION.get(name)
        if rec is None:
            rec = _CONTENTION[name] = [0, 0.0, [0] * _CONTENTION_BUCKETS]
        rec[0] += 1
        rec[1] += wait_ms
        rec[2][b] += 1


def _ranks() -> Dict[str, int]:
    # lazy: lint.concur imports nothing heavy, but keeping the import
    # here lets plain (non-witness) processes never load the lint pkg
    from .lint.concur import LOCK_RANKS

    return LOCK_RANKS


def _stack():
    s = getattr(_held, "stack", None)
    if s is None:
        s = _held.stack = []
    return s


class RankedLock:
    """Witness wrapper: a named, ranked lock enforcing that every
    thread acquires locks in strictly increasing rank order."""

    __slots__ = ("name", "rank", "reentrant", "_lock")

    def __init__(self, name: str, lock, reentrant: bool):
        ranks = _ranks()
        if name not in ranks:
            raise LockOrderError(
                f"lock {name!r} is not in lint.concur.LOCK_RANKS — "
                f"declare its rank before constructing it")
        self.name = name
        self.rank = ranks[name]
        self.reentrant = reentrant
        self._lock = lock

    # ---- witness core ---------------------------------------------------
    def _check(self):
        stack = _stack()
        if stack:
            top = stack[-1]
            if top is self or (self.reentrant
                               and any(h is self for h in stack)):
                return  # same-object RLock re-entry
            if top.rank >= self.rank:
                with _stats_mu:
                    _STATS["violations"] += 1
                held = " -> ".join(f"{h.name}({h.rank})" for h in stack)
                raise LockOrderError(
                    f"lock-order violation: acquiring {self.name!r} "
                    f"(rank {self.rank}) while holding [{held}] — "
                    f"ranks must strictly increase")

    def _push(self):
        stack = _stack()
        stack.append(self)
        with _stats_mu:
            _STATS["acquisitions"] += 1
            if len(stack) > _STATS["max_depth"]:
                _STATS["max_depth"] = len(stack)

    def _pop(self):
        stack = _stack()
        # LIFO in practice (`with` blocks); tolerate out-of-order
        # release by removing the last matching entry by identity
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                return

    # ---- threading.Lock surface ----------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        self._check()
        # contention probe: an uncontended acquire stays a single
        # non-blocking call; only a contended one pays for two clock
        # reads, and only that wait lands in the per-lock histogram
        ok = self._lock.acquire(False)
        if not ok and blocking:
            t0 = time.monotonic()
            ok = self._lock.acquire(True, timeout)
            _record_contention(self.name,
                               (time.monotonic() - t0) * 1000.0)
        if ok:
            self._push()
        return ok

    def release(self):
        self._pop()
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lock.locked()

    def __repr__(self):  # pragma: no cover — diagnostics only
        return f"<RankedLock {self.name} rank={self.rank}>"


class FifoLock:
    """A lock its waiters take in the order they asked for it: a release
    hands it straight to the longest waiter.  A `threading.Lock` lets
    whichever thread runs first take it, so a waiter can lose it again
    and again to threads that asked later."""

    __slots__ = ("_mu", "_held", "_waiters")

    def __init__(self):
        self._mu = threading.Lock()
        self._held = False
        self._waiters = collections.deque()   # threading.Event each

    def acquire(self, blocking: bool = True, timeout: float = -1):
        with self._mu:
            if not self._held:
                self._held = True
                return True
            if not blocking:
                return False
            ev = threading.Event()
            self._waiters.append(ev)
        if ev.wait(None if timeout < 0 else timeout):
            return True
        with self._mu:
            if ev.is_set():
                return True   # handed over as the wait timed out
            self._waiters.remove(ev)
            return False

    def release(self):
        with self._mu:
            if not self._held:
                raise RuntimeError("release unlocked lock")
            if self._waiters:
                self._waiters.popleft().set()   # still held: handed over
            else:
                self._held = False

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        with self._mu:
            return self._held


def make_lock(name: str, fifo: bool = False):
    """A `threading.Lock` registered under `name` (witness-wrapped when
    `TIDB_TPU_LOCKCHECK=1`), or with `fifo` a `FifoLock`.  `name` must
    literal-match the site: `module:Owner.attr` for instance locks,
    `module:GLOBAL` for module globals — the static pass cross-checks
    the literal against the construction site."""
    lock = FifoLock() if fifo else threading.Lock()
    if not lockcheck_enabled():
        return lock
    return RankedLock(name, lock, reentrant=False)


def make_rlock(name: str):
    """`make_lock` for re-entrant locks: same-object re-entry is legal,
    everything else follows the rank order."""
    lock = threading.RLock()
    if not lockcheck_enabled():
        return lock
    return RankedLock(name, lock, reentrant=True)


def witness_stats() -> dict:
    """Witness counters for /status ("lockcheck") and the bench
    receipt.  All zeros (enabled=False) when the witness is off.
    "locks" carries the per-lock contention table (concurrency (c)):
    contended acquisitions, summed wait ms and the log2 wait-ms bucket
    counts, keyed by the registered lock name."""
    with _stats_mu:
        snap = dict(_STATS)
        snap["locks"] = {
            name: {"contended": rec[0],
                   "wait_ms": round(rec[1], 3),
                   "wait_ms_log2": list(rec[2])}
            for name, rec in sorted(_CONTENTION.items())
        }
    snap["enabled"] = lockcheck_enabled()
    return snap


def reset_witness_stats():
    with _stats_mu:
        for k in _STATS:
            _STATS[k] = 0
        _CONTENTION.clear()


def held_depth() -> int:
    """Current thread's held-lock depth (0 when the witness is off)."""
    return len(getattr(_held, "stack", ()))


def witness_wait_check(what: str):
    """Witness half of concurrency (a): raise if this thread is about to
    block on a condition/event WAIT while holding a ranked lock.  The
    notifier of that wait must run to wake us; if waking requires any
    lock ranked at or below what we hold, the wait IS a deadlock waiting
    for load — so the witness bans held-lock waits outright (the static
    pass in lint/concur.py applies the rank comparison; at runtime any
    held ranked lock is grounds to trip).  Counted under "wait_trips",
    not "violations", so the negative test doesn't fail itself via the
    conftest violation fixture."""
    stack = getattr(_held, "stack", None)
    if not stack:
        return
    with _stats_mu:
        _STATS["wait_trips"] += 1
    held = " -> ".join(f"{h.name}({h.rank})" for h in stack)
    raise LockOrderError(
        f"held-lock wait: {what} would block while holding [{held}] — "
        f"the notifier cannot be guaranteed to run without acquiring a "
        f"lower-ranked lock; release before waiting")

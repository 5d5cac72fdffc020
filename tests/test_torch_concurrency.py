"""The port's lock-order witness and its static lock lint, under load.

The counterparts of tests/test_concurrency.py over `tidb_tpu_torch`:
tests/conftest.py sets TIDB_TPU_LOCKCHECK=1 before any package is
imported, so every lock made through the port's
`util_concurrency.make_lock` is a RankedLock checked against the port's
`lint.concur.LOCK_RANKS`.  The witness semantics, 8-thread stress of the
contended structures (metrics.Registry, ByteCapCache,
DeviceHealthRegistry), the coordinator replay race and the wait sweep;
then the two locks that were raw `threading.Lock`s (the computed-key
remap cache and the nvcc build), now ranked and seen by the witness.
The static pass over the port's locks runs in tests/test_torch_lint.py.
"""

import threading
import time

import numpy as np
import pytest

from tidb_tpu_torch.metrics import REGISTRY
from tidb_tpu_torch.util_concurrency import (
    LockOrderError,
    RankedLock,
    held_depth,
    lockcheck_enabled,
    make_lock,
    make_rlock,
    reset_witness_stats,
    witness_stats,
)

N_THREADS = 8


def _run_threads(fn, n=N_THREADS):
    """Run fn(i) on n threads; re-raise the first worker exception."""
    errs = []

    def wrap(i):
        try:
            fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]


# ---------------------------------------------------------------------------
# witness semantics
# ---------------------------------------------------------------------------

def test_witness_enabled_in_suite():
    assert lockcheck_enabled()
    assert witness_stats()["enabled"]


def test_rank_inversion_raises(monkeypatch):
    from tidb_tpu_torch.lint import concur

    monkeypatch.setitem(concur.LOCK_RANKS, "tests.concur:LO", 1)
    monkeypatch.setitem(concur.LOCK_RANKS, "tests.concur:HI", 2)
    lo = make_lock("tests.concur:LO")
    hi = make_lock("tests.concur:HI")
    with lo:
        with hi:  # increasing rank: legal
            assert held_depth() == 2
    assert held_depth() == 0
    v0 = witness_stats()["violations"]
    with hi:
        with pytest.raises(LockOrderError):
            lo.acquire()
    assert held_depth() == 0
    assert witness_stats()["violations"] == v0 + 1
    # the violation above was deliberate — reset so the autouse
    # fixture does not fail this test for its own assertion
    reset_witness_stats()


def test_equal_rank_never_nests(monkeypatch):
    from tidb_tpu_torch.lint import concur

    monkeypatch.setitem(concur.LOCK_RANKS, "tests.concur:A", 7)
    monkeypatch.setitem(concur.LOCK_RANKS, "tests.concur:B", 7)
    a = make_rlock("tests.concur:A")
    b = make_rlock("tests.concur:B")
    with a:
        with a:  # same-OBJECT RLock re-entry is legal
            pass
        with pytest.raises(LockOrderError):
            b.acquire()  # same RANK, different lock: never legal
    reset_witness_stats()


def test_unregistered_lock_name_raises():
    with pytest.raises(LockOrderError):
        make_lock("tests.concur:not-in-the-registry")


def test_witness_trips_held_lock_wait(monkeypatch):
    """Concurrency (a): blocking on a condition/event WAIT while holding
    a ranked lock is banned outright — the notifier may need a lower-
    ranked lock to run, so the wait is a deadlock waiting for load.
    Counted under "wait_trips", NOT "violations" (the autouse fixture
    must not fail this test for its own assertion)."""
    from tidb_tpu_torch.lint import concur
    from tidb_tpu_torch.util_concurrency import witness_wait_check

    monkeypatch.setitem(concur.LOCK_RANKS, "tests.concur:W", 5)
    mu = make_lock("tests.concur:W")
    s0 = witness_stats()
    witness_wait_check("bare")  # no lock held: fine
    with mu:
        with pytest.raises(LockOrderError, match="held-lock wait"):
            witness_wait_check("Cond.wait")
    s1 = witness_stats()
    assert s1["wait_trips"] == s0["wait_trips"] + 1
    assert s1["violations"] == s0["violations"]
    reset_witness_stats()


def test_scope_wait_trips_under_held_lock(monkeypatch):
    """QueryScope.wait — the seam every backoff and throttle poll rides
    — calls the witness check, so a held-lock sleep anywhere in the
    stack surfaces immediately under test."""
    from tidb_tpu_torch.lifecycle import QueryScope
    from tidb_tpu_torch.lint import concur

    monkeypatch.setitem(concur.LOCK_RANKS, "tests.concur:SW", 5)
    mu = make_lock("tests.concur:SW")
    sc = QueryScope()
    assert sc.wait(0.001) is False  # unheld: a normal bounded sleep
    with mu:
        with pytest.raises(LockOrderError):
            sc.wait(0.001)
    reset_witness_stats()


def test_contention_counters_per_lock(monkeypatch):
    """Concurrency (c): contended acquisitions land in the per-lock
    log2 wait-ms histogram; uncontended ones stay off the books."""
    from tidb_tpu_torch.lint import concur

    monkeypatch.setitem(concur.LOCK_RANKS, "tests.concur:CONT", 5)
    mu = make_lock("tests.concur:CONT")
    with mu:
        pass  # uncontended: no table entry for this lock
    assert "tests.concur:CONT" not in witness_stats()["locks"]

    gate = threading.Event()

    def holder():
        with mu:
            gate.set()
            time.sleep(0.02)

    t = threading.Thread(target=holder)
    t.start()
    gate.wait()
    with mu:  # blocks ~20ms behind the holder
        pass
    t.join()
    rec = witness_stats()["locks"]["tests.concur:CONT"]
    assert rec["contended"] >= 1
    assert rec["wait_ms"] > 0
    assert sum(rec["wait_ms_log2"]) == rec["contended"]
    reset_witness_stats()


# ---------------------------------------------------------------------------
# 8-thread stress
# ---------------------------------------------------------------------------

def test_registry_stress_no_lost_increments():
    per_thread = 2000
    c0 = REGISTRY.get("concurrency_stress_test_total")

    def work(_i):
        for _ in range(per_thread):
            REGISTRY.inc("concurrency_stress_test_total")

    _run_threads(work)
    got = REGISTRY.get("concurrency_stress_test_total") - c0
    assert got == N_THREADS * per_thread, f"lost {N_THREADS*per_thread-got}"


def test_bytecap_cache_stress_byte_accounting():
    from tidb_tpu_torch.copr.cache import ByteCapCache

    cache = ByteCapCache(capacity_bytes=64 * 1024)
    # value-weighted eviction exercised concurrently too
    cache.set_policy(priority_fn=lambda k: k[1] % 3)
    n_keys = 23

    def _load(idx):
        # deterministic per-key size, 1..5 KiB of float32
        return (np.full(256 * (1 + idx % 5), float(idx), np.float32),)

    def work(i):
        for j in range(300):
            idx = (i * 7 + j) % n_keys
            v = cache.get_or_load(("stress", idx),
                                  lambda idx=idx: _load(idx))
            assert float(v[0][0]) == float(idx)  # never a torn value

    _run_threads(work)
    with cache._mu:
        resident = sum(sum(a.nbytes for a in v if a is not None)
                       for v in cache._cache.values())
        assert resident == cache._bytes  # accounting matches contents
        assert cache._bytes <= cache.capacity
        assert sorted(cache._order) == sorted(cache._cache)
        assert not cache._inflight  # every loader completed
        assert cache.hwm_bytes >= cache._bytes


def test_device_health_stress_consistent_states():
    from tidb_tpu_torch.copr.device_health import (
        DeviceFailure,
        DeviceHealthRegistry,
    )

    class _Dev:
        __slots__ = ("id",)

        def __init__(self, i):
            self.id = i

    devs = [_Dev(i) for i in range(8)]
    reg = DeviceHealthRegistry(trip_threshold=3, probe_after_s=0.01)

    def work(i):
        for j in range(200):
            d = (i + j) % 8
            if (i + j) % 3 == 0:
                reg.record_error(d, DeviceFailure("stress", (d,)))
            else:
                reg.record_success([d])
            healthy = reg.select_devices(devs)
            assert len(healthy) <= 8
            reg.tripped_ids()
            if j % 50 == 0:
                reg.expire_cooldowns()

    _run_threads(work)
    snap = reg.snapshot()
    assert {s.device_id for s in snap} <= set(range(8))
    for s in snap:
        assert s.error_count >= 0 and s.trip_count >= 0
        # a consecutive-error run can never exceed the trip threshold:
        # hitting it trips the breaker (torn updates would overshoot)
        assert s.consecutive_errors <= 3


# ---------------------------------------------------------------------------
# regression: coordinator state replay vs concurrent registers
# ---------------------------------------------------------------------------

def test_coordinator_replay_races_register(tmp_path):
    """_load_state used to mutate _epoch/_members/_handoff OUTSIDE the
    membership mutex; a replay racing a register could clobber the
    concurrent join.  Replay now holds _mu (and flushes after releasing
    it — the witness enforces the _save_io_mu -> _mu order)."""
    from tidb_tpu_torch.coord.plane import Coordinator

    state = tmp_path / "coord.json"
    c = Coordinator(lease_s=30.0, state_path=str(state))
    c.register(1, [0])
    c.register(2, [1])
    c._flush_state()

    stop = threading.Event()

    def replayer():
        while not stop.is_set():
            c._load_state()

    t = threading.Thread(target=replayer)
    t.start()
    try:
        for pid in range(10, 40):
            c.register(pid, [pid % 8])
    finally:
        stop.set()
        t.join()
    members = c.view().members
    for pid in [1, 2] + list(range(10, 40)):
        assert pid in members, f"replay clobbered concurrent join {pid}"


# ---------------------------------------------------------------------------
# the wait-witness sweep: every Event.wait/Condition.wait site rides
# witness_wait_check
# ---------------------------------------------------------------------------

def _assert_wait_trips(monkeypatch, fn):
    """`fn` must pass with no lock held and trip the witness (wait_trips,
    not violations) under a deliberately held ranked lock."""
    from tidb_tpu_torch.lint import concur

    monkeypatch.setitem(concur.LOCK_RANKS, "tests.concur:WS", 5)
    mu = make_lock("tests.concur:WS")
    fn()  # unheld: a normal bounded wait
    s0 = witness_stats()
    with mu:
        with pytest.raises(LockOrderError, match="held-lock wait"):
            fn()
    s1 = witness_stats()
    assert s1["wait_trips"] == s0["wait_trips"] + 1
    assert s1["violations"] == s0["violations"]
    reset_witness_stats()


def test_worker_plane_heartbeat_wait_covered(monkeypatch):
    """WorkerPlane._heartbeat's lease park (coord/plane.py)."""
    from tidb_tpu_torch.coord.plane import WorkerPlane

    wp = WorkerPlane("127.0.0.1:1", 99, heartbeat_s=0.001)
    _assert_wait_trips(monkeypatch, wp._hb_wait)


def test_worker_plane_span_flusher_wait_covered(monkeypatch):
    """WorkerPlane._span_flusher's age-flush park (coord/plane.py)."""
    from tidb_tpu_torch.coord.plane import WorkerPlane

    wp = WorkerPlane("127.0.0.1:1", 99, heartbeat_s=0.001)
    wp._span_flush_s = 0.001
    _assert_wait_trips(monkeypatch, wp._flusher_wait)


def test_maintenance_idle_wait_covered(monkeypatch):
    """MaintenanceWorker._loop's interval park (session/maintenance.py).
    A GC/compaction daemon sleeping an INTERVAL with a ranked lock held
    would starve that lock for seconds, not milliseconds."""
    from tidb_tpu_torch.session.maintenance import MaintenanceWorker

    mw = MaintenanceWorker(domain=None, interval_s=0.001)
    _assert_wait_trips(monkeypatch, mw._idle_wait)


def test_batcher_window_wait_covered(monkeypatch):
    """MicroBatcher's leader window park (serving/batcher.py)."""
    from types import SimpleNamespace

    from tidb_tpu_torch.serving.batcher import MicroBatcher

    b = MicroBatcher()
    g = SimpleNamespace(full=threading.Event())
    _assert_wait_trips(monkeypatch, lambda: b._window_wait(g, 0.001))


def test_batcher_member_wait_covered(monkeypatch):
    """MicroBatcher's parked-member poll tick (serving/batcher.py)."""
    from types import SimpleNamespace

    from tidb_tpu_torch.serving.batcher import MicroBatcher

    b = MicroBatcher()
    ev = threading.Event()
    ev.set()  # unheld path returns immediately
    m = SimpleNamespace(event=ev)
    _assert_wait_trips(monkeypatch, lambda: b._member_wait(m))


# ---------------------------------------------------------------------------
# the formerly raw locks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("module,attr,key", [
    ("tidb_tpu_torch.copr.fusion", "_REMAP_MU", "copr.fusion:_REMAP_MU"),
    ("tidb_tpu_torch.copr.cuda.build", "_mu", "copr.cuda.build:_mu"),
])
def test_formerly_raw_locks_are_ranked_and_witnessed(monkeypatch, module,
                                                     attr, key):
    """Both locks are RankedLocks under their registry keys: the witness
    raises when one is taken above its rank, and lets it nest below a
    higher one."""
    import importlib

    from tidb_tpu_torch.lint import concur

    mu = getattr(importlib.import_module(module), attr)
    assert isinstance(mu, RankedLock)
    assert (mu.name, mu.rank) == (key, concur.LOCK_RANKS[key])
    monkeypatch.setitem(concur.LOCK_RANKS, "tests.concur:ABOVE", 299)
    monkeypatch.setitem(concur.LOCK_RANKS, "tests.concur:BELOW", 1)
    above = make_lock("tests.concur:ABOVE")
    below = make_lock("tests.concur:BELOW")
    with below:
        with mu:
            assert held_depth() == 2
    with above:
        with pytest.raises(LockOrderError):
            mu.acquire()
    assert held_depth() == 0
    reset_witness_stats()


def test_remap_cache_runs_under_the_witness():
    """The remap cache's bookkeeping takes its ranked lock (a statement
    with a computed key fills it) with no witness violation."""
    from tidb_tpu_torch import ops
    from tidb_tpu_torch.copr import fusion
    from tidb_tpu_torch.session import Domain

    ops.use_device("cpu")
    d = Domain()
    s = d.new_session()
    s.execute("create table rc (a varchar(4), b bigint)")
    s.execute("insert into rc values ('Ab', 1), ('aB', 2), ('cd', 3)")
    d.storage.maybe_compact(
        d.catalog.info_schema().table("test", "rc").id, threshold=0)
    v0 = witness_stats()["violations"]
    sql = "select lower(a), sum(b) from rc group by lower(a)"
    assert sorted(s.query(sql)) == [("ab", 3), ("cd", 3)]
    assert any("engine:mesh" in r[4]
               for r in s.execute("explain analyze " + sql)[0].rows)
    assert any('"lower"' in k[2] for k in fusion._REMAP_CACHE)
    assert witness_stats()["violations"] == v0



def test_fifo_lock_hands_over_in_arrival_order():
    """The device door's lock: waiters that queued one after another take
    it in that order, whichever thread the scheduler runs first, and a
    releasing thread that asks again queues behind them."""
    from tidb_tpu_torch.copr.parallel import DISPATCH_LOCK
    from tidb_tpu_torch.util_concurrency import FifoLock

    inner = getattr(DISPATCH_LOCK, "_lock", DISPATCH_LOCK)
    assert isinstance(inner, FifoLock)
    lock, order = FifoLock(), []
    lock.acquire()
    threads = []
    for i in range(N_THREADS):
        t = threading.Thread(target=lambda i=i: (lock.acquire(),
                                                 order.append(i),
                                                 lock.release()))
        t.start()
        deadline = time.monotonic() + 10
        while len(lock._waiters) < i + 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        threads.append(t)
    lock.release()
    lock.acquire()
    order.append("again")
    lock.release()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert order == list(range(N_THREADS)) + ["again"]
    assert not lock.locked()


def test_fifo_lock_timeout_and_non_blocking():
    from tidb_tpu_torch.util_concurrency import FifoLock

    lock = FifoLock()
    assert lock.acquire(False)
    assert not lock.acquire(False)
    t0 = time.monotonic()
    assert not lock.acquire(True, 0.05)
    assert time.monotonic() - t0 >= 0.05
    assert not lock._waiters          # the timed-out waiter left the queue
    lock.release()
    assert not lock.locked()
    with pytest.raises(RuntimeError):
        lock.release()
    with lock:
        assert lock.locked()


def test_fifo_lock_stress_no_lost_updates():
    """8 threads, a short switch interval: every increment under the
    lock lands, and the lock ends free."""
    import sys

    from tidb_tpu_torch.util_concurrency import FifoLock

    lock, box = FifoLock(), [0]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(_i):
            for _ in range(2000):
                with lock:
                    v = box[0]
                    box[0] = v + 1

        _run_threads(work)
    finally:
        sys.setswitchinterval(old)
    assert box[0] == N_THREADS * 2000
    assert not lock.locked()

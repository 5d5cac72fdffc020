"""Query micro-batching of the port (`tidb_tpu_torch/serving/batcher.py`)
against the JAX package's solo rows and the port's own.

Identical-shape statements that arrive within the batching window run
as one batched per-tile program per tile (`torch_engine._tile_core`)
and each member gets back the rows it would have got alone: ints and
decimals exactly, floats within `_approx_rows`' relative 1e-9 (the
batched path merges per-tile partials on the host, the solo path runs
the whole-table program).  Every parity test holds the batched rows
against the JAX package's solo rows on an identically loaded
`tidb_tpu` Domain and against the port's solo rows.

A KILLed or deadline-expired member is masked out mid-window; a runtime
error of the batched program reaches every member's statement (the
port's deliberate difference: the JAX package re-runs the members solo),
after the device rungs' failover: an OOM evicts the caches and re-runs
the batch on the card, a card fault trips the breaker.
The CPU runs the plain PyTorch path (TILE = 1024 from tests/conftest.py,
so the 20,000-row table spans 20 tiles).
"""

import math
import threading
import time

import numpy as np
import pytest

from tidb_tpu_torch import ops as tops
from tidb_tpu_torch import serving
from tidb_tpu_torch.errors import MaxExecutionTimeExceeded, QueryKilledError
from tidb_tpu_torch.metrics import REGISTRY
from tidb_tpu_torch.store.fault import failpoint, once

N = 20_000
#: groups of `h`: more than ops.segment.UNROLL_G (32), so its float sums
#: take the fixed-order segmented path, solo and batched
H = 40


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    tops.use_device("cpu")


@pytest.fixture(autouse=True)
def _serving_defaults():
    """Serving config is process-global; every test starts and ends at
    the defaults so a SET in one test never bleeds into the next."""
    serving.configure(shape_buckets=True, microbatch_window_ms=0.0,
                      microbatch_max=32)
    yield
    serving.configure(shape_buckets=True, microbatch_window_ms=0.0,
                      microbatch_max=32)


def _arrays(n: int):
    rng = np.random.default_rng(11)
    return [np.arange(n, dtype=np.int64),
            rng.integers(0, 5, n, dtype=np.int64),
            rng.uniform(0, 100, n),
            rng.integers(-10**6, 10**6, n, dtype=np.int64),  # cents
            rng.integers(0, H, n, dtype=np.int64)]


def _load(sess, name: str, n: int = N, regions: int = 4):
    d = sess.domain
    sess.execute(f"create table {name} (k bigint, g bigint, x double,"
                 " dm decimal(12,2), h bigint)")
    t = d.catalog.info_schema().table("test", name)
    store = d.storage.table(t.id)
    store.bulk_load_arrays(_arrays(n), ts=d.storage.current_ts())
    d.storage.regions.split_even(t.id, regions, store.base_rows)
    return store


@pytest.fixture(scope="module")
def pair():
    """(JAX package session, port session) over the same rows."""
    from tidb_tpu.session import Domain as JDomain
    from tidb_tpu_torch.session import Domain as TDomain

    out = []
    for cls in (JDomain, TDomain):
        s = cls().new_session()
        _load(s, "t")
        out.append(s)
    return tuple(out)


def _snap(*names):
    s = REGISTRY.snapshot()
    return tuple(s.get(n, 0) for n in names)


def _approx_rows(got, want, ctx=""):
    assert len(got) == len(want), (ctx, got, want)
    for ra, rb in zip(sorted(got), sorted(want)):
        for x, y in zip(ra, rb):
            if isinstance(x, float) or isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-9, abs=1e-9), (ctx, ra, rb)
            else:
                assert x == y, (ctx, ra, rb)


def _concurrent(d, sqls, window_ms=250):
    """Run sqls on fresh port sessions, one thread each, batching window
    on; returns (results, errors, sessions) in input order."""
    serving.configure(microbatch_window_ms=float(window_ms))
    results = [None] * len(sqls)
    errors = [None] * len(sqls)
    sessions = [d.new_session() for _ in sqls]
    barrier = threading.Barrier(len(sqls))

    def run(i):
        barrier.wait()
        try:
            results[i] = sessions[i].query(sqls[i])
        except BaseException as e:  # noqa: BLE001 — asserted by tests
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True,
                                name=f"serving-test-{i}")
               for i in range(len(sqls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    serving.configure(microbatch_window_ms=0.0)
    assert not any(t.is_alive() for t in threads), "a statement hung"
    return results, errors, sessions


def _parity(pair, sqls, window_ms=250):
    """Batched port rows against the JAX package's and the port's solo
    rows; returns the batch counter deltas (batches, statements)."""
    j, t = pair
    jax_solo = [j.query(q) for q in sqls]
    solo = [t.query(q) for q in sqls]
    b0, s0 = _snap("serving_batches_total", "serving_batched_stmts_total")
    results, errors, _ = _concurrent(t.domain, sqls, window_ms)
    b1, s1 = _snap("serving_batches_total", "serving_batched_stmts_total")
    assert errors == [None] * len(sqls), errors
    for q, got, want, jwant in zip(sqls, results, solo, jax_solo):
        _approx_rows(got, want, q)
        _approx_rows(got, jwant, q)
    return b1 - b0, s1 - s0


def test_microbatch_agg_parity(pair):
    sqls = [f"select count(*), sum(x), min(x), sum(dm), max(dm) from t"
            f" where k = {k}" for k in (3, 7, 4242, 19_998)]
    db, ds = _parity(pair, sqls)
    assert db > 0, "no batch formed"
    assert ds >= 2, "fewer than 2 statements batched"
    assert ds > db, "batches never held >1 statement"


def test_microbatch_grouped_agg_parity(pair):
    """Dense grouped aggregation with first_row, over a range predicate:
    every member reads several tiles."""
    sqls = [f"select g, k, count(*), sum(x), sum(dm), min(dm), max(x)"
            f" from t where k >= {lo} and k < {lo + 3000} group by g"
            for lo in (0, 1500, 9000, 16_000)]
    db, ds = _parity(pair, sqls)
    assert ds > db >= 1


def test_microbatch_float_sums_over_many_groups(pair):
    """B x G > 32 float sums: G = 40 groups per member, each above
    UNROLL_G, so solo and batched runs both take the fixed-order
    segmented sum; two batched runs give the same bits."""
    sqls = [f"select h, count(*), sum(x), avg(x) from t where g = {g}"
            f" group by h" for g in range(4)]
    db, ds = _parity(pair, sqls)
    assert ds > db >= 1
    runs = []
    for _ in range(2):
        results, errors, _ = _concurrent(pair[1].domain, sqls)
        assert errors == [None] * 4, errors
        runs.append([sorted(r) for r in results])
    assert runs[0] == runs[1]


def test_microbatch_filter_parity(pair):
    sqls = [f"select k, g, x, dm from t where k = {k}" for k in (5, 42, 777)]
    db, ds = _parity(pair, sqls)
    assert ds > db >= 1


def test_microbatch_filter_limit_parity(pair):
    """Per-member LIMITs of one limit class share a batch."""
    sqls = [f"select k, x from t where g = {g} and k < 4000 limit {lim}"
            for g, lim in ((1, 5), (2, 7), (3, 6))]
    j, t = pair
    results, errors, _ = _concurrent(t.domain, sqls)
    assert errors == [None] * 3, errors
    for q, got in zip(sqls, results):
        lim = int(q.rsplit(" ", 1)[1])
        assert len(got) == lim, (q, got)
        g = int(q.split("g = ")[1].split()[0])
        full = {r[0]: r for r in j.query(
            f"select k, x from t where g = {g} and k < 4000")}
        for r in got:
            _approx_rows([r], [full[r[0]]], q)


def test_microbatch_distinct_columns_never_merge(pair):
    """Regression: the DAG fingerprint keys columns by scan-output index,
    so `where k = ?` and `where g = ?` serialize identically — the batch
    key must pin the resolved STORE columns or the two queries would
    batch together and return each other's results."""
    sqls = ["select count(*), sum(x) from t where k = 3",
            "select count(*), sum(x) from t where g = 3"]
    solo = [pair[1].query(q) for q in sqls]
    assert solo[0] != solo[1]  # the shapes must be distinguishable
    _parity(pair, sqls)


def test_microbatch_route_is_microbatch(pair):
    """EXPLAIN ANALYZE labels the reader's engine `microbatch` under a
    window, and the whole-table `mesh` without one."""
    t = pair[1]
    q = "select count(*), sum(x) from t where k = 11"

    def engines():
        rows = t.execute("explain analyze " + q)[0].rows
        return [r[4] for r in rows if "TableReader" in r[0]]

    assert any("engine:mesh" in e for e in engines())
    serving.configure(microbatch_window_ms=5.0)
    assert any("engine:microbatch" in e for e in engines())


def test_microbatch_leader_kill_unblocks_window():
    """A KILLed leader must not sit out the batching window: the window
    wait wakes on its cancel event and the batch closes early."""
    from tidb_tpu_torch.lifecycle import QueryScope
    from tidb_tpu_torch.serving.batcher import MicroBatcher, _Member

    b = MicroBatcher()
    sc = QueryScope()
    m = _Member(np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64),
                sc)
    out = {}

    def run():
        t0 = time.monotonic()
        try:
            b.submit(("unit-key",), m, 5.0, 8, lambda live: None)
        except BaseException as e:  # noqa: BLE001
            out["err"] = e
        out["dt"] = time.monotonic() - t0

    th = threading.Thread(target=run, daemon=True)
    th.start()
    time.sleep(0.1)
    sc.cancel("killed")
    th.join(5)
    assert out.get("dt") is not None, "leader never returned"
    assert out["dt"] < 1.0, f"KILL blocked on the window: {out['dt']:.2f}s"
    assert isinstance(out.get("err"), QueryKilledError)


def test_microbatcher_stress_every_member_gets_its_own_result():
    """24 threads on 3 keys with a 1 us switch interval: every member
    gets back the result computed from its own parameters, each batch's
    runner sees only its own key's members, and no member is lost or
    served twice."""
    import sys

    from tidb_tpu_torch.lifecycle import QueryScope
    from tidb_tpu_torch.serving.batcher import MicroBatcher, _Member

    b = MicroBatcher()
    served = []
    got = {}
    errors = []

    def runner(key):
        def run(live):
            assert all(int(m.pi[0]) % 3 == key for m in live)
            served.extend(int(m.pi[0]) for m in live)
            for m in live:
                m.result = int(m.pi[0]) * 10
        return run

    def worker(i):
        try:
            for rep in range(20):
                v = i * 100 + rep * 3 + i % 3
                m = _Member(np.array([v]), np.zeros(0), QueryScope())
                got[v] = b.submit(("stress", v % 3), m, 0.002, 4,
                                  runner(v % 3))
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(24)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert len(got) == 24 * 20 and all(r == v * 10 for v, r in got.items())
    assert sorted(served) == sorted(got)


def test_microbatch_member_killed_mid_window(pair):
    j, t = pair
    d = t.domain
    sqls = ["select count(*), sum(x) from t where k = 1",
            "select count(*), sum(x) from t where k = 2"]
    solo = t.query(sqls[1])
    serving.configure(microbatch_window_ms=250.0)
    results = [None, None]
    errors = [None, None]
    sessions = [d.new_session(), d.new_session()]
    started = threading.Barrier(3)

    def run(i):
        started.wait()
        try:
            results[i] = sessions[i].query(sqls[i])
        except BaseException as e:  # noqa: BLE001
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(2)]
    for th in threads:
        th.start()
    started.wait()
    # kill member 0 while the window is still open: it must raise
    # promptly and be masked out; member 1's batch completes normally
    time.sleep(0.08)
    sessions[0].cancel_query("killed")
    for th in threads:
        th.join(30)
    serving.configure(microbatch_window_ms=0.0)
    assert isinstance(errors[0], QueryKilledError), errors
    assert errors[1] is None, errors
    _approx_rows(results[1], solo, "survivor of killed batch member")
    _approx_rows(results[1], j.query(sqls[1]), "survivor vs JAX package")
    assert sessions[0].last_termination == "killed"


def test_microbatch_member_deadline_mid_window(pair):
    j, t = pair
    d = t.domain
    sqls = ["select count(*), sum(x) from t where k = 8",
            "select count(*), sum(x) from t where k = 9"]
    solo = t.query(sqls[1])
    serving.configure(microbatch_window_ms=250.0)
    sessions = [d.new_session(), d.new_session()]
    sessions[0].execute("set max_execution_time = 60")  # expires in-window
    results = [None, None]
    errors = [None, None]
    barrier = threading.Barrier(2)

    def run(i):
        barrier.wait()
        try:
            results[i] = sessions[i].query(sqls[i])
        except BaseException as e:  # noqa: BLE001
            errors[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(30)
    serving.configure(microbatch_window_ms=0.0)
    assert isinstance(errors[0], MaxExecutionTimeExceeded), errors
    assert errors[1] is None, errors
    _approx_rows(results[1], solo, "survivor of deadline batch member")
    _approx_rows(results[1], j.query(sqls[1]), "survivor vs JAX package")
    assert sessions[0].last_termination == "timeout"


def test_microbatch_chaos_error_reaches_every_member(pair):
    """Seeded chaos: the batched dispatch dies once.  In the port the
    error reaches every member's statement (no solo re-run on a runtime
    error, unlike the JAX package), counts once on
    `serving_batch_errors_total`, and the next batch runs normally."""
    t = pair[1]
    sqls = [f"select count(*), sum(x) from t where k = {k}"
            for k in (100, 200)]
    solo = [t.query(q) for q in sqls]
    e0, b0 = _snap("serving_batch_errors_total", "serving_batches_total")
    with failpoint("serving/batch_dispatch", once(RuntimeError("chaos"))):
        results, errors, _ = _concurrent(t.domain, sqls, window_ms=250)
    e1, b1 = _snap("serving_batch_errors_total", "serving_batches_total")
    assert b1 - b0 == 1, "the two statements did not share one batch"
    assert e1 == e0 + 1, "chaos site never fired on the batch path"
    assert results == [None, None]
    for err in errors:
        assert isinstance(err, RuntimeError) and "chaos" in str(err), errors
    results, errors, _ = _concurrent(t.domain, sqls, window_ms=250)
    assert errors == [None, None], errors
    for q, got, want in zip(sqls, results, solo):
        _approx_rows(got, want, q)


def _spy_device_cache_clears(monkeypatch):
    from tidb_tpu_torch.copr import torch_engine as te

    calls = []
    real = te.DEVICE_CACHE.clear

    def clear():
        calls.append(1)
        real()

    monkeypatch.setattr(te.DEVICE_CACHE, "clear", clear)
    return calls


def test_microbatch_oom_evicts_caches_and_retries_on_the_card(
        pair, monkeypatch):
    """An out-of-memory error of the batched program that names no card
    follows the device rungs' rules: the device caches are cleared, the
    batch re-runs on the card, and every member gets its solo rows."""
    t = pair[1]
    sqls = [f"select count(*), sum(x) from t where k = {k}"
            for k in (300, 400)]
    solo = [t.query(q) for q in sqls]
    clears = _spy_device_cache_clears(monkeypatch)
    names = ("mesh_hbm_oom_total", "mesh_failover_retries_total",
             "serving_batch_errors_total", "serving_batches_total")
    o0, r0, e0, b0 = _snap(*names)
    oom = RuntimeError("CUDA out of memory. Tried to allocate 8.00 GiB")
    with failpoint("serving/batch_dispatch", once(oom)):
        results, errors, _ = _concurrent(t.domain, sqls, window_ms=250)
    o1, r1, e1, b1 = _snap(*names)
    assert b1 - b0 == 1, "the two statements did not share one batch"
    assert errors == [None, None], errors
    for q, got, want in zip(sqls, results, solo):
        _approx_rows(got, want, q)
    assert (o1 - o0, r1 - r0, e1 - e0) == (1, 1, 0)
    assert clears, "the OOM left DEVICE_CACHE in place"


def test_microbatch_card_fault_trips_the_breaker(pair, monkeypatch):
    """A failure that names the card trips its breaker and clears the
    caches; every member fails with DeviceUnavailableError, and while
    the breaker is open the next batch fails the same way before any
    tile program runs (no host step-down, no dispatch on a tripped
    card).  The probe batch after the cooldown closes the breaker."""
    from tidb_tpu_torch.copr.device_health import (DEVICE_HEALTH, HEALTHY,
                                                   TRIPPED, HbmOomError)
    from tidb_tpu_torch.errors import DeviceUnavailableError

    t = pair[1]
    card = tops.device_ids()
    sqls = [f"select count(*), sum(x) from t where k = {k}"
            for k in (500, 600)]
    solo = [t.query(q) for q in sqls]
    clears = _spy_device_cache_clears(monkeypatch)
    fired = []

    def fault(**ctx):
        fired.append(ctx)
        raise HbmOomError("batched program: HBM exhausted", device_ids=card)

    try:
        with failpoint("serving/batch_dispatch", fault):
            results, errors, _ = _concurrent(t.domain, sqls, window_ms=250)
            assert results == [None, None]
            assert all(isinstance(e, DeviceUnavailableError)
                       for e in errors), errors
            assert DEVICE_HEALTH.state_of(card[0]) == TRIPPED
            assert clears, "the OOM left DEVICE_CACHE in place"
            n_fired = len(fired)
            results, errors, _ = _concurrent(t.domain, sqls, window_ms=250)
            assert all(isinstance(e, DeviceUnavailableError)
                       for e in errors), errors
            assert len(fired) == n_fired, "a tile ran on a tripped card"
        # the cooldown over, the next batch is the half-open probe: it
        # runs on the card and its success closes the breaker
        DEVICE_HEALTH.expire_cooldowns()
        results, errors, _ = _concurrent(t.domain, sqls, window_ms=250)
        assert errors == [None, None], errors
        assert DEVICE_HEALTH.state_of(card[0]) == HEALTHY
    finally:
        DEVICE_HEALTH.reset()
    for q, got, want in zip(sqls, results, solo):
        _approx_rows(got, want, q)


def test_microbatch_respects_max_batch(pair):
    serving.configure(microbatch_max=2)
    sqls = [f"select count(*) from t where k = {k}" for k in range(4)]
    db, ds = _parity(pair, sqls)
    assert db >= 2, "max=2 should split 4 members into >=2 batches"
    assert ds == 4


def test_microbatch_skips_tables_with_delta():
    """MVCC delta makes the base scan ts-dependent: such tables must
    run solo (parity over throughput)."""
    from tidb_tpu_torch.session import Domain

    d = Domain()
    s = d.new_session()
    _load(s, "t_delta", n=4000, regions=2)
    s.execute("insert into t_delta values (4000, 2, 7.5, 1.25, 3)")
    q = "select count(*), sum(x) from t_delta where k >= 3999"
    solo = s.query(q)
    assert solo[0][0] == 2
    b0, = _snap("serving_batches_total")
    results, errors, _ = _concurrent(d, [q, q], window_ms=200)
    assert errors == [None, None]
    _approx_rows(results[0], solo)
    _approx_rows(results[1], solo)
    b1, = _snap("serving_batches_total")
    assert b1 == b0, "a delta'd table entered the micro-batch path"


def _requests(monkeypatch, sess, sqls):
    """The coprocessor request of each statement, captured at the
    distsql micro-batch hook (which then declines)."""
    import tidb_tpu_torch.serving as srv

    got = []

    def capture(storage, req):
        got.append((storage, req))
        return None

    monkeypatch.setattr(srv, "try_run_microbatch", capture)
    for q in sqls:
        sess.query(q)
    monkeypatch.undo()
    assert len(got) == len(sqls)
    return got


@pytest.mark.parametrize("kind,sql", [
    ("agg", "select g, k, count(*), count(x), sum(x), sum(dm), avg(dm),"
            " min(x), max(dm) from t where k >= {v} group by g"),
    ("agg", "select h, sum(x), count(*) from t where k < {v} group by h"),
    ("filter", "select k, x from t where k < {v} and x < 50.5"),
])
def test_batched_tile_program_equals_solo_calls(monkeypatch, pair, kind,
                                                 sql):
    """The batched per-tile program against B calls of the solo
    `_tile_core` on one tile: ints and decimals exact, floats within
    relative 1e-9; the [B, TILE] filter masks equal exactly."""
    import torch

    from tidb_tpu_torch.copr import torch_engine as te
    from tidb_tpu_torch.copr.ir import DAG
    from tidb_tpu_torch.serving import hoist_conds
    from tidb_tpu_torch.copr.torch_engine import agg_leaves

    t = pair[1]
    vals = (700, 2100, 5000, 9000)
    reqs = _requests(monkeypatch, t, [sql.format(v=v) for v in vals])
    storage, req = reqs[0]
    table = storage.table(DAG.from_dict(req.dag).scan.table_id)
    ans, params = [], []
    for _s, r in reqs:
        an = te._Analyzed(DAG.from_dict(r.dag), table)
        ans.append(an)
        params.append(hoist_conds(an))
    an = ans[0]
    col_order = an.needed_cols()
    fn = te._tile_core(an, kind, col_order, with_params=True, batched=True)
    solo = te._tile_core(an, kind, col_order, with_params=True)
    dev = torch.device("cpu")
    tile_idx = 2
    start = tile_idx * te.TILE
    datas, valids = [], []
    for ci in col_order:
        d, v = te.DEVICE_CACHE.get_tile(table, an.scan.columns[ci], tile_idx,
                                        start, start + te.TILE, dev)
        datas.append(d)
        valids.append(v)
    args = (datas, valids, 3, te.TILE - 5, te._all_true(dev))
    PI = torch.from_numpy(np.stack([p[0] for p in params]))
    PF = torch.from_numpy(np.stack([p[1] for p in params]))
    out = fn(*args, PI, PF)
    for b, (pi, pf) in enumerate(params):
        one = solo(*args, torch.from_numpy(pi), torch.from_numpy(pf))
        if kind == "filter":
            assert torch.equal(out[0][b], one[0])
            continue
        assert torch.equal(out[0][b], one[0])  # group counts
        for got, want in zip(agg_leaves(out[1]), agg_leaves(one[1])):
            if want.dtype.is_floating_point:
                np.testing.assert_allclose(got[b].numpy(), want.numpy(),
                                           rtol=1e-9, atol=0)
            else:
                assert torch.equal(got[b], want), (got[b], want)


def test_np_batch_reads_back_every_dtype_exactly():
    """The one-copy readback keeps each tensor's dtype, shape and bits."""
    import torch

    from tidb_tpu_torch.copr.torch_engine import _np_batch

    ts = [torch.tensor([[1.5, -0.0, float("inf")], [2.0**-1074, 3.0, -7.25]],
                       dtype=torch.float64),
          torch.tensor([[2**62, -5], [7, -2**63]], dtype=torch.int64),
          torch.tensor([[-3], [2**31 - 1]], dtype=torch.int32),
          torch.tensor([[True, False], [False, True]])]
    for t, h in zip(ts, _np_batch(ts)):
        assert h.dtype == t.numpy().dtype and h.shape == tuple(t.shape)
        assert h.tobytes() == t.numpy().tobytes()


def test_fixed_order_float_sums_match_fsum(pair):
    """The batched G = 40 float sums equal math.fsum per group within
    relative 1e-12 (the fixed-order path sums each group directly)."""
    t = pair[1]
    arr = _arrays(N)
    serving.configure(microbatch_window_ms=5.0)
    rows = t.query("select h, sum(x) from t where g = 2 group by h")
    sel = arr[1] == 2
    for h, s in rows:
        want = math.fsum(arr[2][sel & (arr[4] == h)])
        assert s == pytest.approx(want, rel=1e-12), h

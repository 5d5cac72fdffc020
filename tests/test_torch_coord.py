"""The port's coordination plane (`tidb_tpu_torch/coord/`), in process.

The in-process cases of tests/test_coord.py that touch the port's code:
membership over real sockets and lease expiry, the epoch bumps of
breaker transitions, the mesh's dispatch-time epoch guard (the chaos
member loss mid-query rebuilds and answers with the JAX package's host
engine's rows), span forwarding and its byte cap, the session handoff,
and the status endpoint's coord section.  The statements run at
`use_device("cpu", shards=8)` (restored to one position at teardown).

Deliberate difference: an epoch that moves on every dispatch exhausts
the mesh's retries and the statement gets `CoordEpochMismatch`; the JAX
package steps down to its per-region rung there
(`test_epoch_flapping_exhausts_retries_and_steps_down`), the port has
no host step-down (ROADMAP Queue 3).
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

from tidb_tpu_torch import ops as tops
from tidb_tpu_torch.coord import (
    CoordEpochMismatch,
    get_plane,
    reset_plane,
)
from tidb_tpu_torch.coord.plane import Coordinator, WorkerPlane
from tidb_tpu_torch.copr.device_health import DEVICE_HEALTH, DeviceFailure
from tidb_tpu_torch.metrics import REGISTRY
from tidb_tpu_torch.session import Domain
from tidb_tpu_torch.store.fault import FAILPOINTS, failpoint
from tidb_tpu_torch.trace import finish_trace, recorder, span, start_trace

S = 8
Q1 = ("select g, sum(x), count(*), min(x), max(x), avg(x) from t "
      "group by g order by g")
Q6 = "select sum(x) from t where k < 15000 and x < 50"
TOPN = "select k, x from t order by x desc limit 7"
FILTER = "select k from t where x < 2.5"


def _load(d):
    """tests/test_coord.py's table: 20,000 rows in 4 regions."""
    s = d.new_session()
    s.execute("create table t (k bigint, g bigint, x double)")
    t = d.catalog.info_schema().table("test", "t")
    store = d.storage.table(t.id)
    rng = np.random.default_rng(7)
    n = 20_000
    store.bulk_load_arrays(
        [np.arange(n, dtype=np.int64),
         rng.integers(0, 5, n, dtype=np.int64),
         rng.uniform(0, 100, n)],
        ts=d.storage.current_ts())
    d.storage.regions.split_even(t.id, 4, store.base_rows)
    return s


@pytest.fixture(scope="module")
def pair():
    from tidb_tpu.session import Domain as JDomain

    tops.use_device("cpu", shards=S)
    js, ts = _load(JDomain()), _load(Domain())
    js.execute("set tidb_use_tpu = 0")
    ts.execute("set tidb_use_tpu = 1")
    yield js, ts
    tops.use_device("cpu")


@pytest.fixture(autouse=True)
def _plane_isolation():
    """The plane and device health are process-global: every test starts
    AND ends on the lazy local default with closed breakers."""
    reset_plane()
    DEVICE_HEALTH.reset()
    yield
    reset_plane()
    DEVICE_HEALTH.reset()


def _rows_eq(got, want, ctx=""):
    assert len(got) == len(want), (ctx, got, want)
    for ra, rb in zip(sorted(got), sorted(want)):
        for x, y in zip(ra, rb):
            if isinstance(x, float) or isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-9, abs=1e-9), (ctx, ra)
            else:
                assert x == y, (ctx, ra, rb)


def _wait(pred, timeout_s=5.0, tick=0.05):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(tick)
    return pred()


# ---------------------------------------------------------------------------
# protocol: membership, broadcast, lease expiry
# ---------------------------------------------------------------------------

def test_membership_register_report_broadcast():
    """Two workers join over real sockets; an unhealthy-position report
    on one bumps the epoch and every member converges on the same
    shrunken broadcast; recovery regrows it."""
    c = Coordinator(lease_s=30.0, expect=2)
    c.start()
    w1 = w2 = None
    try:
        w1 = WorkerPlane(("127.0.0.1", c.port), pid=1, lease_s=30.0,
                         heartbeat_s=0.2).start([0, 1, 2, 3])
        w2 = WorkerPlane(("127.0.0.1", c.port), pid=2, lease_s=30.0,
                         heartbeat_s=0.2).start([4, 5, 6, 7])
        v = c.view()
        assert set(v.members) == {1, 2} and v.formed
        assert v.members[1] == (0, 1, 2, 3)
        w2.on_health_change((5,), "trip")
        v2 = c.view()
        assert v2.epoch == v.epoch + 1
        assert v2.members[2] == (4, 6, 7)
        assert v2.device_ids() == frozenset({0, 1, 2, 3, 4, 6, 7})
        assert _wait(lambda: w1.current_epoch() == v2.epoch)
        assert w1.view().members[2] == (4, 6, 7)
        w2.on_health_change((), "recover")
        v3 = c.view()
        assert v3.epoch == v2.epoch + 1
        assert v3.members[2] == (4, 5, 6, 7)
    finally:
        for w in (w1, w2):
            if w is not None:
                w.stop()
        c.stop()


def test_member_lease_expiry_bumps_epoch():
    """A worker that stops heartbeating is expired within ~one lease,
    the epoch bumps, and the survivor observes the new broadcast."""
    c = Coordinator(lease_s=0.5, expect=2)
    c.start()
    w1 = w2 = None
    try:
        w1 = WorkerPlane(("127.0.0.1", c.port), pid=1,
                         lease_s=0.5).start([0])
        w2 = WorkerPlane(("127.0.0.1", c.port), pid=2,
                         lease_s=0.5).start([1])
        assert c.view().formed
        e0 = c.view().epoch
        x0 = REGISTRY.get("coord_members_expired_total")
        w2.stop()  # heartbeats cease
        assert _wait(lambda: 2 not in c.view().members, 5.0)
        v = c.view()
        assert v.epoch > e0 and v.formed
        assert REGISTRY.get("coord_members_expired_total") == x0 + 1
        assert _wait(lambda: 2 not in w1.view().members, 5.0)
    finally:
        for w in (w1, w2):
            if w is not None:
                w.stop()
        c.stop()


# ---------------------------------------------------------------------------
# one process: breaker transitions, the mesh's membership, the epoch guard
# ---------------------------------------------------------------------------

def test_local_plane_epoch_bumps_on_breaker_transitions(pair):
    """Trip, half-open probe and recovery of a mesh position each
    renumber the plane's epoch."""
    from tidb_tpu_torch.copr.parallel import _Card

    plane = get_plane()
    assert plane.kind == "local"
    e0 = plane.current_epoch()
    DEVICE_HEALTH.record_error(3, DeviceFailure("position 3 died",
                                                device_ids=(3,)))
    assert plane.current_epoch() == e0 + 1
    DEVICE_HEALTH.expire_cooldowns()
    DEVICE_HEALTH.select_devices([_Card(i) for i in tops.device_ids()])
    assert plane.current_epoch() == e0 + 2
    DEVICE_HEALTH.record_success([3])
    assert plane.current_epoch() == e0 + 3


def test_local_membership_published_on_mesh_build(pair):
    """The mesh builder publishes its healthy positions to the plane."""
    _js, ts = pair
    ts.query(Q6)
    view = get_plane().view()
    assert set(view.members) == {0}
    assert sorted(view.device_ids()) == list(range(S))
    assert view.formed


@pytest.mark.parametrize("sql", [Q1, Q6, TOPN, FILTER],
                         ids=["q1", "q6", "topn", "filter"])
def test_chaos_member_lost_mid_query_rebuilds_with_parity(pair, sql):
    """An epoch bump between mesh build and dispatch raises the typed
    CoordEpochMismatch; the mesh rebuilds and the statement re-runs
    with the JAX host engine's rows, tripping no breaker."""
    js, ts = pair
    plane = get_plane()
    fired = {"n": 0}

    def bump_once(**_ctx):
        if fired["n"] == 0:
            plane.bump("chaos: member lost")
        fired["n"] += 1

    m0 = REGISTRY.get("coord_epoch_mismatch_total")
    with failpoint("coord/member_lost", bump_once):
        got = ts.query(sql)
    _rows_eq(got, js.query(sql), sql)
    assert fired["n"] >= 2, fired
    assert REGISTRY.get("coord_epoch_mismatch_total") == m0 + 1
    assert DEVICE_HEALTH.tripped_ids() == ()
    assert FAILPOINTS.armed() == []
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("tidb-tpu-select")]
    assert not alive, alive


def test_epoch_flapping_exhausts_retries_and_raises(pair):
    """An epoch that moves on EVERY dispatch exhausts the mesh's retry
    budget; the statement gets the typed CoordEpochMismatch (no host
    step-down in the port), never a hang and never a breaker trip."""
    _js, ts = pair
    plane = get_plane()
    m0 = REGISTRY.get("coord_epoch_mismatch_total")
    with failpoint("coord/member_lost",
                   lambda **_c: plane.bump("chaos: flapping")):
        with pytest.raises(CoordEpochMismatch):
            ts.query(Q6)
    assert REGISTRY.get("coord_epoch_mismatch_total") >= m0 + 3
    assert DEVICE_HEALTH.tripped_ids() == ()
    assert FAILPOINTS.armed() == []
    assert ts.query("select count(*) from t") == [(20_000,)]


def test_epoch_mismatch_error_is_typed_and_retriable(pair):
    from tidb_tpu_torch.copr import parallel as pl
    from tidb_tpu_torch.copr.device_health import classify_failure

    assert classify_failure(CoordEpochMismatch(3, 4)) is None
    _js, ts = pair
    plane = get_plane()
    ts.query(Q6)  # mesh built + stamped
    assert pl.mesh_epoch() == plane.current_epoch()
    plane.bump("out-of-band member change")
    with failpoint("coord/member_lost", lambda **_c: None):
        with pytest.raises(CoordEpochMismatch):
            pl._check_membership_epoch()


# ---------------------------------------------------------------------------
# span forwarding: one tree spanning processes
# ---------------------------------------------------------------------------

def test_span_forwarding_grafts_one_tree():
    c = Coordinator(lease_s=30.0)
    c.start()
    w = None
    try:
        tr_local, tok = start_trace("select 1", 1)
        finish_trace(tr_local, tok)
        w = WorkerPlane(("127.0.0.1", c.port), pid=7,
                        lease_s=30.0).start([0])
        assert recorder.TRACE_EXPORT_HOOK is not None
        tr_w, tok_w = start_trace("select 1", 9)
        with span("copr.device.execute"):
            pass
        tr_w.qid = tr_local.qid  # the SPMD statement-seq correlation
        f0 = REGISTRY.get("coord_spans_forwarded_total")
        g0 = REGISTRY.get("coord_spans_grafted_total")
        finish_trace(tr_w, tok_w)
        w.flush_spans()
        assert REGISTRY.get("coord_spans_forwarded_total") == f0 + 1
        assert REGISTRY.get("coord_spans_grafted_total") == g0 + 1
        remote = [s for s in tr_local.root.children
                  if (s.attrs or {}).get("host") == 7]
        assert len(remote) == 1
        assert any(ch.name == "copr.device.execute"
                   for ch in remote[0].children)
        rendered = "\n".join(r[0] for r in tr_local.rows())
        assert "host: 7" in rendered and "copr.device.execute" in rendered
    finally:
        if w is not None:
            w.stop()
        c.stop()


def test_span_forwarding_respects_byte_cap(monkeypatch):
    monkeypatch.setenv("TIDB_TPU_COORD_SPAN_CAP", "64")
    c = Coordinator(lease_s=30.0)
    c.start()
    w = None
    try:
        w = WorkerPlane(("127.0.0.1", c.port), pid=3,
                        lease_s=30.0).start([0])
        d0 = REGISTRY.get("coord_spans_dropped_total")
        f0 = REGISTRY.get("coord_spans_forwarded_total")
        tr, tok = start_trace("select 'oversized payload'", 3)
        finish_trace(tr, tok)
        w.flush_spans()
        assert REGISTRY.get("coord_spans_dropped_total") == d0 + 1
        assert REGISTRY.get("coord_spans_forwarded_total") == f0
    finally:
        if w is not None:
            w.stop()
        c.stop()


# ---------------------------------------------------------------------------
# session handoff and the status endpoint
# ---------------------------------------------------------------------------

def test_local_handoff_replay_loop():
    """Single-process handoff loop: collect -> park -> take -> replay."""
    from tidb_tpu_torch.lifecycle import (
        collect_session_states,
        replay_session_states,
    )

    d = Domain()
    try:
        s = d.new_session()
        s.execute("set tidb_slow_log_threshold = 777")
        s.execute("prepare px from 'select 6 * 7'")
        states = collect_session_states(d)
        assert len(states) == 1 and states[0]["prepared"]
        json.dumps(states)  # strictly JSON-portable
        plane = get_plane()
        plane.handoff_put(states)
        d2 = Domain()
        try:
            assert replay_session_states(d2, plane.take_handoff()) == 1
            sess2 = next(s2 for s2 in d2.sessions.values()
                         if getattr(s2, "handoff_origin", None) is not None)
            assert sess2.query("execute px") == [(42,)]
            assert sess2.vars.get_int("tidb_slow_log_threshold") == 777
            assert plane.take_handoff() == []  # consumed exactly once
        finally:
            d2.maintenance.stop()
    finally:
        d.maintenance.stop()


def test_status_endpoint_reports_coord_section():
    from tidb_tpu_torch.server.http_status import StatusServer

    d = Domain()
    ss = StatusServer(d, port=0)
    host, port = ss.start()
    try:
        body = json.loads(urllib.request.urlopen(
            f"http://{host}:{port}/status", timeout=5).read())
        coord = body["coord"]
        assert coord["kind"] == "local"
        assert coord["epoch"] >= 1
        assert "coord_epoch_bumps_total" in coord["metrics"]
        assert "coord_handoff_replayed_total" in coord["metrics"]
    finally:
        ss.stop()
        d.maintenance.stop()

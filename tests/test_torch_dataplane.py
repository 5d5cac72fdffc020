"""The port's sharded data plane (`tidb_tpu_torch/dataplane/`).

The cases of tests/test_dataplane.py and the two-process acceptance of
tests/test_dataplane_procs.py, on the port: the partition map
(determinism, minimal motion, the typed mismatch), the packed-block
round trip, the one-member plane (parity and introspection), the DML
bypass, two in-process members (exchange parity, survivor re-shard,
persisted packed blocks replayed) and two OS processes
(tests/torch_dataplane_worker.py: every round served by the data plane
with parity, then SIGKILL of one member, the epoch bump, the survivor's
re-shard and parity at the new epoch, still through the data plane).

Every partition fragment runs on the member's device through the mesh
program (`dataplane_card_fragments_total`); the host engine runs none
(`cop_region_cpu_runs_total` does not move).  Rows are held to the
JAX package's host engine on the same lineitem build.
"""

import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tidb_tpu_torch import ops as tops
from tidb_tpu_torch.coord import get_plane
from tidb_tpu_torch.coord.plane import (Coordinator, CoordinatorPlane,
                                        WorkerPlane)
from tidb_tpu_torch.dataplane import (PartitionMapMismatch,
                                      activate_dataplane,
                                      build_partition_map,
                                      deactivate_dataplane)
from tidb_tpu_torch.dataplane.shard import _pack_column, _unpack_column
from tidb_tpu_torch.metrics import REGISTRY
from tidb_tpu_torch.store.fault import FAILPOINTS
from tidb_tpu_torch.tpch_data import build_lineitem

Q6 = ("select sum(l_extendedprice * l_discount) from lineitem "
      "where l_shipdate >= '1994-01-01' and l_shipdate < '1995-01-01' "
      "and l_discount between 0.05 and 0.07 and l_quantity < 24")
Q1 = ("select l_returnflag, l_linestatus, sum(l_quantity), "
      "sum(l_extendedprice), avg(l_discount), count(*) from lineitem "
      "where l_shipdate <= '1998-09-02' group by l_returnflag, "
      "l_linestatus order by l_returnflag, l_linestatus")
GROUPED = ("select l_returnflag, count(*), sum(l_quantity) from lineitem "
           "group by l_returnflag order by l_returnflag")


def _cnt(name):
    return REGISTRY.get(name) or 0.0


_JAX = {}


def _jax_rows(n, sql):
    """The JAX package's host engine on the same lineitem build."""
    if n not in _JAX:
        import tidb_tpu.tpch_data as jdata

        s = jdata.build_lineitem(n, regions=4)
        s.execute("set tidb_use_tpu = 0")
        _JAX[n] = s
    return _JAX[n].execute(sql)[0].rows


@pytest.fixture(autouse=True)
def _on_host():
    tops.use_device("cpu")


class _View:
    def __init__(self, epoch, members):
        self.epoch = epoch
        self.members = {p: () for p in members}
        self.addrs = {}
        self.formed = True


# ---------------------------------------------------------------------------
# partition map and packed blocks (pure)
# ---------------------------------------------------------------------------

def test_partition_map_deterministic_and_epoch_numbered():
    a = build_partition_map(_View(7, [0, 1, 2]), 16)
    assert a == build_partition_map(_View(7, [2, 1, 0]), 16)
    assert a.epoch == 7 and a.n_parts == 16
    assert set(a.owners) == {0, 1, 2}


def test_partition_map_minimal_motion_on_member_loss():
    before = build_partition_map(_View(1, [0, 1, 2]), 32)
    after = build_partition_map(_View(2, [0, 2]), 32)
    for p in range(32):
        if before.owners[p] != 1:
            assert after.owners[p] == before.owners[p]
        else:
            assert after.owners[p] in (0, 2)


def test_partition_map_mismatch_typed_like_coord_epoch_mismatch():
    pmap = build_partition_map(_View(3, [0]), 4)
    pmap.check(3)
    with pytest.raises(PartitionMapMismatch) as ei:
        pmap.check(5)
    assert ei.value.built_at == 3 and ei.value.current == 5
    msg = str(ei.value).lower()
    for word in ("device", "cuda", "gpu", "card"):
        assert word not in msg


@pytest.mark.parametrize("card", [2, 3, 11, 200, 4000])
def test_pack_roundtrip_all_widths(card):
    rng = np.random.default_rng(card)
    codes = rng.integers(0, card, size=777).astype(np.int32)
    payload, bits = _pack_column(codes, card)
    assert (_unpack_column(payload, bits, len(codes)) == codes).all()
    if card <= 256:
        assert bits in (1, 2, 4, 8)
        assert payload.nbytes <= codes.nbytes // (8 // bits) + 8
    else:
        assert bits == 0


# ---------------------------------------------------------------------------
# one member (LocalPlane): every partition local
# ---------------------------------------------------------------------------

def test_localplane_dataplane_parity_and_introspection(tmp_path):
    sess = build_lineitem(4096, regions=4)
    sess.execute("set tidb_use_tpu = 1")
    storage = sess.domain.storage
    tid = sess.domain.catalog.info_schema().table("test", "lineitem").id
    dp = activate_dataplane(storage, plane=get_plane(), pid=0,
                            data_dir=str(tmp_path), serve=False)
    try:
        st = dp.shard_table(tid)
        assert sorted(st.loaded) == list(range(st.n_parts))
        for q in (Q1, Q6, GROUPED):
            before = _cnt("dataplane_queries_total")
            card, cpu = (_cnt("dataplane_card_fragments_total"),
                         _cnt("cop_region_cpu_runs_total"))
            assert sess.execute(q)[0].rows == _jax_rows(4096, q)
            assert _cnt("dataplane_queries_total") == before + 1
            # every fragment on the card, none on the host engine
            assert _cnt("dataplane_card_fragments_total") >= \
                card + st.n_parts
            assert _cnt("cop_region_cpu_runs_total") == cpu
        rows = sess.execute(
            "select table_id, partition_id, row_start, row_end, "
            "owner_pid, local from information_schema."
            "tidb_tpu_partition_map order by partition_id")[0].rows
        assert len(rows) == st.n_parts
        assert all(r[0] == tid and r[4] == 0 and r[5] == 1 for r in rows)
        assert rows[0][2] == 0 and rows[-1][3] == 4096
        for a, b in zip(rows, rows[1:]):
            assert a[3] == b[2]
        assert dp.snapshot()["tables"][tid]["n_rows"] == 4096
    finally:
        deactivate_dataplane(storage)
    assert all(t < (1 << 28) for t in storage.table_ids())


def test_dataplane_bypasses_on_dml_delta():
    sess = build_lineitem(2048, regions=4)
    sess.execute("set tidb_use_tpu = 1")
    storage = sess.domain.storage
    tid = sess.domain.catalog.info_schema().table("test", "lineitem").id
    dp = activate_dataplane(storage, plane=get_plane(), pid=0, serve=False)
    try:
        dp.shard_table(tid)
        before_q = _cnt("dataplane_queries_total")
        sess.execute(Q6)
        assert _cnt("dataplane_queries_total") == before_q + 1
        sess.execute(
            "insert into lineitem values "
            "(999999, 1.0, 10.0, 0.06, 0.02, 'N', 'O', '1994-06-01')")
        before_b = _cnt("dataplane_bypass_total")
        got = sess.execute(
            "select count(*) from lineitem where l_orderkey = 999999"
        )[0].rows
        assert got == [(1,)]
        assert _cnt("dataplane_bypass_total") > before_b
        assert _cnt("dataplane_queries_total") == before_q + 1
    finally:
        deactivate_dataplane(storage)


# ---------------------------------------------------------------------------
# two in-process members: real exchange, survivor re-shard
# ---------------------------------------------------------------------------

def _wait(pred, timeout=10.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError("condition not reached in %.1fs" % timeout)


def _fleet(tmp_path, rf=None):
    """Coordinator member (pid 0) + worker member (pid 1), each with its
    own Domain holding the same lineitem build."""
    sA = build_lineitem(4096, regions=4)
    sB = build_lineitem(4096, regions=4)
    for s in (sA, sB):
        s.execute("set tidb_use_tpu = 1")
    coord = Coordinator(port=0, lease_s=4.0, expect=2, self_pid=0)
    host, port = coord.start()
    cp = CoordinatorPlane(coord, pid=0).start((0,))
    wp = WorkerPlane(f"{host}:{port}", 1, lease_s=4.0).start((1,))
    _wait(lambda: cp.view().formed and len(cp.view().members) == 2)
    dpA = activate_dataplane(sA.domain.storage, plane=cp, pid=0,
                             data_dir=str(tmp_path), rf=rf)
    dpB = activate_dataplane(sB.domain.storage, plane=wp, pid=1,
                             data_dir=str(tmp_path), rf=rf)
    _wait(lambda: len(cp.view().addrs) == 2 and len(wp.view().addrs) == 2)
    try:
        yield sA, sB, cp, wp, dpA, dpB
    finally:
        deactivate_dataplane(sA.domain.storage)
        deactivate_dataplane(sB.domain.storage)
        try:
            wp.stop(leave=True)
        except Exception:
            pass
        cp.stop()


@pytest.fixture
def two_member_fleet(tmp_path):
    yield from _fleet(tmp_path)


@pytest.fixture
def two_member_fleet_rf1(tmp_path):
    yield from _fleet(tmp_path, rf=1)


def _lose_member_1(sB, cp, wp):
    epoch_before = cp.view().epoch
    wp.stop(leave=True)
    deactivate_dataplane(sB.domain.storage)
    _wait(lambda: 1 not in cp.view().members)
    assert cp.view().epoch > epoch_before


def test_two_member_exchange_parity_and_survivor_reshard(two_member_fleet):
    sA, sB, cp, wp, dpA, dpB = two_member_fleet
    tid = sA.domain.catalog.info_schema().table("test", "lineitem").id
    stA = dpA.shard_table(tid)
    stB = dpB.shard_table(tid)
    pmap = dpA.sync()
    primA, primB = set(pmap.owned_by(0)), set(pmap.owned_by(1))
    assert primA.isdisjoint(primB)
    assert sorted(primA | primB) == list(range(stA.n_parts))
    assert sorted(stA.loaded) == sorted(pmap.replica_of(0))
    assert sorted(stB.loaded) == sorted(pmap.replica_of(1))

    before_remote = _cnt("dataplane_remote_fragments_total")
    before_bytes = _cnt("dataplane_exchange_bytes_total")
    cpu = _cnt("cop_region_cpu_runs_total")
    assert sA.execute(Q6)[0].rows == _jax_rows(4096, Q6)
    assert sA.execute(Q1)[0].rows == _jax_rows(4096, Q1)
    assert _cnt("dataplane_remote_fragments_total") > before_remote
    assert _cnt("dataplane_exchange_bytes_total") > before_bytes
    assert sB.execute(Q6)[0].rows == _jax_rows(4096, Q6)
    assert _cnt("cop_region_cpu_runs_total") == cpu

    _lose_member_1(sB, cp, wp)
    before_reshard = _cnt("dataplane_reshards_total")
    before_q = _cnt("dataplane_queries_total")
    before_promote = _cnt("dataplane_replica_promotions_total")
    before_cold = _cnt("dataplane_cold_reloads_total")
    assert sA.execute(Q6)[0].rows == _jax_rows(4096, Q6)
    assert _cnt("dataplane_reshards_total") == before_reshard + 1
    assert _cnt("dataplane_queries_total") == before_q + 1
    assert sorted(stA.loaded) == list(range(stA.n_parts))
    # at RF = 2 the survivor already held the lost member's partitions
    assert _cnt("dataplane_replica_promotions_total") > before_promote
    assert _cnt("dataplane_cold_reloads_total") == before_cold
    assert sA.execute(Q1)[0].rows == _jax_rows(4096, Q1)


def test_survivor_reshard_replays_persisted_packed_blocks(
        two_member_fleet_rf1):
    sA, sB, cp, wp, dpA, dpB = two_member_fleet_rf1
    tid = sA.domain.catalog.info_schema().table("test", "lineitem").id
    dpA.shard_table(tid)
    dpB.shard_table(tid)
    _lose_member_1(sB, cp, wp)
    before_packed = _cnt("dataplane_replay_packed_total")
    before_q = _cnt("dataplane_queries_total")
    assert sA.execute(GROUPED)[0].rows == _jax_rows(4096, GROUPED)
    assert _cnt("dataplane_replay_packed_total") > before_packed
    assert _cnt("dataplane_queries_total") == before_q + 1


# ---------------------------------------------------------------------------
# two OS processes: SIGKILL one member
# ---------------------------------------------------------------------------

def _spawn_worker(pid, port, dp_dir, log):
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))) + os.pathsep + env.get("PYTHONPATH", "")
    env["COORD_LEASE_S"] = "1.5"
    env["COORD_WORKER_MAX_S"] = "150"
    env["TIDB_TPU_DATAPLANE_DIR"] = dp_dir
    env["TIDB_TPU_DATAPLANE_RF"] = "1"
    env["COORD_EXPECT"] = "2"
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_dataplane_worker.py")
    return subprocess.Popen([sys.executable, worker, str(pid), str(port)],
                            stdout=open(log, "w"), stderr=subprocess.STDOUT,
                            env=env)


def _lines(log):
    try:
        return [ln.strip() for ln in open(log)]
    except FileNotFoundError:
        return []


def _wait_line(log, pred, timeout_s, proc):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if any(pred(ln) for ln in _lines(log)):
            return True
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    return any(pred(ln) for ln in _lines(log))


def _field(s, key):
    try:
        return int(s.split(f"{key}=")[1].split()[0])
    except (IndexError, ValueError):
        return -1


def _dp_round(s):
    """A parity round the data plane served whole, on the card."""
    return (s.startswith("ROUND") and "ok=1" in s and _field(s, "dp") >= 5
            and _field(s, "card") >= 5 and _field(s, "cpu") == 0
            and _field(s, "bypass") == 0)


def test_two_process_dataplane_shard_and_sigkill_reshard(tmp_path):
    threads_before = {t.name for t in threading.enumerate()}
    c = Coordinator(lease_s=1.5, expect=2)
    c.start()
    logs = [str(tmp_path / f"member{p}.log") for p in (0, 1)]
    dp_dir = str(tmp_path / "dp")
    procs = []
    try:
        w0 = _spawn_worker(0, c.port, dp_dir, logs[0])
        procs.append(w0)
        w1 = _spawn_worker(1, c.port, dp_dir, logs[1])
        procs.append(w1)
        for w, log in zip(procs, logs):
            assert _wait_line(log, lambda s: s.startswith("READY"), 90, w), \
                _lines(log)[-10:]
        v = c.view()
        assert set(v.members) == {0, 1} and v.formed
        assert set(v.addrs) == {0, 1}, v.addrs
        sh = [next(s for s in _lines(log) if s.startswith("SHARDED"))
              for log in logs]
        n0, n1 = (int(s.split("loaded=")[1].split("/")[0]) for s in sh)
        total = int(sh[0].split("/")[1])
        assert 0 < n0 < total and 0 < n1 < total and n0 + n1 == total, sh
        for w, log in zip(procs, logs):
            assert _wait_line(log, _dp_round, 60, w), _lines(log)[-5:]

        e_before = c.view().epoch
        w1.kill()
        t = time.time()
        while 1 in c.view().members and time.time() - t < 15:
            time.sleep(0.1)
        assert 1 not in c.view().members, "lease expiry did not evict"
        v_after = c.view()
        assert v_after.epoch > e_before
        assert _wait_line(
            logs[0], lambda s: _dp_round(s)
            and f"epoch={v_after.epoch}" in s, 45, w0), _lines(logs[0])[-5:]
        post = [s for s in _lines(logs[0]) if s.startswith("ROUND")
                and f"epoch={v_after.epoch}" in s]
        # RF = 1: the orphaned partitions replay from the persisted blocks
        assert _field(post[-1], "cold") > 0, post[-1]
        bad = [s for s in _lines(logs[0])
               if "ok=0" in s or s.startswith("MISMATCH")]
        assert not bad, bad

        w0.send_signal(signal.SIGTERM)
        assert _wait_line(logs[0], lambda s: s.startswith("DRAINED"), 30,
                          w0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        c.stop()
    time.sleep(0.3)
    leaked = {t.name for t in threading.enumerate()} - threads_before
    leaked = {n for n in leaked
              if n.startswith(("tidb-tpu-coord", "dataplane-rpc"))}
    assert not leaked, leaked
    assert FAILPOINTS.armed() == []

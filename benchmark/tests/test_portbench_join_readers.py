"""The join cell's two per-layer readers on small windows recorded from
the port itself: Q3 on the keyed schema at 1/600 of SF10 on the CPU,
once through the MPP join tree and once with the joins on the host."""

import pytest

from benchmark import harness
from benchmark import profile_events as pe
from tidb_tpu_torch import ops
from tidb_tpu_torch.metrics import REGISTRY
from tidb_tpu_torch.planner import physical
from tidb_tpu_torch.session import Domain

SCALE = 10 / 600
CELL = harness.load_cell("sf10_join_s3")
SQL = CELL.shapes["q3"]["sql"].format(segment="MACHINERY", date="1995-03-15")


def _read(name, w):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py").read(w)


@pytest.fixture(scope="module")
def domain():
    ops.use_device("cpu")
    sess = Domain().new_session()
    harness.build_tables(sess, CELL.config, 11, SCALE, "cpu")
    return sess.domain


def _window(domain, use_tpu):
    """One traced statement's window: its spans and the counters' moves."""
    sess = domain.new_session()
    sess.execute(f"set tidb_use_tpu = {use_tpu}")
    sess.query(SQL)                                   # plans and warms
    snap0 = REGISTRY.snapshot()
    sess.execute("trace " + SQL)
    snap1 = REGISTRY.snapshot()
    stmt = {"shape": "q3", "t_send": 0.0, "t_done": 0.1, "ok": 1,
            "rows_read": 1, "bytes_least": 1.0}
    return harness.Window(
        seconds=1.0, setup_s=1.0, stmts=[stmt], in_window=[stmt],
        spans=pe.flatten(sess.last_trace.root), n_traces=1,
        counters={k: snap1.get(k, 0) - snap0.get(k, 0)
                  for k in set(snap0) | set(snap1)})


def test_a_tree_run_joins_nothing_on_the_host(domain, monkeypatch):
    monkeypatch.setattr(physical, "DEVICE_JOIN_BUILD_MAX",
                        int(physical.DEVICE_JOIN_BUILD_MAX * SCALE / 10))
    w = _window(domain, 1)
    assert _read("host_join_rows_per_stmt", w) == 0
    assert _read("join_tree_ms", w) > 0


def test_a_host_run_joins_rows_on_the_host(domain):
    w = _window(domain, 0)
    assert _read("host_join_rows_per_stmt", w) > 0
    assert _read("join_tree_ms", w) == 0


def test_a_program_without_the_counter_or_traces_reads_nothing():
    w = harness.Window(seconds=1.0, setup_s=1.0)
    assert _read("host_join_rows_per_stmt", w) is None
    assert _read("join_tree_ms", w) is None

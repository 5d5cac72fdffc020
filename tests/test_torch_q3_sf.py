"""TPC-H Q3 on the keyed schema of the benchmark's `tpch_sf10_q3_keyed`
configuration, at 1/200 of SF10 on the CPU (7,500 customers, 75,000
orders, ~300 k lines, unanalyzed, as the configuration loads them),
against the benchmark's plain reference (`benchmark/shapes/q3.py`),
row for row: every market segment, the first and last day of the
spec's date range, two seeds.

- The planner's default route at this size: customer ⋈ orders is small
  enough to broadcast into the lineitem scan.
- The SF10 route: with the broadcast cap scaled by the same 1/200 the
  build side is over it, as it is at SF10, and the whole join goes to
  the MPP join tree with its grouped final on the card.
- The tree's grouped final past 32,768 groups (the fixed gate the tree
  had before its group limit followed the card) and with no peel.
- A TopN over the tree's groups keeps its k groups on the card: the same
  rows as the whole grouped result sorted on the host, in either
  direction and past an offset."""

import numpy as np
import pytest
import torch

from benchmark import harness
from tidb_tpu_torch import ops
from tidb_tpu_torch.metrics import REGISTRY
from tidb_tpu_torch.planner import physical
from tidb_tpu_torch.session import Domain

SCALE = 10 / 200
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
DATES = ["1995-03-01", "1995-03-31"]
#: the counters that move when the tree leaves the card or re-runs
OVERFLOWS = ("mpp_tree_emit_overflow_total", "mpp_partition_overflow_total",
             "mpp_tree_fallback_total", "mpp_grouped_agg_overflow_total",
             "mpp_grouped_agg_fallback_total", "host_join_rows_total")
CELL = harness.load_cell("sf10_join_s3")
Q3 = CELL.shapes["q3"]


@pytest.fixture(scope="module", params=[3, 2**31 + 9])
def loaded(request):
    ops.use_device("cpu")
    sess = Domain().new_session()
    data = harness.build_tables(sess, CELL.config, request.param, SCALE,
                                "cpu")
    tables = {t: {c: torch.from_numpy(a) for c, a in cols.items()}
              for t, cols in data.items()}
    return sess.domain, tables


def _session(domain):
    """A session of its own: plans cached by another test's session do
    not serve its statements."""
    sess = domain.new_session()
    sess.execute("set tidb_use_tpu = 1")
    return sess


def _snap():
    s = REGISTRY.snapshot()
    return {n: s.get(n, 0) for n in OVERFLOWS + ("mpp_tree_groups_total",)}


def _wire(rows):
    """Rows as the wire renders them (the reference's form)."""
    return [tuple(str(v) for v in r) for r in rows]


def _plan(sess, sql):
    return [" ".join(str(x) for x in r)
            for r in sess.execute("explain analyze " + sql)[0].rows]


def _params():
    return [{"segment": s, "date": d} for s in SEGMENTS for d in DATES]


def test_default_route_equals_the_reference(loaded):
    domain, tables = loaded
    sess = _session(domain)
    for p in _params():
        sql = Q3["sql"].format(**p)
        assert _wire(sess.query(sql)) == Q3["module"].reference(tables, p), p


@pytest.fixture
def sf10_route(monkeypatch):
    """The broadcast cap scaled as the tables are: the build side is over
    it, as at SF10."""
    monkeypatch.setattr(physical, "DEVICE_JOIN_BUILD_MAX",
                        int(physical.DEVICE_JOIN_BUILD_MAX * SCALE / 10))


def test_sf10_route_is_the_join_tree_and_equals_the_reference(loaded,
                                                              sf10_route):
    domain, tables = loaded
    sess = _session(domain)
    plan = _plan(sess, Q3["sql"].format(**_params()[0]))
    assert any("MPPJoinTree" in ln and "+grouped" in ln for ln in plan), plan
    assert not any("IndexLookUpJoin" in ln or "HashJoin" in ln
                   for ln in plan), plan
    assert not any("agg-peel" in ln for ln in plan), plan
    before = _snap()
    for p in _params():
        sql = Q3["sql"].format(**p)
        assert _wire(sess.query(sql)) == Q3["module"].reference(tables, p), p
    after = _snap()
    assert all(after[n] == before[n] for n in OVERFLOWS), (before, after)
    assert after["mpp_tree_groups_total"] > before["mpp_tree_groups_total"]


def test_tree_groups_past_the_old_gate_without_a_peel(loaded, sf10_route):
    """Every order of every segment, one group each: 75,000 groups."""
    domain, tables = loaded
    sess = _session(domain)
    sql = ("select l_orderkey, sum(l_extendedprice * (1 - l_discount)),"
           " o_orderdate, o_shippriority from customer, orders, lineitem"
           " where c_custkey = o_custkey and l_orderkey = o_orderkey"
           " group by l_orderkey, o_orderdate, o_shippriority"
           " order by l_orderkey")
    plan = _plan(sess, sql)
    assert any("MPPJoinTree" in ln and "+grouped" in ln for ln in plan), plan
    before = _snap()
    got = sess.query(sql)
    after = _snap()
    assert all(after[n] == before[n] for n in OVERFLOWS), (before, after)
    assert after["mpp_tree_groups_total"] - before[
        "mpp_tree_groups_total"] > 1 << 15

    li, od, cu = tables["lineitem"], tables["orders"], tables["customer"]
    keys = od["o_orderkey"].numpy()
    placed = np.isin(od["o_custkey"].numpy(), cu["c_custkey"].numpy())
    at = np.searchsorted(keys, li["l_orderkey"].numpy())
    rev = li["l_extendedprice"].numpy() * (100 - li["l_discount"].numpy())
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, at, rev)
    seen = np.bincount(at, minlength=len(keys)) > 0
    want = [(int(k), repr(int(s) / 10**4), str(d), 0) for k, s, d in zip(
        keys[seen & placed], sums[seen & placed],
        od["o_orderdate"].numpy()[seen & placed].astype("datetime64[D]"))]
    assert len(want) > 1 << 15
    assert [(int(r[0]), repr(float(r[1])), str(r[2]), int(r[3]))
            for r in got] == want


@pytest.mark.parametrize("order,limit", [
    ("revenue desc, o_orderdate", "10"),
    ("revenue, l_orderkey desc", "3, 5"),
    ("o_orderdate desc, revenue desc", "7"),
])
def test_topn_over_the_tree_keeps_k_groups_on_the_card(loaded, sf10_route,
                                                       order, limit):
    domain, _tables = loaded
    sess = _session(domain)
    body = ("select l_orderkey, sum(l_extendedprice * (1 - l_discount))"
            " as revenue, o_orderdate, o_shippriority"
            " from customer, orders, lineitem"
            " where c_mktsegment in ('BUILDING', 'MACHINERY')"
            " and c_custkey = o_custkey and l_orderkey = o_orderkey"
            " and o_orderdate < '1995-03-31' and l_shipdate > '1995-03-01'"
            " group by l_orderkey, o_orderdate, o_shippriority")
    sql = f"{body} order by {order} limit {limit}"
    plan = _plan(sess, sql)
    assert any("+grouped+top" in ln for ln in plan), plan
    whole = _session(domain).query(f"{body} order by {order}, l_orderkey")
    skip, _, take = limit.rpartition(",")
    skip = int(skip or 0)
    want = whole[skip:skip + int(take)]
    assert _wire(sess.query(sql)) == _wire(want)

"""TPC-H Q3 on the keyed schema of the benchmark's `tpch_sf10_q3_keyed`
configuration, the port against the JAX package on the same tables: one
set of generated arrays, at 1/200 of SF10 (7,500 customers, 75,000
orders, ~300 k lines, unanalyzed), is loaded into a port `Domain`
(`tidb_use_tpu = 1`, torch on the CPU) and into a JAX-package `Domain`
that answers through its host engine (`tidb_use_tpu = 0`).

- The planner's default route at this size, every market segment at
  the first and last day of the spec's date range.
- The SF10 route (the broadcast cap scaled by the same 1/200, as
  `tests/test_torch_q3_sf.py` forces it): the MPP join tree, its grouped
  final and the TopN of 10 on the card (`+grouped+top10`).
- A TopN over the tree's groups in three orders, two of them past an
  offset, each kept on the card (`+grouped+top`).

The JAX package's host sort ranks DECIMAL(38, s) sums by their digits
(tests/test_torch_join.py), so each ordered statement is held to the
JAX package's rows of its body (the statement without its ORDER BY and
LIMIT), sorted here by value."""

import pytest

from benchmark import harness, traffic
from tidb_tpu_torch import ops
from tidb_tpu_torch.metrics import REGISTRY
from tidb_tpu_torch.planner import physical

SCALE = 10 / 200
SEED = 2**31 + 9
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
DATES = ["1995-03-01", "1995-03-31"]
CELL = harness.load_cell("sf10_join_s3")
Q3 = CELL.shapes["q3"]["sql"]
#: the counters that move when the tree leaves the card or re-runs
OVERFLOWS = ("mpp_tree_emit_overflow_total", "mpp_partition_overflow_total",
             "mpp_tree_fallback_total", "mpp_grouped_agg_overflow_total",
             "mpp_grouped_agg_fallback_total", "host_join_rows_total")
#: the select list's columns: l_orderkey, revenue, o_orderdate,
#: o_shippriority
COL = {"l_orderkey": 0, "revenue": 1, "o_orderdate": 2, "o_shippriority": 3}


def _load(domain, made, config):
    """Create and bulk-load the configuration's tables into `domain`
    from the generator's arrays, split as the configuration says."""
    sess = domain.new_session()
    ts = domain.storage.current_ts()
    for t in config["tables"]:
        arrays, dicts = made[t["name"]]
        sess.execute(t["ddl"])
        tid = domain.catalog.info_schema().table("test", t["name"]).id
        domain.storage.table(tid).bulk_load_arrays(arrays, ts=ts,
                                                   dictionaries=dicts)
        if t["regions"] > 1:
            sess.execute(f"split table {t['name']} regions {t['regions']}")
    return sess


@pytest.fixture(scope="module")
def pair():
    """(JAX session on its host engine, port domain), same tables."""
    from tidb_tpu.session import Domain as JDomain
    from tidb_tpu_torch.session import Domain as TDomain

    ops.use_device("cpu")
    config = CELL.config
    gen = harness.load_module(harness.HERE / "generators"
                              / f"{config['generator']}.py")
    made = gen.generate(SCALE, traffic.seed_for(SEED, config["seed_salt"]),
                        [t["name"] for t in config["tables"]], "cpu")
    js = _load(JDomain(), made, config)
    js.execute("set tidb_use_tpu = 0")
    tdomain = TDomain()
    _load(tdomain, made, config)
    return js, tdomain


def _session(domain):
    """A port session of its own: plans cached by another test's session
    do not serve its statements."""
    sess = domain.new_session()
    sess.execute("set tidb_use_tpu = 1")
    return sess


def _wire(rows):
    return [tuple(str(v) for v in r) for r in rows]


def _modes(sess, sql):
    return [str(r[4]) for r in sess.execute("explain analyze " + sql)[0].rows
            if "engine:mpp-tree" in str(r[4])]


def _ordered(rows, order: str, limit: str):
    """`rows` sorted as `order by <order> limit <limit>` sorts them:
    stable passes from the last item to the first."""
    rows = list(rows)
    for item in reversed([i.strip() for i in order.split(",")]):
        name, _, way = item.partition(" ")
        rows.sort(key=lambda r, c=COL[name]: r[c], reverse=way == "desc")
    skip, _, take = limit.rpartition(",")
    skip = int(skip or 0)
    return rows[skip:skip + int(take)]


def _body(sql):
    return sql[:sql.lower().rindex("order by")]


def _snap():
    s = REGISTRY.snapshot()
    return {n: s.get(n, 0) for n in OVERFLOWS}


@pytest.fixture(scope="module")
def q3_params(pair):
    """Every (segment, date) with the JAX package's rows of its body."""
    js = pair[0]
    out = []
    for seg in SEGMENTS:
        for date in DATES:
            sql = Q3.format(segment=seg, date=date)
            out.append((sql, js.query(_body(sql))))
    return out


def _check_q3(sess, q3_params):
    for sql, body_rows in q3_params:
        want = _ordered(body_rows, "revenue desc, o_orderdate", "10")
        assert _wire(sess.query(sql)) == _wire(want), sql


def test_default_route_equals_the_jax_package(pair, q3_params):
    _check_q3(_session(pair[1]), q3_params)


@pytest.fixture
def sf10_route(monkeypatch):
    """The broadcast cap scaled as the tables are: the build side is over
    it, as at SF10."""
    monkeypatch.setattr(physical, "DEVICE_JOIN_BUILD_MAX",
                        int(physical.DEVICE_JOIN_BUILD_MAX * SCALE / 10))


def test_sf10_route_equals_the_jax_package(pair, q3_params, sf10_route):
    sess = _session(pair[1])
    modes = _modes(sess, q3_params[0][0])
    assert modes and all("+grouped+top10" in m for m in modes), modes
    before = _snap()
    _check_q3(sess, q3_params)
    assert _snap() == before


TOPN_BODY = ("select l_orderkey, sum(l_extendedprice * (1 - l_discount))"
             " as revenue, o_orderdate, o_shippriority"
             " from customer, orders, lineitem"
             " where c_mktsegment in ('BUILDING', 'MACHINERY')"
             " and c_custkey = o_custkey and l_orderkey = o_orderkey"
             " and o_orderdate < '1995-03-31' and l_shipdate > '1995-03-01'"
             " group by l_orderkey, o_orderdate, o_shippriority ")


@pytest.fixture(scope="module")
def topn_body_rows(pair):
    return pair[0].query(TOPN_BODY)


@pytest.mark.parametrize("order,limit", [
    ("revenue desc, o_orderdate", "10"),
    ("revenue, l_orderkey desc", "3, 5"),
    ("o_orderdate desc, revenue desc", "7, 4"),
])
def test_topn_on_the_card_equals_the_jax_package(pair, topn_body_rows,
                                                 sf10_route, order, limit):
    sess = _session(pair[1])
    sql = f"{TOPN_BODY}order by {order} limit {limit}"
    modes = _modes(sess, sql)
    assert modes and all("+grouped+top" in m for m in modes), modes
    want = _ordered(topn_body_rows, order, limit)
    assert len(want) == int(limit.rpartition(",")[2])
    assert _wire(sess.query(sql)) == _wire(want), sql

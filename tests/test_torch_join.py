"""Joins on the device path of the port: runtime join filters
(JoinProbeIR) and broadcast lookup joins (JoinLookupIR) inside the fused
whole-table program, against the JAX package.

Both packages load the same arrays (tests/test_device_join.py's `_load`
shape: 500 orders, 8000 lineitem rows over 8 regions, seed 3; and a
`build_tpch_domain(scale=1)` pair for TPC-H Q3's three-way join).  The
port runs on its device path (`tidb_use_tpu = 1`, torch on the CPU);
the JAX package answers through its host engine (`tidb_use_tpu = 0`),
whose rows tests/test_device_join.py holds equal to its device path's.
Rows must be equal after `_norm`; every port scan must report
`engine:mesh` and no fusion region may split.

ORDER BY over a decimal sum: both packages hold such sums
(DECIMAL(38, s)) as Python ints, and the JAX package's host sort ranks
them by their digits as strings, so its top 10 of a Q3 is not the
largest revenues.  The port ranks them by value.  An ordered statement
is therefore held to the JAX package's grouped rows (the statement
without its ORDER BY ... LIMIT) and to their order by value.
"""

import numpy as np
import pytest

from tidb_tpu_torch import ops as tops
from tidb_tpu_torch.metrics import REGISTRY

N_ORDERS, N_LI = 500, 8000

Q3 = ("select l_orderkey, o_orderdate, o_shippriority,"
      " sum(l_extendedprice * (1 - l_discount)) as rev"
      " from li, orders where l_orderkey = o_orderkey"
      " and o_orderdate < '1995-03-15' and l_shipdate > '1995-03-15'"
      " group by l_orderkey, o_orderdate, o_shippriority"
      " order by rev desc, l_orderkey limit 10")
SCALAR = ("select count(*), sum(l_extendedprice) from li, orders"
          " where l_orderkey = o_orderkey and o_shippriority < 3")
PAYLOAD_KEY = ("select o_shippriority, count(*), min(l_extendedprice)"
               " from li, orders where l_orderkey = o_orderkey"
               " group by o_shippriority order by o_shippriority")
MIXED_KEY = ("select o_shippriority, l_discount, count(*),"
             " sum(l_extendedprice * (1 - l_discount)) from li, orders"
             " where l_orderkey = o_orderkey and o_orderdate < '1995-03-15'"
             " and l_shipdate > '1995-03-15'"
             " group by o_shippriority, l_discount")
EMPTY_BUILD = ("select count(*) from li, orders where l_orderkey = o_orderkey"
               " and o_orderdate < '1200-01-01'")
SEMI = ("select count(*) from lineitem where l_orderkey in"
        " (select o_orderkey from orders where o_orderdate < '1994-09-01')")


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    tops.use_device("cpu")


def _norm(rows):
    return [tuple(round(v, 6) if isinstance(v, float) else v for v in r)
            for r in rows]


def _sorted(rows):
    return sorted(_norm(rows), key=lambda r: tuple(
        (0, "") if x is None else (1, str(x)) for x in r))


def _arrays(null_probe_keys=False):
    """The two tables' columns as test_device_join._load draws them."""
    from tidb_tpu_torch.types.values import parse_date

    rng = np.random.default_rng(3)
    base = parse_date("1995-01-01")
    orders = [np.arange(N_ORDERS, dtype=np.int64),
              (base + rng.integers(-200, 200, N_ORDERS)).astype(np.int64),
              rng.integers(0, 5, N_ORDERS)]
    li = [rng.integers(0, N_ORDERS * 2, N_LI),  # half have no match
          rng.integers(90_000, 10_500_001, N_LI),
          rng.integers(0, 11, N_LI),
          (base + rng.integers(-300, 300, N_LI)).astype(np.int64)]
    lv = None
    if null_probe_keys:
        lv = [np.ones(N_LI, np.bool_), None, None, None]
        lv[0][:100] = False
    return orders, li, lv


def _load(domain_cls, null_probe_keys=False):
    d = domain_cls()
    s = d.new_session()
    s.execute("create table orders (o_orderkey bigint primary key,"
              " o_orderdate date, o_shippriority bigint)")
    s.execute("create table li (l_orderkey bigint,"
              " l_extendedprice decimal(15,2), l_discount decimal(15,2),"
              " l_shipdate date)")
    orders, li, lv = _arrays(null_probe_keys)
    t_o = d.catalog.info_schema().table("test", "orders")
    t_l = d.catalog.info_schema().table("test", "li")
    d.storage.table(t_o.id).bulk_load_arrays(orders,
                                             ts=d.storage.current_ts())
    d.storage.table(t_l.id).bulk_load_arrays(li, lv,
                                             ts=d.storage.current_ts())
    d.storage.regions.split_even(t_l.id, 8, N_LI)
    s.execute("analyze table orders")
    s.execute("analyze table li")
    return s


def _pair(null_probe_keys=False):
    from tidb_tpu.session import Domain as JDomain
    from tidb_tpu_torch.session import Domain as TDomain

    js = _load(JDomain, null_probe_keys)
    ts = _load(TDomain, null_probe_keys)
    js.execute("set tidb_use_tpu = 0")
    ts.execute("set tidb_use_tpu = 1")
    return js, ts


@pytest.fixture(scope="module")
def q3_pair():
    return _pair()


@pytest.fixture(scope="module")
def tpch_pair():
    from tidb_tpu.tpch_data import build_tpch_domain as j_build
    from tidb_tpu_torch.tpch_data import build_tpch_domain as t_build

    js, ts = j_build(scale=1), t_build(scale=1)
    js.execute("set tidb_use_tpu = 0")
    ts.execute("set tidb_use_tpu = 1")
    return js, ts


def _explain(sess, sql):
    return sess.execute("explain " + sql)[0].rows


def _engines(sess, sql):
    rows = sess.execute("explain analyze " + sql)[0].rows
    return [r[4] for r in rows if "TableReader" in r[0]]


def _device_parity(pair, sql, ordered=False):
    """Port rows == JAX rows after _norm, every port scan on the mesh,
    and no fusion split; returns the port's rows."""
    js, ts = pair
    s0 = REGISTRY.get("fusion_splits_total")
    got = ts.query(sql)
    assert REGISTRY.get("fusion_splits_total") == s0, sql
    want = js.query(sql)
    if ordered:
        assert _norm(got) == _norm(want), sql
    else:
        assert _sorted(got) == _sorted(want), sql
    eng = _engines(ts, sql)
    assert eng and all("engine:mesh" in e for e in eng), (sql, eng)
    return got


def _ordered_parity(pair, sql, key, limit=10):
    """The port's rows of `sql` (ending in ORDER BY ... LIMIT `limit`)
    are the JAX package's grouped rows of its body, sorted by `key`; the
    body's rows are held equal as `_device_parity` holds them."""
    body = sql[:sql.lower().rindex("order by")]
    want = _device_parity(pair, body)
    ts = pair[1]
    s0 = REGISTRY.get("fusion_splits_total")
    got = ts.query(sql)
    assert REGISTRY.get("fusion_splits_total") == s0, sql
    assert _norm(got) == _norm(sorted(want, key=key)[:limit]), sql
    return got


def _q3_key(r):
    return (-r[3], r[0])


def _lookup_analysis(ts):
    """The `_Analyzed` of the device join reader's cop DAG of the last
    statement the port ran."""
    from tidb_tpu_torch.copr.ir import DAG, JoinLookupIR
    from tidb_tpu_torch.copr.torch_engine import _Analyzed

    stack = [ts.last_plan]
    while stack:
        p = stack.pop()
        dag = getattr(p, "dag", None)
        if dag is not None and any(isinstance(x, JoinLookupIR)
                                   for x in dag.executors):
            dag = DAG.from_dict(dag.to_dict())
            table = ts.domain.storage.table(dag.scan.table_id)
            return _Analyzed(dag, table)
        stack.extend(getattr(p, "children", []) or [])
        for attr in ("reader", "probe", "build"):
            c = getattr(p, attr, None)
            if c is not None:
                stack.append(c)
    raise AssertionError("no JoinLookup in the plan")


def test_q3_pair_runs_the_fd_sort(q3_pair):
    from tidb_tpu_torch.copr.parallel import _fd_sort_lookup

    ops = [r[0] for r in _explain(q3_pair[1], Q3)]
    assert any("JoinLookup" in op for op in ops), ops
    rows = _ordered_parity(q3_pair, Q3, _q3_key)
    assert len(rows) == 10
    assert _fd_sort_lookup(_lookup_analysis(q3_pair[1]))


def test_scalar_agg_over_join(q3_pair):
    assert _device_parity(q3_pair, SCALAR)


def test_payload_group_key(q3_pair):
    assert len(_device_parity(q3_pair, PAYLOAD_KEY, ordered=True)) == 5


def test_payload_and_scan_key_take_the_keyed_sort(q3_pair):
    from tidb_tpu_torch.copr.parallel import _fd_sort_lookup

    assert len(_device_parity(q3_pair, MIXED_KEY)) == 55
    an = _lookup_analysis(q3_pair[1])
    assert an.agg_mode == "sort" and not _fd_sort_lookup(an)


def test_empty_build_side(q3_pair):
    assert _device_parity(q3_pair, EMPTY_BUILD) == [(0,)]


def test_null_probe_keys_never_match():
    pair = _pair(null_probe_keys=True)
    _device_parity(pair, SCALAR)
    _ordered_parity(pair, Q3, _q3_key)


def test_delta_rows_join_through_the_host_engine():
    """Rows inserted after the load reach the join through the CPU
    engine's JoinLookupIR path and merge with the device partials."""
    pair = _pair()
    for s in pair:
        s.execute("insert into li values (1, 1000.00, 0.00, '1995-06-01'),"
                  " (1, 2000.00, 0.00, '1995-06-01'),"
                  " (9999, 5.00, 0.00, '1995-06-01')")
    _device_parity(pair, SCALAR)
    _device_parity(pair, PAYLOAD_KEY, ordered=True)


def test_agg_overflow_peels_the_join_to_the_host(q3_pair, monkeypatch):
    """A group budget below the group count peels the aggregation: the
    head keeps scan -> selection on the card (a lookup without a device
    aggregation declines), and the lookup and the aggregation run in
    the host tail."""
    monkeypatch.setenv("TIDB_TPU_AGG_OUT", "64")
    js, ts = q3_pair
    p0 = REGISTRY.get("mesh_agg_peel_total")
    got = ts.query(Q3)
    assert REGISTRY.get("mesh_agg_peel_total") == p0 + 1
    body = js.query(Q3[:Q3.rindex(" order by")])
    assert _norm(got) == _norm(sorted(body, key=_q3_key)[:10])
    eng = _engines(ts, Q3)
    assert eng and all("engine:mesh" in e for e in eng), eng


@pytest.fixture
def no_mpp(tpch_pair):
    """The pair with the MPP engine disallowed (`tidb_allow_mpp = 0`):
    the JAX planner then plans Q3 and the semi join as root hash joins
    whose scans carry a runtime filter (with MPP allowed it plans them
    as MPPJoinTree, tests/test_torch_mpp.py)."""
    for s in tpch_pair:
        s.execute("set tidb_allow_mpp = 0")
    yield tpch_pair
    for s in tpch_pair:
        s.execute("set tidb_allow_mpp = 1")


def test_three_way_q3_runtime_filter(no_mpp):
    from tidb_tpu_torch.tpch_data import TPCH_QUERIES

    q3 = TPCH_QUERIES["q3"]
    plan = _explain(no_mpp[1], q3)
    assert any("JoinProbe" in r[0] for r in plan), plan
    assert any("runtime-filter" in str(r[3]) for r in plan), plan
    assert len(_ordered_parity(no_mpp, q3,
                               lambda r: (-r[1], r[0]))) == 10


def test_semi_join_runtime_filter(no_mpp):
    plan = _explain(no_mpp[1], SEMI)
    assert any("semi" in str(r[3]) and "runtime-filter" in str(r[3])
               for r in plan), plan
    assert _device_parity(no_mpp, SEMI)[0][0] > 0


def test_float_keyed_runtime_filter():
    """Float probe keys arrive as int64 bit patterns and are compared by
    value on the card: -0.0 matches 0.0, and a NULL key never matches."""
    from tidb_tpu.session import Domain as JDomain
    from tidb_tpu_torch.session import Domain as TDomain

    rng = np.random.default_rng(9)
    n = 4000
    fk = np.round(rng.uniform(-3, 3, n), 1)
    fk[rng.random(n) < 0.1] = -0.0
    fk[:5] = -0.0
    fv = np.ones(n, np.bool_)
    fv[5:40] = False
    bk = np.round(np.arange(-3.0, 3.05, 0.5), 1)
    bk[bk == 0.0] = 0.0  # the build side holds +0.0 only
    pairs = []
    for cls, tpu in ((JDomain, 0), (TDomain, 1)):
        d = cls()
        s = d.new_session()
        s.execute("create table fa (k double, v bigint)")
        s.execute("create table fb (k double, w bigint)")
        fa = d.catalog.info_schema().table("test", "fa")
        fb = d.catalog.info_schema().table("test", "fb")
        d.storage.table(fa.id).bulk_load_arrays(
            [fk, np.arange(n, dtype=np.int64)], [fv, None],
            ts=d.storage.current_ts())
        d.storage.table(fb.id).bulk_load_arrays(
            [bk, np.arange(len(bk), dtype=np.int64)],
            ts=d.storage.current_ts())
        d.storage.regions.split_even(fa.id, 4, n)
        s.execute("analyze table fa")
        s.execute("analyze table fb")
        s.execute(f"set tidb_use_tpu = {tpu}")
        pairs.append(s)
    q = ("select fb.w, count(*), sum(fa.v) from fa, fb where fa.k = fb.k"
         " group by fb.w")
    plan = _explain(pairs[1], q)
    assert any("JoinProbe" in r[0] for r in plan), plan
    rows = _device_parity(tuple(pairs), q)
    zero_w = int(np.flatnonzero(bk == 0.0)[0])
    assert any(r[0] == zero_w for r in rows)


def test_q15_max_over_a_wide_decimal_sum(tpch_pair):
    """TPC-H Q15's `max(total_revenue)` folds a DECIMAL(38, s) sum on
    the host: its min/max state has no fixed-width identity."""
    from tidb_tpu_torch.tpch_data import TPCH_QUERIES

    q15 = TPCH_QUERIES["q15"]
    js, ts = tpch_pair
    got = ts.query(q15)
    assert got and _norm(got) == _norm(js.query(q15))


def test_min_max_over_a_wide_decimal_column():
    """min/max over a DECIMAL(38, 2) column, scalar and grouped, with
    NULLs and a group whose every value lies past int64."""
    from tidb_tpu.session import Domain as JDomain
    from tidb_tpu_torch.session import Domain as TDomain

    big = 10 ** 20
    rows = [(1, f"{big + 12345}.45"), (1, "-3.10"), (1, f"-{big}.99"),
            (2, None), (2, "7.00"), (3, None), (4, f"{3 * big}.01"),
            (4, f"{2 * big}.50"), (5, f"-{3 * big}.01"),
            (5, f"-{2 * big}.50")]
    values = ", ".join(f"({a}, {'NULL' if v is None else v})"
                       for a, v in rows)
    sess = []
    for cls, tpu in ((JDomain, 0), (TDomain, 1)):
        s = cls().new_session()
        s.execute("create table wd (a bigint, v decimal(38,2))")
        s.execute("insert into wd values " + values)
        s.execute(f"set tidb_use_tpu = {tpu}")
        sess.append(s)
    js, ts = sess
    scalar = "select min(v), max(v), count(v) from wd"
    assert _norm(ts.query(scalar)) == _norm(js.query(scalar))
    grouped = "select a, min(v), max(v) from wd where a < 4 group by a"
    assert _sorted(ts.query(grouped)) == _sorted(js.query(grouped))
    # past int64 in every row of the group: the reference's int64
    # identity wins its min (a = 4) or max (a = 5), so the port is held
    # to the values
    got = ts.query("select min(v), max(v) from wd where a = 4")
    assert got == [(f"{2 * big}.50", f"{3 * big}.01")]
    got = ts.query("select min(v), max(v) from wd where a = 5")
    assert got == [(f"-{3 * big}.01", f"-{2 * big}.50")]

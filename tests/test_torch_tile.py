"""The per-tile rung of the port (`torch_engine.run_base_torch` under
`fusion.run_fragment`) against the JAX package's (`run_base_jax`).

A request with more disjoint ranges than the whole-table program's
range slots (`MESH_RANGE_SLOTS` = 4) takes the per-region fan-out, where
each region runs tile by tile on the device.  No SQL predicate yields
such a request on an unpartitioned table (the planner derives ranges
only from partitions), so each statement is planned from SQL and its
table reader then runs over six disjoint handle ranges that match its
own predicate; the rows are the statement's.  Both packages run that
request with `tidb_use_tpu = 1` over the same arrays (TILE = 1024 from
tests/conftest.py, so a region spans several tiles): the port's rows
must equal the JAX package's after `_norm`, its scans must report
`tile-fanout` with device tile dispatches, and no region may run on the
CPU engine.
"""

import numpy as np
import pytest

from tidb_tpu_torch import ops as tops
from tidb_tpu_torch.metrics import REGISTRY

N = 6000
#: six disjoint [lo, hi) handle spans (handle == k); RANGES is their SQL
SPANS = [(10, 401), (900, 1501), (2000, 2101), (2500, 3301),
         (4000, 4101), (5000, 5901)]
RANGES = "(" + " or ".join(f"k between {lo} and {hi - 1}"
                           for lo, hi in SPANS) + ")"

FILTER_LIMIT = f"select k, x from pk where {RANGES} and x < 30 limit 7"
FILTER = f"select k, g, x, d from pk where {RANGES} and x < 1"
DENSE_AGG = (f"select g, k, count(*), min(x), max(x), min(k), max(k),"
             f" sum(x) from pk where {RANGES} group by g")
TOPN = f"select k, x from pk where {RANGES} order by x desc limit 10"
DATE_AGG = f"select g, min(d), max(d) from pk where {RANGES} group by g"


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    tops.use_device("cpu")


def _norm(rows):
    return [tuple(round(v, 6) if isinstance(v, float) else v for v in r)
            for r in rows]


def _arrays():
    rng = np.random.default_rng(5)
    return [np.arange(N, dtype=np.int64),
            rng.integers(0, 5, N),
            rng.uniform(0, 100, N),
            (9000 + rng.integers(0, 500, N)).astype(np.int32)]


def _load(domain_cls):
    d = domain_cls()
    s = d.new_session()
    s.execute("create table pk (k bigint primary key, g bigint, x double,"
              " d date)")
    t = d.catalog.info_schema().table("test", "pk")
    d.storage.table(t.id).bulk_load_arrays(_arrays(),
                                           ts=d.storage.current_ts())
    d.storage.regions.split_even(t.id, 4, N)
    s.execute("analyze table pk")
    s.execute("set tidb_use_tpu = 1")
    # one region at a time: LIMIT keeps the same first rows in both
    s.execute("set tidb_distsql_scan_concurrency = 1")
    return s


def _pair():
    from tidb_tpu.session import Domain as JDomain
    from tidb_tpu_torch.session import Domain as TDomain

    return _load(JDomain), _load(TDomain)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _run_ranged(sess, sql, replan=True):
    """The rows of `sql` with its table reader run over SPANS, and the
    engines its readers report; `replan=False` reuses the plan of the
    session's last statement.  Both packages' sessions run through the
    port's `run_over_spans`, which drives each with its own executors."""
    from tidb_tpu_torch.session.session import run_over_spans

    if replan:
        sess.query(sql)  # plans the statement
    return run_over_spans(sess, sess.last_plan, SPANS)


def _counts():
    snap = REGISTRY.snapshot()
    return (snap.get("dispatch_chunk_tile_ms_count", 0),
            snap.get("cop_region_cpu_runs_total", 0),
            snap.get("mesh_scans_total", 0))


def _tile_parity(pair, sql, ordered=False):
    js, ts = pair
    want, j_eng = _run_ranged(js, sql)
    # the same statement over the whole table (the fused program)
    full = ts.query(sql)
    t0, c0, m0 = _counts()
    got, eng = _run_ranged(ts, sql, replan=False)
    t1, c1, m1 = _counts()
    assert eng and all(e.startswith("tile-fanout") and "6 disjoint ranges"
                       in e for e in eng), eng
    assert t1 > t0 and c1 == c0 and m1 == m0, (t0, t1, c0, c1, m0, m1)
    assert j_eng and all(e.startswith("tile-fanout") for e in j_eng)
    if ordered:
        assert _norm(got) == _norm(want)
    else:
        assert sorted(_norm(got)) == sorted(_norm(want))
    if "limit" not in sql or "order by" in sql:
        assert sorted(_norm(full)) == sorted(_norm(got))
    return got


def test_filter_with_limit(pair):
    rows = _tile_parity(pair, FILTER_LIMIT, ordered=True)
    assert len(rows) == 7


def test_filter(pair):
    rows = _tile_parity(pair, FILTER)
    assert 20 < len(rows) < 80


def test_dense_agg_with_first_row(pair):
    assert len(_tile_parity(pair, DENSE_AGG)) == 5


def test_topn(pair):
    assert len(_tile_parity(pair, TOPN, ordered=True)) == 10


def test_date_min_max_equal_numpy(pair):
    """min/max over a DATE through the per-tile rung and the host final
    aggregation equal numpy (the state keeps its own width's identity)."""
    from tidb_tpu_torch.types.values import format_date

    rows, eng = _run_ranged(pair[1], DATE_AGG)
    assert eng and all(e.startswith("tile-fanout") for e in eng)
    _k, g, _x, d = _arrays()
    sel = np.zeros(N, np.bool_)
    for lo, hi in SPANS:
        sel[lo:hi] = True
    want = sorted((int(gi), format_date(int(d[sel & (g == gi)].min())),
                   format_date(int(d[sel & (g == gi)].max())))
                  for gi in range(5))
    assert sorted(rows) == want


def test_projection_region(pair):
    """A device projection (no planner emits one; the DAG is built by
    hand) through both packages' `run_fragment` over one region."""
    from tidb_tpu.copr import fusion as jfusion
    from tidb_tpu.copr import ir as jir
    from tidb_tpu.expr.expression import (ColumnExpr as JCol,
                                          Constant as JConst,
                                          ScalarFunc as JFn)
    from tidb_tpu.types import ty_float as jf, ty_int as ji
    from tidb_tpu_torch.copr import fusion as tfusion
    from tidb_tpu_torch.copr import ir as tir
    from tidb_tpu_torch.expr.expression import (ColumnExpr as TCol,
                                                Constant as TConst,
                                                ScalarFunc as TFn)
    from tidb_tpu_torch.types import ty_float as tf, ty_int as ti

    outs = []
    for sess, ir, fusion, Col, Const, Fn, f64, i64 in (
            (pair[0], jir, jfusion, JCol, JConst, JFn, jf(), ji()),
            (pair[1], tir, tfusion, TCol, TConst, TFn, tf(), ti())):
        d = sess.domain
        tid = d.catalog.info_schema().table("test", "pk").id
        table = d.storage.table(tid)
        dag = ir.DAG([
            ir.TableScanIR(tid, [0, 2], [i64, f64]),
            ir.SelectionIR([Fn("<", [Col(1, f64), Const(20.0, f64)], i64)]),
            ir.ProjectionIR([
                Col(0, i64),
                Fn("*", [Col(1, f64), Const(3.0, f64)], f64)]),
        ])
        chunks = fusion.run_fragment(table, dag, 700, 3500, [])
        outs.append(sorted(_norm([r for c in chunks
                                  for r in c.to_pylist()])))
    assert outs[0] == outs[1] and len(outs[1]) > 400


def test_deletes_inside_a_tile():
    pair = _pair()
    for s in pair:
        s.execute("delete from pk where k in (12, 13, 950, 951, 2050,"
                  " 3000, 5899)")
        s.execute("delete from pk where k between 1100 and 1200")
    _tile_parity(pair, DENSE_AGG)
    _tile_parity(pair, FILTER)


def test_runtime_failure_in_the_tile_program_raises(pair, monkeypatch):
    """A runtime error inside the per-tile program fails the statement:
    the region is not rerun on the CPU engine."""
    from tidb_tpu_torch.copr import fusion

    ts = pair[1]
    ts.query(DENSE_AGG)  # plan it before arming the failure

    def failing(ctx):
        raise RuntimeError("tile program: CUDA launch failed (error 700)")

    monkeypatch.setattr(fusion, "dense_group_codes", failing)
    ts.execute("set tidb_backoff_budget_ms = 30")
    t0, c0, m0 = _counts()
    try:
        with pytest.raises(Exception, match="launch failed"):
            _run_ranged(ts, DENSE_AGG, replan=False)
    finally:
        ts.execute("set tidb_backoff_budget_ms = 10000")
    t1, c1, m1 = _counts()
    assert c1 == c0 and m1 == m0

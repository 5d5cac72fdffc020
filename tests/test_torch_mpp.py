"""The port's MPP exchange engine (`tidb_tpu_torch/mpp/`) against the
JAX package.

(a) The exchange primitives and `fusion.merge_grouped_partials`, called
    directly on the same seeded numpy inputs, are held EXACTLY to the
    JAX functions (plain jnp, no shard_map).
(b) Pair joins from SQL on tests/test_mpp.py's fixtures (4000 orders,
    24000 li, seed 11; the duplicate-key and two-column-key tables,
    seed 7), and (c) join trees on tests/test_jointree.py's fixture
    (seed 23) and TPC-H q3, q5, q10 and a semi join on
    `build_tpch_domain(scale=1)`: the port runs them on its device path
    (`tidb_use_tpu = 1`, `tidb_enforce_mpp = 1`, torch on the CPU, K1's
    plain version for computed string keys); the JAX package answers
    through its host engine (`tidb_use_tpu = 0`), because its MPP
    programs cannot be built under the installed jax (its `shard_map`
    no longer takes `check_rep`).  Rows must be equal after `_norm`;
    the port's rung metric must move and `mpp_fallback_total` must not.
(d) EXPLAIN: the port's plan rows equal the JAX planner's (the JAX
    session plans with `tidb_use_tpu = 1` and runs nothing), up to the
    per-session plan-id counters.  q11 is left out: its planning runs a
    subquery through the JAX package's MPP program.
(e) The ladders: shuffle overflow demotes to broadcast, a group-budget
    overflow peels the aggregation, and a runtime error inside the
    exchange program reaches the statement with no host fallback.

ORDER BY over a decimal sum: the JAX package's host sort ranks
DECIMAL(38, s) sums by their digits (tests/test_torch_join.py), so an
ordered TPC-H statement is held to the JAX package's rows of its body,
sorted by value.
"""

import re

import numpy as np
import pytest

from tidb_tpu_torch import ops as tops
from tidb_tpu_torch.metrics import REGISTRY


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    tops.use_device("cpu")


def _norm(rows):
    return [tuple(round(v, 6) if isinstance(v, float) else v for v in r)
            for r in rows]


def _sorted(rows):
    return sorted(_norm(rows), key=lambda r: tuple(
        (0, "") if x is None else (1, str(x)) for x in r))


def _snap(*names):
    s = REGISTRY.snapshot()
    return tuple(s.get(n, 0) for n in names)


# ---------------------------------------------------------------------------
# (a) primitives, exact against the JAX functions
# ---------------------------------------------------------------------------


def _jx():
    import jax.numpy as jnp

    from tidb_tpu.mpp import exchange as jex

    return jnp, jex


def _keys(seed: int, n: int = 4096):
    """int64 keys: small and clustered, negative, and the extremes."""
    rng = np.random.default_rng(seed)
    k = np.concatenate([
        np.arange(-50, 50, dtype=np.int64),
        rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64),
        np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).min + 1,
                  np.iinfo(np.int64).max, np.iinfo(np.int64).max - 1, 0,
                  -1], dtype=np.int64)])
    return k


def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype or got.dtype.kind == want.dtype.kind, \
        (got.dtype, want.dtype)
    assert np.array_equal(got, want), (got[:10], want[:10])


@pytest.mark.parametrize("n_parts", [1, 4, 8])
def test_partition_ids(n_parts):
    from tidb_tpu_torch.mpp import exchange as tex

    jnp, jex = _jx()
    k = _keys(n_parts)
    got = tex.partition_ids(_t(k), n_parts)
    want = jex.partition_ids(jnp.asarray(k), n_parts)
    _eq(got, want)
    assert got.min() >= 0 and got.max() < n_parts


def test_pack_buckets_with_an_overflowing_bucket():
    from tidb_tpu_torch.mpp import exchange as tex

    jnp, jex = _jx()
    rng = np.random.default_rng(3)
    n, parts, cap = 1000, 4, 200
    pid = rng.integers(0, parts, n).astype(np.int64)
    pid[:400] = 2                      # bucket 2 wants ~550 rows > cap
    mask = rng.random(n) < 0.9
    arrays = [rng.integers(-9, 9, n).astype(np.int64),
              rng.random(n) < 0.5, rng.uniform(-1, 1, n)]
    got, gval, gover = tex.pack_buckets(_t(pid), _t(mask), parts, cap,
                                        [_t(a) for a in arrays])
    want, wval, wover = jex.pack_buckets(
        jnp.asarray(pid), jnp.asarray(mask), parts, cap,
        [jnp.asarray(a) for a in arrays])
    assert int(gover) == int(wover) > 0
    _eq(gval, wval)
    for g, w in zip(got, want):
        _eq(g, w)


def test_combine_and_exact_pack_keys():
    from tidb_tpu_torch.mpp import exchange as tex

    jnp, jex = _jx()
    rng = np.random.default_rng(5)
    cols = [_keys(5)[:2000], rng.integers(-40, 40, 2000).astype(np.int64),
            rng.integers(0, 7, 2000).astype(np.int64)]
    _eq(tex.combine_keys([_t(c) for c in cols]),
        jex.combine_keys([jnp.asarray(c) for c in cols]))
    _eq(tex.combine_keys([_t(cols[0])]), cols[0])
    stats = [((-40, 39), (-35, 45)), ((0, 6), (1, 9))]
    spec = tex.compound_pack_spec(stats)
    assert spec == jex.compound_pack_spec(stats) == ([-40, 0], [86, 10])
    wide = [((-(1 << 40), 1 << 40), (0, 1))] * 2
    assert tex.compound_pack_spec(wide) is None
    assert jex.compound_pack_spec(wide) is None
    los, cards = spec
    _eq(tex.pack_keys_exact([_t(c) for c in cols[1:]], los, cards),
        jex.pack_keys_exact([jnp.asarray(c) for c in cols[1:]], los,
                            cards))


def _build_side(seed: int):
    rng = np.random.default_rng(seed)
    bk = rng.integers(0, 60, 300).astype(np.int64)   # ~5 rows per key
    bk[:5] = np.iinfo(np.int64).max                  # key == the sentinel
    valid = rng.random(300) < 0.85                   # invalid rows
    return bk, valid


def test_sorted_build_with_duplicate_and_invalid_keys():
    from tidb_tpu_torch.mpp import exchange as tex

    jnp, jex = _jx()
    bk, valid = _build_side(9)
    got = tex.sorted_build(_t(bk), _t(valid))
    want = jex.sorted_build(jnp.asarray(bk), jnp.asarray(valid))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("louter,cap_out", [(False, 4096), (True, 4096),
                                            (False, 600), (True, 600)])
def test_expand_matches(louter, cap_out):
    """Inner and left-outer expansion over duplicate build keys; at
    cap_out 600 the emissions overflow the buffer."""
    from tidb_tpu_torch.mpp import exchange as tex

    jnp, jex = _jx()
    rng = np.random.default_rng(13)
    bk, valid = _build_side(13)
    pk = rng.integers(-5, 80, 400).astype(np.int64)
    emit = rng.random(400) < 0.9
    ok = emit & (rng.random(400) < 0.9)
    sbk, bord, nb = tex.sorted_build(_t(bk), _t(valid))
    got = tex.expand_matches(sbk, bord, nb, _t(pk), _t(emit), _t(ok),
                             cap_out, louter)
    jsbk, jbord, jnb = jex.sorted_build(jnp.asarray(bk),
                                        jnp.asarray(valid))
    want = jex.expand_matches(jsbk, jbord, jnb, jnp.asarray(pk),
                              jnp.asarray(emit), jnp.asarray(ok), cap_out,
                              louter)
    for g, w in zip(got, want):
        _eq(g, w)
    assert (int(got[4]) > 0) == (cap_out == 600)


def test_merge_grouped_partials():
    """Per-shard partial rows of 4 shards merged: count, sum (int and
    float), avg, min, max (empty partials carry sentinels) and
    first_row, against the JAX merge."""
    from types import SimpleNamespace

    import torch

    from tidb_tpu_torch.copr.fusion import merge_grouped_partials

    jnp, _jex = _jx()
    from tidb_tpu.copr.fusion import merge_grouped_partials as jmerge

    rng = np.random.default_rng(17)
    cap, n = 64, 4 * 64
    key = rng.integers(0, 20, n).astype(np.int64)
    flag = (rng.random(n) < 0.95).astype(np.int64)
    ok = rng.random(n) < 0.8
    cnt = rng.integers(0, 5, n).astype(np.int64)
    isum = rng.integers(-10**9, 10**9, n).astype(np.int64)
    fsum = rng.uniform(-1e3, 1e3, n)
    mn = np.where(cnt > 0, rng.integers(-100, 100, n),
                  np.iinfo(np.int64).max).astype(np.int64)
    mx = np.where(cnt > 0, rng.uniform(-5, 5, n), -np.inf)
    first = rng.integers(0, 10**6, n).astype(np.int64)
    # the merge reads only each aggregate's name
    aggs = [SimpleNamespace(name=nm) for nm in
            ("count", "sum", "avg", "min", "max", "first_row")]
    states = [cnt, (isum, cnt), (fsum, cnt), (mn, cnt), (mx, cnt), first]

    def conv(f):
        return [tuple(f(x) for x in s) if isinstance(s, tuple) else f(s)
                for s in states]

    got = merge_grouped_partials(
        aggs, [_t(key)], [_t(flag)], _t(ok), conv(_t), cap)
    want = jmerge(aggs, [jnp.asarray(key)],
                  [jnp.asarray(flag)], jnp.asarray(ok), conv(jnp.asarray),
                  cap)
    assert int(got[0]) == int(want[0])
    k = int(got[0])
    for g, w in zip(got[1], want[1]):
        _eq(g[:k], np.asarray(w)[:k])
    for gs, ws in zip(got[2], want[2]):
        for g, w in zip(gs if isinstance(gs, tuple) else (gs,),
                        ws if isinstance(ws, tuple) else (ws,)):
            g = g[:k]
            w = np.asarray(w)[:k]
            if g.dtype == torch.float64:
                assert np.allclose(g.numpy(), w, rtol=1e-12, atol=1e-9)
            else:
                _eq(g, w)


# ---------------------------------------------------------------------------
# (b) pair joins from SQL
# ---------------------------------------------------------------------------

N_ORDERS, N_LINES = 4000, 24000

INNER = ("select l_orderkey, l_qty, l_price, o_flag, o_total from li"
         " join orders on l_orderkey = o_orderkey where l_qty < 40")
LOUTER = ("select l_orderkey, l_qty, o_flag, o_total from li"
          " left join orders on l_orderkey = o_orderkey")
STRINGS = ("select l_comment, o_clerk from li"
           " join orders on l_orderkey = o_orderkey where o_flag = 2")
AGG = ("select count(*), count(o_flag), sum(l_price), avg(o_total),"
       " min(l_qty), max(o_total) from li"
       " join orders on l_orderkey = o_orderkey where l_qty < 30")
GROUPED_CORPUS = [
    ("select l_qty, count(*), sum(l_price) from li join orders"
     " on l_orderkey = o_orderkey group by l_qty"),
    ("select o_flag, count(*), count(o_total), sum(l_price),"
     " avg(o_total), min(l_qty), max(o_total) from li join orders"
     " on l_orderkey = o_orderkey group by o_flag"),
    ("select o_clerk, count(*), sum(l_qty) from li join orders"
     " on l_orderkey = o_orderkey group by o_clerk"),
    ("select l_comment, count(*), max(o_total) from li join orders"
     " on l_orderkey = o_orderkey where o_flag < 4 group by l_comment"),
    ("select o_flag, l_comment, count(*), sum(l_price) from li"
     " join orders on l_orderkey = o_orderkey"
     " group by o_flag, l_comment"),
    ("select substr(o_clerk, 2, 2), count(*), sum(l_qty) from li"
     " join orders on l_orderkey = o_orderkey"
     " group by substr(o_clerk, 2, 2)"),
    ("select concat(l_comment, '!'), o_flag, count(*), max(o_total)"
     " from li join orders on l_orderkey = o_orderkey"
     " where o_flag < 4 group by concat(l_comment, '!'), o_flag"),
]
PAIR = ([("inner", INNER, "shuffle"), ("louter", LOUTER, "shuffle"),
         ("strings", STRINGS, "shuffle"), ("agg", AGG, "shuffle")]
        + [(f"grouped{i}", q, "shuffle+grouped")
           for i, q in enumerate(GROUPED_CORPUS)])
#: the two-column-key joins expand each probe row ~3x.  On one card the
#: reference's emission buffer holds the probe side's rows once
#: (cap_out = TIDB_TPU_MPP_JOIN_SLACK x n_local), so these cases run with
#: the slack at 4; at the default slack the ladder ends on the host
#: (test_emission_overflow_walks_the_ladder_to_the_host)
EXPANDING_SLACK = "4"
DUP = [
    ("nonunique-inner", "select pk, q, g, v from probe join dup on pk = k"
     " where q < 25", "shuffle"),
    ("nonunique-louter", "select pk, q, v from probe left join dup"
     " on pk = k", "shuffle"),
    ("nonunique-grouped", "select g, count(*), sum(v), avg(q) from probe"
     " join dup on pk = k group by g", "shuffle+grouped"),
    ("multicol-rows", "select x, y from a2 join b2 on k1 = m1 and k2 = m2"
     " where x < 5", "shuffle"),
    ("multicol-grouped", "select x, count(*), sum(y) from a2 join b2"
     " on k1 = m1 and k2 = m2 group by x", "shuffle+grouped"),
    ("multicol-louter", "select k1, k2, x, y from a2 left join b2"
     " on k1 = m1 and k2 = m2 where x < 3", "shuffle"),
]


def _load_pair_tables(d):
    """tests/test_mpp.py's `sess` fixture tables."""
    s = d.new_session()
    s.execute("create table orders (o_orderkey bigint primary key,"
              " o_flag bigint, o_total double, o_clerk varchar(8))")
    s.execute("create table li (l_orderkey bigint, l_qty bigint,"
              " l_price decimal(12,2), l_comment varchar(8))")
    rng = np.random.default_rng(11)
    t_o = d.catalog.info_schema().table("test", "orders")
    t_l = d.catalog.info_schema().table("test", "li")
    clerks = np.array([f"c{i:03d}" for i in range(40)], dtype=object)
    d.storage.table(t_o.id).bulk_load_arrays([
        np.arange(N_ORDERS, dtype=np.int64),
        rng.integers(0, 5, N_ORDERS),
        rng.uniform(1, 9999, N_ORDERS),
        clerks[rng.integers(0, 40, N_ORDERS)],
    ], ts=d.storage.current_ts())
    lk = rng.integers(0, N_ORDERS * 3, N_LINES)
    lvalid = [np.ones(N_LINES, np.bool_), None, None, None]
    lvalid[0][rng.integers(0, N_LINES, 500)] = False
    comments = np.array([f"m{i:02d}" for i in range(20)], dtype=object)
    d.storage.table(t_l.id).bulk_load_arrays([
        lk,
        rng.integers(1, 51, N_LINES),
        rng.integers(100, 1_000_000, N_LINES),
        comments[rng.integers(0, 20, N_LINES)],
    ], lvalid, ts=d.storage.current_ts())
    s.execute("analyze table orders")
    s.execute("analyze table li")
    return s


def _load_dup_tables(d):
    """tests/test_mpp.py's `dup_sess` fixture tables."""
    s = d.new_session()
    s.execute("create table dup (k bigint, g bigint, v double)")
    s.execute("create table probe (pk bigint, q bigint)")
    s.execute("create table a2 (k1 bigint, k2 bigint, x bigint)")
    s.execute("create table b2 (m1 bigint, m2 bigint, y double)")
    rng = np.random.default_rng(7)
    t = d.catalog.info_schema()
    n_d, n_p = 12000, 20000
    dvalid = [np.ones(n_d, np.bool_), None, None]
    dvalid[0][rng.integers(0, n_d, 300)] = False
    d.storage.table(t.table("test", "dup").id).bulk_load_arrays(
        [rng.integers(0, 4000, n_d), rng.integers(0, 7, n_d),
         rng.uniform(0, 100, n_d)], dvalid, ts=d.storage.current_ts())
    d.storage.table(t.table("test", "probe").id).bulk_load_arrays(
        [rng.integers(0, 12000, n_p), rng.integers(0, 50, n_p)],
        ts=d.storage.current_ts())
    n_a, n_b = 16000, 6000
    d.storage.table(t.table("test", "a2").id).bulk_load_arrays(
        [rng.integers(0, 50, n_a), rng.integers(0, 40, n_a),
         rng.integers(0, 9, n_a)], ts=d.storage.current_ts())
    d.storage.table(t.table("test", "b2").id).bulk_load_arrays(
        [rng.integers(0, 50, n_b), rng.integers(0, 40, n_b),
         rng.uniform(0, 10, n_b)], ts=d.storage.current_ts())
    for name in ("dup", "probe", "a2", "b2"):
        s.execute(f"analyze table {name}")
    return s


def _pair_of(loader):
    """(JAX session on its host engine, port session on its device
    path), both with tidb_enforce_mpp = 1."""
    from tidb_tpu.session import Domain as JDomain
    from tidb_tpu_torch.session import Domain as TDomain

    js, ts = loader(JDomain()), loader(TDomain())
    for s, tpu in ((js, 0), (ts, 1)):
        s.execute("set tidb_enforce_mpp = 1")
        s.execute(f"set tidb_use_tpu = {tpu}")
    return js, ts


@pytest.fixture(scope="module")
def pair():
    return _pair_of(_load_pair_tables)


@pytest.fixture(scope="module")
def dup_pair():
    return _pair_of(_load_dup_tables)


def _metric(mode: str) -> str:
    return "mpp_joins_" + mode.replace("+", "_").replace("-", "_") + "_total"


def _mpp_parity(pair, sql, mode, ordered=False):
    """The port's rows on the `mode` rung == the JAX host engine's rows,
    with no host fallback; returns the port's rows."""
    js, ts = pair
    m0, f0 = _snap(_metric(mode), "mpp_fallback_total")
    got = ts.query(sql)
    m1, f1 = _snap(_metric(mode), "mpp_fallback_total")
    assert m1 > m0, f"not served by the mpp {mode} rung: {sql}"
    assert f1 == f0, f"fell back to the host join: {sql}"
    want = js.query(sql)
    if ordered:
        assert _norm(got) == _norm(want), sql
    else:
        assert _sorted(got) == _sorted(want), sql
    return got


@pytest.mark.parametrize("name,sql,mode", PAIR, ids=[p[0] for p in PAIR])
def test_pair_join_parity(pair, name, sql, mode):
    got = _mpp_parity(pair, sql, mode)
    assert got
    if name == "louter":
        assert any(r[2] is None for r in got)  # NULL-extended rows


@pytest.mark.parametrize("name,sql,mode", DUP, ids=[p[0] for p in DUP])
def test_duplicate_and_two_column_keys(dup_pair, monkeypatch, name, sql,
                                       mode):
    if name.startswith("multicol"):
        monkeypatch.setenv("TIDB_TPU_MPP_JOIN_SLACK", EXPANDING_SLACK)
    got = _mpp_parity(dup_pair, sql, mode)
    if name.endswith("louter"):
        assert any(r[-1] is None for r in got)


def test_emission_overflow_walks_the_ladder_to_the_host(dup_pair):
    """A join that emits more rows than the emission buffer holds
    overflows on the shuffle rung and again on the broadcast rung; the
    host join then serves it (a structural cause), with the same rows."""
    js, ts = dup_pair
    sql = DUP[4][1]
    o0, f0 = _snap("mpp_partition_overflow_total", "mpp_fallback_total")
    got = ts.query(sql)
    o1, f1 = _snap("mpp_partition_overflow_total", "mpp_fallback_total")
    assert (o1 - o0, f1 - f0) == (2, 1)
    assert _sorted(got) == _sorted(js.query(sql))
    rows = ts.execute("explain analyze " + sql)[0].rows
    assert any("host-join [mpp rejected: partition overflow" in str(r[4])
               for r in rows)


def test_pair_join_explain_analyze_names_the_rung(pair):
    rows = pair[1].execute("explain analyze " + GROUPED_CORPUS[5])[0].rows
    assert any("engine:mpp-shuffle+grouped" in str(r[4]) for r in rows)


# ---------------------------------------------------------------------------
# (c) join trees
# ---------------------------------------------------------------------------

THREE_WAY = ("select i_qty, i_price, o_flag, o_total, c_nation"
             " from item join ord on i_ord = o_id"
             " join cust on o_cust = c_id where i_qty < 40")
FOUR_WAY_AGG = ("select c_nation, count(*), sum(i_price)"
                " from item join ord on i_ord = o_id"
                " join cust on o_cust = c_id"
                " join part on i_part = p_id"
                " where o_flag < 4 group by c_nation")
TREES = [
    ("three-way", THREE_WAY),
    ("four-way-grouped", FOUR_WAY_AGG),
    ("exists", "select o_flag, count(*) from ord"
     " where exists (select 1 from item"
     "               where i_ord = o_id and i_qty > 30)"
     " group by o_flag"),
    ("not-exists", "select count(*), sum(o_total) from ord"
     " where not exists (select 1 from item"
     "                   where i_ord = o_id and i_qty > 45)"),
    ("in", "select o_flag, count(*) from ord"
     " where o_cust in (select c_id from cust"
     "                  where c_seg = 'BUILDING')"
     " group by o_flag"),
    ("not-in", "select count(*) from cust"
     " where c_id not in (select o_cust from ord)"),
    ("computed-key", "select p_cat, lower(c_seg), count(*)"
     " from item join ord on i_ord = o_id join cust on o_cust = c_id"
     " join part on i_part = p_id group by p_cat, lower(c_seg)"),
]


def _load_tree_tables(d):
    """tests/test_jointree.py's `sess` fixture tables."""
    n_cust, n_ord, n_item, n_part = 300, 2000, 9000, 150
    s = d.new_session()
    rng = np.random.default_rng(23)
    s.execute("create table cust (c_id bigint primary key,"
              " c_nation bigint, c_seg varchar(10))")
    s.execute("create table ord (o_id bigint primary key,"
              " o_cust bigint, o_flag bigint, o_total double)")
    s.execute("create table item (i_ord bigint, i_part bigint,"
              " i_qty bigint, i_price decimal(12,2))")
    s.execute("create table part (p_id bigint primary key,"
              " p_cat varchar(12))")
    ts = d.storage.current_ts()

    def table(name):
        return d.storage.table(d.catalog.info_schema().table(
            "test", name).id)

    segs = np.array(["BUILDING", "MACHINERY", "AUTO", "HOUSE"],
                    dtype=object)
    table("cust").bulk_load_arrays([
        np.arange(n_cust, dtype=np.int64),
        rng.integers(0, 12, n_cust),
        segs[rng.integers(0, 4, n_cust)],
    ], ts=ts)
    table("ord").bulk_load_arrays([
        np.arange(n_ord, dtype=np.int64),
        rng.integers(0, n_cust - 60, n_ord),
        rng.integers(0, 5, n_ord),
        rng.uniform(10, 9999, n_ord),
    ], ts=ts)
    ik = rng.integers(0, n_ord * 2, n_item)
    ivalid = [np.ones(n_item, np.bool_), None, None, None]
    ivalid[0][rng.integers(0, n_item, 300)] = False
    table("item").bulk_load_arrays([
        ik,
        rng.integers(0, n_part, n_item),
        rng.integers(1, 51, n_item),
        rng.integers(100, 1_000_000, n_item),
    ], ivalid, ts=ts)
    cats = np.array([f"CAT{i:02d}" for i in range(9)], dtype=object)
    table("part").bulk_load_arrays([
        np.arange(n_part, dtype=np.int64),
        cats[rng.integers(0, 9, n_part)],
    ], ts=ts)
    for t in ("cust", "ord", "item", "part"):
        s.execute(f"analyze table {t}")
    return s


@pytest.fixture(scope="module")
def tree_pair():
    return _pair_of(_load_tree_tables)


@pytest.fixture(scope="module")
def tpch_pair():
    from tidb_tpu.tpch_data import build_tpch_domain as j_build
    from tidb_tpu_torch.tpch_data import build_tpch_domain as t_build

    js, ts = j_build(scale=1), t_build(scale=1)
    js.execute("set tidb_use_tpu = 0")
    ts.execute("set tidb_use_tpu = 1")
    return js, ts


def _tree_parity(pair, sql, ordered=False):
    js, ts = pair
    t0, f0 = _snap("mpp_tree_joins_total", "mpp_fallback_total")
    got = ts.query(sql)
    t1, f1 = _snap("mpp_tree_joins_total", "mpp_fallback_total")
    assert t1 > t0, f"not served by the device rung ladder: {sql}"
    assert f1 == f0, f"fell back to the host join chain: {sql}"
    want = js.query(sql)
    if ordered:
        assert _norm(got) == _norm(want), sql
    else:
        assert _sorted(got) == _sorted(want), sql
    return got


@pytest.mark.parametrize("name,sql", TREES, ids=[t[0] for t in TREES])
def test_tree_parity(tree_pair, name, sql):
    got = _tree_parity(tree_pair, sql)
    assert got
    if name == "not-in":
        assert got[0][0] > 0  # the 60 order-less custkeys


def _spans(sess, name):
    out = []

    def walk(s):
        if s.name == name:
            out.append(s)
        for c in s.children:
            walk(c)

    walk(sess.last_trace.root)
    return out


def test_no_transfers_between_rungs_when_warm(tree_pair):
    """On a warm column cache the whole ladder runs with ZERO
    copr.transfer spans: the intermediate never leaves the card between
    rungs, and the grouped partials run in one final program."""
    ts = tree_pair[1]
    ts.query(FOUR_WAY_AGG)
    ts.execute("trace " + FOUR_WAY_AGG)
    assert _spans(ts, "mpp.tree"), "not served by the rung ladder"
    assert len(_spans(ts, "mpp.rung")) == 3
    assert not _spans(ts, "copr.transfer")
    assert len(_spans(ts, "mpp.tree.final")) == 1


SJ = ("select count(*) from lineitem where l_orderkey in"
      " (select o_orderkey from orders where o_orderdate < '1994-09-01')")


def _tpch(name):
    from tidb_tpu_torch.tpch_data import TPCH_QUERIES

    return TPCH_QUERIES[name]


@pytest.mark.parametrize("name,key", [
    ("q3", lambda r: (-r[1], r[0])),
    ("q5", lambda r: -r[1]),
    ("q10", lambda r: (-r[2], r[0])),
])
def test_tpch_join_trees(tpch_pair, name, key):
    """The port's ordered rows == the JAX package's rows of the body
    (the statement without its ORDER BY ... LIMIT), sorted by value."""
    sql = _tpch(name)
    ops_ = [r[0] for r in tpch_pair[1].execute("explain " + sql)[0].rows]
    assert any("MPPJoinTree" in op for op in ops_), ops_
    body = sql[:sql.lower().rindex("order by")]
    want = _tree_parity(tpch_pair, body)
    m = re.search(r"limit (\d+)", sql.lower())
    limit = int(m.group(1)) if m else len(want)
    got = tpch_pair[1].query(sql)
    assert _norm(got) == _norm(sorted(want, key=key)[:limit]), name


def test_tpch_semi_join_tree(tpch_pair):
    ops_ = [r[0] for r in tpch_pair[1].execute("explain " + SJ)[0].rows]
    assert any("MPPJoinTree" in op for op in ops_), ops_
    assert _tree_parity(tpch_pair, SJ)[0][0] > 0


# ---------------------------------------------------------------------------
# (d) EXPLAIN parity with the JAX planner
# ---------------------------------------------------------------------------


def _plan(sess, sql):
    """EXPLAIN rows without the per-session plan-id counters."""
    return [tuple(re.sub(r"_\d+\b", "", str(x)) for x in r)
            for r in sess.execute("explain " + sql)[0].rows]


def _explain_parity(pair, statements):
    js, ts = pair
    js.execute("set tidb_use_tpu = 1")
    ts.execute("set tidb_use_tpu = 1")
    for sql in statements:
        assert _plan(ts, sql) == _plan(js, sql), sql


def test_explain_parity_tpch():
    """Fresh domains: the statistics that statements run before would
    feed back into the estimates differ between the two engines."""
    from tidb_tpu.tpch_data import build_tpch_domain as j_build
    from tidb_tpu_torch.tpch_data import TPCH_QUERIES
    from tidb_tpu_torch.tpch_data import build_tpch_domain as t_build

    _explain_parity((j_build(scale=1), t_build(scale=1)),
                    [q for n, q in TPCH_QUERIES.items() if n != "q11"]
                    + [SJ])


def test_explain_parity_pair_statements():
    pair = _pair_of(_load_pair_tables)
    _explain_parity(pair, [p[1] for p in PAIR])
    _explain_parity(_pair_of(_load_dup_tables), [p[1] for p in DUP])
    plan = "\n".join(" ".join(r) for r in _plan(pair[1], INNER))
    assert "MPPJoin" in plan and "ExchangeSender" in plan


# ---------------------------------------------------------------------------
# (e) the ladders, and no host step-down on a device error
# ---------------------------------------------------------------------------


def test_shuffle_overflow_demotes_to_broadcast(pair, monkeypatch):
    monkeypatch.setenv("TIDB_TPU_MPP_SLACK", "0.01")
    o0 = _snap("mpp_partition_overflow_total")[0]
    _mpp_parity(pair, INNER, "broadcast")
    assert _snap("mpp_partition_overflow_total")[0] > o0


def test_group_budget_overflow_peels_the_aggregation(pair, monkeypatch):
    monkeypatch.setenv("TIDB_TPU_MPP_GROUP_BUDGET", "8")
    q = ("select l_orderkey, count(*), sum(o_total) from li join orders"
         " on l_orderkey = o_orderkey group by l_orderkey")
    o0 = _snap("mpp_grouped_agg_overflow_total")[0]
    _mpp_parity(pair, q, "shuffle+agg-peel")
    assert _snap("mpp_grouped_agg_overflow_total")[0] > o0


def test_tree_budget_overflow_peels_the_aggregation(tree_pair, monkeypatch):
    monkeypatch.setenv("TIDB_TPU_MPP_GROUP_BUDGET", "4")
    o0 = _snap("mpp_grouped_agg_overflow_total")[0]
    _tree_parity(tree_pair, FOUR_WAY_AGG)
    assert _snap("mpp_grouped_agg_overflow_total")[0] > o0
    rows = tree_pair[1].execute("explain analyze " + FOUR_WAY_AGG)[0].rows
    assert any("+agg-peel" in str(r[4]) for r in rows)


@pytest.mark.parametrize("msg", ["exchange program failed",
                                 "device lost"])
def test_device_error_reaches_the_statement(pair, tree_pair, monkeypatch,
                                            msg):
    """A RuntimeError raised inside the exchange program (unclassified,
    or classified as a device fault, which retries on the card first)
    fails the statement; no host join serves it."""
    from tidb_tpu_torch.mpp import exchange as tex

    def broken(*a, **k):
        raise RuntimeError(msg)

    monkeypatch.setattr(tex, "expand_matches", broken)
    for p, sql in ((pair, INNER), (tree_pair, THREE_WAY)):
        f0 = _snap("mpp_fallback_total")[0]
        with pytest.raises(RuntimeError, match=msg):
            p[1].query(sql)
        assert _snap("mpp_fallback_total")[0] == f0

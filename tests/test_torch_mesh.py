"""The port's multi-position mesh (S > 1) against the JAX package.

One module-scoped pair of domains runs at `ops.use_device("cpu",
shards=8)` (the JAX package's 8 virtual CPU devices) and restores
`use_device("cpu")` at teardown: later modules in the same worker
assume S = 1.

(a) Statements from SQL at S = 8 — Q1, Q6, sort-mode aggregation, a
    computed string key (K1's plain version), TopN, a filter, a cold
    table (K2's plain version, one decode a shard) and a table with
    deletes — equal the JAX package's host engine (`tidb_use_tpu = 0`;
    its shard_map programs cannot be built under the installed jax) and
    the port at S = 1: ints and decimals exactly, floats after `_norm`.
(b) The collectives: `exchange` / `replicate` at S = 4 against a numpy
    all_to_all / all_gather oracle over the JAX package's own
    `partition_ids` / `pack_buckets` (held exactly), and `psum`'s shard
    order.
(c) MPP at S = 4: a shuffle pair join, scalar and grouped exchanges, a
    left-outer join and TPC-H q3 as a join tree against the host engine,
    and the overflow ladder (shuffle -> broadcast).
(d) Degraded-mesh failover, the counterparts of tests/test_chaos.py's
    device-kill, failed-probe, HBM-OOM, all-breakers-open (the port's
    `DeviceUnavailableError` rule: no host step-down) and tile-path
    tests, and the `coord/member_lost` epoch guard.
"""

import contextlib
import math
import os

import numpy as np
import pytest

from tidb_tpu_torch import ops as tops
from tidb_tpu_torch.metrics import REGISTRY

S = 8
N_T = 30_000   # 30 tiles of conftest's TIDB_TPU_TILE=1024: rows in every shard

Q1 = ("select g, sum(x), count(*), min(x), max(x), avg(x) from t "
      "group by g order by g")
Q6 = "select sum(x) from t where k < 25000 and x < 50"
TOPN = "select k, x from t order by x desc limit 7"
FILTER = "select k from t where x < 2.5"
SWEEP = (Q1, Q6, TOPN, FILTER)

LINEITEM = {
    "q1": None,  # tpch_data.LINEITEM_Q1
    "q6": None,  # tpch_data.LINEITEM_Q6
    "ck1": "select lower(l_returnflag), l_linestatus, sum(l_quantity),"
           " sum(l_extendedprice * (1 - l_discount)), avg(l_discount),"
           " count(*) from lineitem where l_shipdate <= '1998-09-02'"
           " group by lower(l_returnflag), l_linestatus",
    "sa": "select l_orderkey, sum(l_quantity), count(*) from lineitem"
          " where l_orderkey <= 100000 group by l_orderkey",
    "tn": "select l_orderkey, l_extendedprice from lineitem"
          " where l_shipdate >= '1995-03-15'"
          " order by l_extendedprice desc, l_orderkey limit 10",
    "filter": "select l_orderkey, l_quantity, l_discount from lineitem"
              " where l_quantity < 4 and l_discount > 0.05",
}
ORDERED = ("q1", "tn")


def _sql(name):
    from tidb_tpu_torch.tpch_data import LINEITEM_Q1, LINEITEM_Q6

    return {"q1": LINEITEM_Q1, "q6": LINEITEM_Q6}.get(name) \
        or LINEITEM[name]


def _norm(rows):
    return [tuple(round(v, 6) if isinstance(v, float) else v for v in r)
            for r in rows]


def _sorted(rows):
    return sorted(_norm(rows), key=lambda r: tuple(
        (0, "") if x is None else (1, str(x)) for x in r))


def _snap(*names):
    s = REGISTRY.snapshot()
    return tuple(s.get(n, 0) for n in names)


@contextlib.contextmanager
def _shards(n):
    """Run the body at a mesh of `n` positions, then back at S."""
    tops.use_device("cpu", shards=n)
    try:
        yield
    finally:
        tops.use_device("cpu", shards=S)


def _mesh_ids():
    from tidb_tpu_torch.copr import parallel as pl

    return pl._MESH.ids if pl._MESH is not None else ()


def _load_t(d, n=N_T, name="t", seed=7):
    """tests/test_chaos.py's table at N_T rows."""
    s = d.new_session()
    s.execute(f"create table {name} (k bigint, g bigint, x double)")
    t = d.catalog.info_schema().table("test", name)
    rng = np.random.default_rng(seed)
    d.storage.table(t.id).bulk_load_arrays(
        [np.arange(n, dtype=np.int64), rng.integers(0, 5, n, dtype=np.int64),
         rng.uniform(0, 100, n)], ts=d.storage.current_ts())
    d.storage.regions.split_even(t.id, 4, n)
    return s


@pytest.fixture(scope="module")
def env():
    from tidb_tpu.copr.parallel import MESH_CACHE as J_MESH
    import tidb_tpu.layout as jlayout
    import tidb_tpu.tpch_data as jdata
    from tidb_tpu_torch.copr import parallel as pl
    from tidb_tpu_torch.copr.device_health import DEVICE_HEALTH
    import tidb_tpu_torch.layout as tlayout
    import tidb_tpu_torch.tpch_data as tdata

    # the cold cells move the hot cap, which lives in the environment
    saved = {k: os.environ.get(k)
             for k in ("TIDB_TPU_HBM_BYTES", "TIDB_TPU_LAYOUT_RETUNE_S")}
    os.environ["TIDB_TPU_LAYOUT_RETUNE_S"] = "0"
    tops.use_device("cpu", shards=S)
    caps = (J_MESH._c.capacity, pl.MESH_CACHE._c.capacity)
    js = jdata.build_lineitem(16_384, regions=4, seed=7)
    ts = tdata.build_lineitem(16_384, regions=4, seed=7)
    js.execute("set tidb_use_tpu = 0")
    ts.execute("set tidb_use_tpu = 1")
    jt, tt = _load_t(js.domain), _load_t(ts.domain)
    jt.execute("set tidb_use_tpu = 0")
    tt.execute("set tidb_use_tpu = 1")
    yield {"j": js, "t": ts, "jt": jt, "tt": tt, "tlayout": tlayout}
    DEVICE_HEALTH.reset()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    J_MESH._c.capacity, pl.MESH_CACHE._c.capacity = caps
    for lay, mesh in ((jlayout, J_MESH), (tlayout, pl.MESH_CACHE)):
        mesh.clear()
        lay.coldtier.clear()
        lay.LAYOUT.reset()
    tops.use_device("cpu")


@pytest.fixture(autouse=True)
def _healthy():
    from tidb_tpu_torch.copr.device_health import DEVICE_HEALTH

    DEVICE_HEALTH.reset()
    yield
    DEVICE_HEALTH.reset()


def _engines(sess, sql):
    rows = sess.execute("explain analyze " + sql)[0].rows
    return [r[4] for r in rows if "TableReader" in r[0]]


def _parity(js, ts, sql, ordered):
    """The port at S == the JAX host engine == the port at S = 1, served
    by the mesh at S positions."""
    want = js.query(sql)
    m0 = _snap("mesh_scans_total")[0]
    got = ts.query(sql)
    assert _snap("mesh_scans_total")[0] > m0, sql
    assert len(_mesh_ids()) == S
    eng = _engines(ts, sql)
    assert eng and all("engine:mesh" in e for e in eng), eng
    with _shards(1):
        one = ts.query(sql)
        assert len(_mesh_ids()) == 1
    assert got
    if ordered:
        assert _norm(got) == _norm(want) == _norm(one), sql
    else:
        assert _sorted(got) == _sorted(want) == _sorted(one), sql
    return got


# ---------------------------------------------------------------------------
# (a) statements at S = 8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(LINEITEM))
def test_hot_statement_rows(env, name):
    _parity(env["j"], env["t"], _sql(name), name in ORDERED)


def test_table_with_deletes(env):
    """MVCC-deleted rows in several shards mask out of every shard's
    program (the deletion mask is sharded like the columns)."""
    js, ts = env["jt"], env["tt"]
    jd = _load_t(js.domain, n=12_000, name="td2", seed=9)
    td = _load_t(ts.domain, n=12_000, name="td2", seed=9)
    jd.execute("set tidb_use_tpu = 0")
    td.execute("set tidb_use_tpu = 1")
    for s in (jd, td):
        s.execute("delete from td2 where k % 97 = 3 or (k > 5000 and"
                  " k < 5400)")
    sql = ("select g, count(*), sum(x), min(k), max(k) from td2"
           " group by g order by g")
    _parity(jd, td, sql, ordered=True)


def test_float_sums_have_the_same_bits_every_run(env, monkeypatch):
    """Float partials merge in shard order: at a fixed S and chunking (2
    shards a dispatch chunk here) a float sum has the same bits on every
    run, and is within 1e-12 of math.fsum."""
    monkeypatch.setenv("TIDB_TPU_DISPATCH_CHUNK_ROWS", "8192")
    tt = env["tt"]
    sql = "select g, sum(x) from t group by g order by g"
    runs = [tt.query(sql) for _ in range(3)]
    assert runs[0] == runs[1] == runs[2]
    d = tt.domain
    t = d.storage.table(d.catalog.info_schema().table("test", "t").id)
    blocks = list(t.iter_base_blocks([1, 2], 0, t.base_rows))
    g = np.concatenate([a[0] for _o, a, _v in blocks])
    x = np.concatenate([a[1] for _o, a, _v in blocks])
    for gi, total in runs[0]:
        want = math.fsum(x[g == gi])
        assert abs(total - want) <= 1e-12 * abs(want)


# ---------------------------------------------------------------------------
# cold tier at S = 8 (after the hot cells: it moves the cap)
# ---------------------------------------------------------------------------


def _lineitem(sess):
    d = sess.domain
    return d.storage.table(d.catalog.info_schema().table(
        "test", "lineitem").id)


def _cold_cap(layout, table) -> int:
    at = layout.autotuner
    unpackable = sum(at._column_wire_bytes(table, ci)
                     for ci in range(table.n_cols)
                     if layout.coldtier.pack_info(table, ci) is None)
    return int(unpackable / at.LayoutEngine.HOT_FILL) + 1024


@pytest.mark.parametrize("name", ["q1", "q6", "ck1"])
def test_cold_statement_rows(env, name, monkeypatch):
    """The packable columns live bit-packed, sharded: K2's plain version
    decodes each shard's codes where they live (no call spans more than
    a shard's rows), and K1's plain version re-maps the decoded codes
    of a computed key."""
    from tidb_tpu_torch.copr.cuda import remap as tremap
    from tidb_tpu_torch.copr.cuda import unpack as tunpack

    tlayout = env["tlayout"]
    tlayout.set_hot_cap_bytes(_cold_cap(tlayout, _lineitem(env["t"])))
    unpacks, remaps = [], []
    real_u, real_r = tunpack.unpack_codes_plain, tremap.remap_codes_plain

    def spy_u(packed, bits, n, bias=None):
        if len(_mesh_ids()) == S:
            unpacks.append(n)
        return real_u(packed, bits, n, bias)

    def spy_r(codes, mapping, n):
        if len(_mesh_ids()) == S:
            remaps.append(n)
        return real_r(codes, mapping, n)

    monkeypatch.setattr(tunpack, "unpack_codes_plain", spy_u)
    monkeypatch.setattr(tremap, "remap_codes_plain", spy_r)
    h0 = _snap("layout_cold_hits_total")[0]
    _parity(env["j"], env["t"], _sql(name), name in ORDERED)
    assert _snap("layout_cold_hits_total")[0] > h0
    n_local = 16_384 // S
    assert unpacks and max(unpacks) <= n_local
    assert (len(remaps) >= S) == (name == "ck1")
    assert max(remaps or [0]) <= n_local


# ---------------------------------------------------------------------------
# (b) the collectives
# ---------------------------------------------------------------------------


def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def test_sharded_pack_and_exchange_match_jax_and_numpy():
    """4 shards each hash-partition and pack their rows: partition ids
    and packs equal the JAX functions exactly; the exchange equals a
    numpy all_to_all of the JAX packs (row block j of shard d's array =
    what shard j sent to d)."""
    import jax.numpy as jnp

    from tidb_tpu.mpp import exchange as jex
    from tidb_tpu_torch.mpp import exchange as tex

    rng = np.random.default_rng(21)
    n_sh, n, cap = 4, 500, 160
    keys = [rng.integers(-10**6, 10**6, n).astype(np.int64)
            for _ in range(n_sh)]
    masks = [rng.random(n) < 0.9 for _ in range(n_sh)]
    vals = [rng.uniform(-1, 1, n) for _ in range(n_sh)]
    packs, jpacks = [], []
    for k, m, v in zip(keys, masks, vals):
        pid = tex.partition_ids(_t(k), n_sh)
        jpid = jex.partition_ids(jnp.asarray(k), n_sh)
        assert np.array_equal(pid.numpy(), np.asarray(jpid))
        got = tex.pack_buckets(pid, _t(m), n_sh, cap, [_t(k), _t(v)])
        want = jex.pack_buckets(jpid, jnp.asarray(m), n_sh, cap,
                                [jnp.asarray(k), jnp.asarray(v)])
        for g, w in zip(got[0] + [got[1]], want[0] + [want[1]]):
            assert np.array_equal(g.numpy(), np.asarray(w))
        assert int(got[2]) == int(want[2])
        packs.append(got)
        jpacks.append(want)
    for i in range(2):
        recv = tex.exchange([p[0][i] for p in packs])
        oracle = [np.concatenate([np.asarray(jp[0][i])[d] for jp in jpacks])
                  for d in range(n_sh)]
        for r, o in zip(recv, oracle):
            assert np.array_equal(r.numpy(), o)
    recv_ok = tex.exchange([p[1] for p in packs])
    # every selected row arrives exactly once, at its partition's shard
    total = sum(int(m.sum()) for m in masks)
    assert sum(int(r.sum()) for r in recv_ok) == total


def test_replicate_and_psum_match_numpy():
    from tidb_tpu_torch.mpp import exchange as tex

    rng = np.random.default_rng(22)
    parts = [rng.uniform(-1e6, 1e6, (3, 5)) for _ in range(4)]
    got = tex.replicate([_t(p) for p in parts])
    oracle = np.concatenate([p.reshape(-1) for p in parts])
    assert len(got) == 4
    for g in got:
        assert np.array_equal(g.numpy(), oracle)
    # psum: a left fold in shard order, bit for bit
    acc = parts[0].copy()
    for p in parts[1:]:
        acc = acc + p
    assert np.array_equal(tops.psum([_t(p) for p in parts]).numpy(), acc)


# ---------------------------------------------------------------------------
# (c) MPP at S = 4
# ---------------------------------------------------------------------------

MPP = [
    ("inner", "select l_orderkey, l_qty, o_flag, o_total from li join orders"
              " on l_orderkey = o_orderkey where l_qty < 40", "shuffle"),
    ("louter", "select l_orderkey, l_qty, o_flag from li left join orders"
               " on l_orderkey = o_orderkey", "shuffle"),
    ("scalar", "select count(*), sum(l_price), avg(o_total), min(l_qty),"
               " max(o_total) from li join orders on l_orderkey ="
               " o_orderkey where l_qty < 30", "shuffle"),
    ("grouped", "select o_flag, substr(o_clerk, 2, 2), count(*),"
                " sum(l_price), min(l_qty), max(o_total) from li join"
                " orders on l_orderkey = o_orderkey"
                " group by o_flag, substr(o_clerk, 2, 2)",
     "shuffle+grouped"),
]


def _load_pair(d):
    """4,000 orders, 24,000 line rows (tests/test_mpp.py's shape)."""
    s = d.new_session()
    s.execute("create table orders (o_orderkey bigint primary key,"
              " o_flag bigint, o_total double, o_clerk varchar(8))")
    s.execute("create table li (l_orderkey bigint, l_qty bigint,"
              " l_price decimal(12,2))")
    rng = np.random.default_rng(11)
    isc = d.catalog.info_schema()
    clerks = np.array([f"c{i:03d}" for i in range(40)], dtype=object)
    d.storage.table(isc.table("test", "orders").id).bulk_load_arrays([
        np.arange(4000, dtype=np.int64), rng.integers(0, 5, 4000),
        rng.uniform(1, 9999, 4000), clerks[rng.integers(0, 40, 4000)],
    ], ts=d.storage.current_ts())
    lvalid = [np.ones(24_000, np.bool_), None, None]
    lvalid[0][rng.integers(0, 24_000, 500)] = False
    d.storage.table(isc.table("test", "li").id).bulk_load_arrays([
        rng.integers(0, 12_000, 24_000), rng.integers(1, 51, 24_000),
        rng.integers(100, 1_000_000, 24_000)], lvalid,
        ts=d.storage.current_ts())
    s.execute("analyze table orders")
    s.execute("analyze table li")
    s.execute("set tidb_enforce_mpp = 1")
    return s


@pytest.fixture(scope="module")
def mpp_pair(env):
    from tidb_tpu.session import Domain as JDomain
    from tidb_tpu_torch.session import Domain as TDomain

    js, ts = _load_pair(JDomain()), _load_pair(TDomain())
    js.execute("set tidb_use_tpu = 0")
    ts.execute("set tidb_use_tpu = 1")
    return js, ts


def _metric(mode):
    return "mpp_joins_" + mode.replace("+", "_").replace("-", "_") + "_total"


@pytest.mark.parametrize("name,sql,mode", MPP, ids=[m[0] for m in MPP])
def test_mpp_pair_at_s4(mpp_pair, name, sql, mode):
    js, ts = mpp_pair
    with _shards(4):
        m0, f0 = _snap(_metric(mode), "mpp_fallback_total")
        got = ts.query(sql)
        assert len(_mesh_ids()) == 4
        m1, f1 = _snap(_metric(mode), "mpp_fallback_total")
    assert m1 > m0 and f1 == f0, (name, m1 - m0, f1 - f0)
    assert got and _sorted(got) == _sorted(js.query(sql)), name


def test_shuffle_overflow_demotes_to_broadcast_at_s4(mpp_pair, monkeypatch):
    monkeypatch.setenv("TIDB_TPU_MPP_SLACK", "0.01")
    js, ts = mpp_pair
    sql = MPP[0][1]
    with _shards(4):
        o0, b0 = _snap("mpp_partition_overflow_total",
                       _metric("broadcast"))
        got = ts.query(sql)
        o1, b1 = _snap("mpp_partition_overflow_total",
                       _metric("broadcast"))
    assert o1 > o0 and b1 > b0
    assert _sorted(got) == _sorted(js.query(sql))


def test_tpch_q3_join_tree_at_s4(env):
    """TPC-H q3 as a join tree over 4 shards: the port's ordered rows
    == the JAX host engine's rows of the body, sorted by value (its host
    sort ranks DECIMAL(38, s) sums by their digits)."""
    import re

    from tidb_tpu.tpch_data import build_tpch_domain as j_build
    from tidb_tpu_torch.tpch_data import TPCH_QUERIES
    from tidb_tpu_torch.tpch_data import build_tpch_domain as t_build

    js, ts = j_build(scale=1), t_build(scale=1)
    js.execute("set tidb_use_tpu = 0")
    ts.execute("set tidb_use_tpu = 1")
    sql = TPCH_QUERIES["q3"]
    body = sql[:sql.lower().rindex("order by")]
    with _shards(4):
        t0, f0 = _snap("mpp_tree_joins_total", "mpp_fallback_total")
        got = ts.query(sql)
        t1, f1 = _snap("mpp_tree_joins_total", "mpp_fallback_total")
    assert t1 > t0 and f1 == f0
    limit = int(re.search(r"limit (\d+)", sql.lower()).group(1))
    want = sorted(js.query(body), key=lambda r: (-r[1], r[0]))[:limit]
    assert got and _norm(got) == _norm(want)


# ---------------------------------------------------------------------------
# (d) degraded-mesh failover
# ---------------------------------------------------------------------------


def _want(env, sql):
    return env["jt"].query(sql)


def _rows_eq(got, want, ctx=""):
    assert _sorted(got) == _sorted(want), ctx


def _kill(pos, msg="halted mid-scan"):
    from tidb_tpu_torch.copr.device_health import DeviceFailure
    from tidb_tpu_torch.store.fault import once

    return once(DeviceFailure(f"device {pos} {msg}", device_ids=(pos,)))


def _health(tt):
    return {r[0]: r for r in tt.query(
        "select device_id, state, error_count, trip_count, in_current_mesh"
        " from information_schema.tidb_tpu_device_health")}


def _holds(pos) -> list:
    """Cache keys that still place anything on position `pos`."""
    from tidb_tpu_torch.copr import parallel as pl
    from tidb_tpu_torch.copr import torch_engine as te
    from tidb_tpu_torch.layout import COLD_CACHE

    return ([k for k in pl.MESH_CACHE._cache if pos in k[3]]
            + [k for k in COLD_CACHE.items_view if pos in k[3]]
            + [k for k in te.DEVICE_CACHE._c.items_view if k[4] == pos])


def test_device_kill_mid_scan_serves_from_rebuilt_mesh(env):
    """Kill position 3 mid-scan: Q1/Q6/TopN complete with the host
    engine's rows on a REBUILT mesh of 7 positions; nothing of position
    3 stays cached; the health table shows the tripped breaker, and a
    half-open probe restores the full mesh."""
    from tidb_tpu_torch.copr.device_health import DEVICE_HEALTH
    from tidb_tpu_torch.store.fault import failpoint

    tt = env["tt"]
    tt.query(Q6)
    assert len(_mesh_ids()) == S
    r0 = _snap("mesh_rebuilds_total")[0]
    with failpoint("mesh/device_error", _kill(3)):
        plan = "\n".join(str(r) for r in tt.execute(
            "explain analyze " + Q6)[0].rows)
    assert "engine:mesh" in plan, plan
    ids = _mesh_ids()
    assert len(ids) == S - 1 and 3 not in ids, ids
    assert _snap("mesh_rebuilds_total")[0] > r0
    for sql in (Q1, Q6, TOPN):
        f0 = _snap("mesh_failover_retries_total")[0]
        with failpoint("mesh/device_error", _kill(3)):
            got = tt.query(sql)
        _rows_eq(got, _want(env, sql), sql)
        assert _snap("mesh_failover_retries_total")[0] > f0
        assert len(_mesh_ids()) == S - 1 and 3 not in _mesh_ids()
    h = _health(tt)
    assert h[3][1] == "tripped" and h[3][2] >= 1 and h[3][3] >= 1
    assert h[3][4] == 0 and h[0][1] == "healthy" and h[0][4] == 1
    assert REGISTRY.snapshot().get("device_health_tripped_count") == 1
    assert _holds(3) == []
    DEVICE_HEALTH.expire_cooldowns()
    _rows_eq(tt.query(Q1), _want(env, Q1), "post-probe Q1")
    assert len(_mesh_ids()) == S
    h = _health(tt)
    assert h[3][1] == "healthy" and h[3][4] == 1
    assert REGISTRY.snapshot().get("device_health_tripped_count") == 0


def test_failed_probe_retrips_breaker(env):
    from tidb_tpu_torch.copr.device_health import DEVICE_HEALTH
    from tidb_tpu_torch.store.fault import failpoint

    tt = env["tt"]
    tt.query(Q6)
    DEVICE_HEALTH.record_error(2, RuntimeError("first failure"))
    assert DEVICE_HEALTH.state_of(2) == "tripped"
    DEVICE_HEALTH.expire_cooldowns()
    with failpoint("mesh/device_error", _kill(2, "still dead")):
        got = tt.query(Q6)
    _rows_eq(got, _want(env, Q6), Q6)
    assert DEVICE_HEALTH.state_of(2) == "tripped"
    assert 2 not in _mesh_ids() and len(_mesh_ids()) == S - 1


def test_hbm_oom_evicts_caches_and_retries(env):
    """An OOM evicts the device caches wholesale and re-runs on the same
    mesh; no breaker trips."""
    from tidb_tpu_torch.copr import parallel as pl
    from tidb_tpu_torch.copr.device_health import DEVICE_HEALTH, HbmOomError
    from tidb_tpu_torch.store.fault import failpoint, once

    tt = env["tt"]
    tt.query(Q1)
    assert pl.MESH_CACHE._cache
    o0 = _snap("mesh_hbm_oom_total")[0]
    with failpoint("mesh/hbm_oom",
                   once(HbmOomError("RESOURCE_EXHAUSTED: HBM space"))):
        got = tt.query(Q1)
    _rows_eq(got, _want(env, Q1), Q1)
    assert _snap("mesh_hbm_oom_total")[0] == o0 + 1
    assert len(_mesh_ids()) == S
    assert DEVICE_HEALTH.tripped_ids() == ()
    assert pl.MESH_CACHE._cache  # re-warmed by the retry


def test_all_breakers_open_raises_device_unavailable(env):
    """Every breaker open and no probe due: the statement fails typed
    (the port's rule), no host rung serves it."""
    from tidb_tpu_torch.copr.device_health import DEVICE_HEALTH
    from tidb_tpu_torch.errors import DeviceUnavailableError

    for pid in tops.device_ids():
        DEVICE_HEALTH.record_error(pid, RuntimeError(f"dead {pid}"))
    c0 = _snap("cop_region_cpu_runs_total")[0]
    with pytest.raises(DeviceUnavailableError, match="breaker is open"):
        env["tt"].query(Q6)
    assert _snap("cop_region_cpu_runs_total")[0] == c0


def test_tile_path_routes_around_tripped_position(env):
    """The per-tile rung (a request over more disjoint ranges than the
    fused program's slots) places tiles round-robin over the healthy
    positions only, with the host engine's rows."""
    from tidb_tpu_torch.copr import torch_engine as te
    from tidb_tpu_torch.copr.device_health import DEVICE_HEALTH
    from tidb_tpu_torch.session.session import run_over_spans

    DEVICE_HEALTH.record_error(0, RuntimeError("position 0 sick"))
    assert 0 not in [c.id for c in te._tile_devices()]
    spans = [(0, 2000), (3000, 5100), (7000, 9000), (12_000, 15_000),
             (20_000, 21_000), (26_000, 29_500)]
    sql = "select k, x from t where x < 10"
    te.DEVICE_CACHE.clear()
    tt, jt = env["tt"], env["jt"]
    tt.query(sql)
    rows, engines = run_over_spans(tt, tt.last_plan, spans)
    assert any("tile-fanout" in e for e in engines), engines
    want = [r for r in jt.query(sql)
            if any(lo <= r[0] < hi for lo, hi in spans)]
    _rows_eq(rows, want, "tile path")
    placed = {k[4] for k in te.DEVICE_CACHE._c.items_view}
    assert len(placed) > 1 and 0 not in placed, placed
    assert DEVICE_HEALTH.state_of(0) == "tripped"
    te.DEVICE_CACHE.clear()


def test_card_error_trips_every_position_on_that_card(monkeypatch):
    """A runtime error naming a physical card implicates every position
    that card holds; a `DeviceFailure` payload names positions."""
    import torch

    from tidb_tpu_torch.copr import parallel as pl
    from tidb_tpu_torch.copr.device_health import DeviceFailure

    cards = [(0, torch.device("cuda", 0)), (1, torch.device("cuda", 0)),
             (2, torch.device("cuda", 1)), (3, torch.device("cuda", 1))]
    monkeypatch.setattr(tops, "mesh_devices", lambda: cards)
    err = RuntimeError("CUDA error: device 1 halted (unavailable)")
    assert pl._failed_positions(err) == (2, 3)
    assert pl._failed_positions(DeviceFailure("x", device_ids=(1,))) == (1,)


@pytest.mark.parametrize("sql", SWEEP, ids=["q1", "q6", "topn", "filter"])
def test_member_lost_rebuilds_with_parity(env, sql):
    """A membership epoch bump between mesh build and dispatch raises the
    typed CoordEpochMismatch; the mesh rebuilds and the statement
    re-runs with the host engine's rows, tripping no breaker."""
    from tidb_tpu_torch.coord import get_plane
    from tidb_tpu_torch.copr.device_health import DEVICE_HEALTH
    from tidb_tpu_torch.store.fault import FAILPOINTS, failpoint

    plane = get_plane()
    fired = {"n": 0}

    def bump_once(**_ctx):
        if fired["n"] == 0:
            plane.bump("chaos: member lost")
        fired["n"] += 1

    m0 = _snap("coord_epoch_mismatch_total")[0]
    with failpoint("coord/member_lost", bump_once):
        got = env["tt"].query(sql)
    _rows_eq(got, _want(env, sql), sql)
    assert fired["n"] >= 2
    assert _snap("coord_epoch_mismatch_total")[0] == m0 + 1
    assert DEVICE_HEALTH.tripped_ids() == ()
    assert FAILPOINTS.armed() == []


def test_coordinator_env_refuses_to_run_single_host(env, monkeypatch):
    """With TIDB_TPU_COORDINATOR set the mesh joins a process group; a
    coordinator nobody answers fails the statement with the typed
    CollectiveError instead of running this process alone."""
    from tidb_tpu_torch.copr import parallel as pl
    from tidb_tpu_torch.errors import CollectiveError

    monkeypatch.setenv("TIDB_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("TIDB_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("TIDB_TPU_PROCESS_ID", "1")
    monkeypatch.setenv("TIDB_TPU_DIST_TIMEOUT_S", "1")
    with pytest.raises(CollectiveError, match="could not join"):
        pl.get_mesh()
    assert tops.process_count() == 1 and not pl._DIST_INIT

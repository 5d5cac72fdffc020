"""The slices as a whole: TPC-H Q1 and Q6, and the sort-mode, computed
key and TopN cells (`ck1`, `ck2`, `sa`, `tn`, `q18i`), from SQL, hot and
cold tier.

Both packages build the same lineitem (16,384 rows, 4 regions, seed 7:
16 tiles under conftest's TIDB_TPU_TILE=1024) and run Q1 and Q6 with
`tidb_use_tpu = 1`, first in the default (all-hot) layout and then with
the hot-tier cap below the table's wire bytes, which moves the packable
columns (l_returnflag 2 bits, l_linestatus 1 bit, l_discount and l_tax 4
bits) to the cold tier.  The port's rows must equal the JAX package's
after `_norm` (ints and decimals exact, floats to 6 places), its scans
must report `engine:mesh`, and the cold leg must serve cold hits through
the plain unpack version (CPU tensors).  The second slice's cells are
held against the JAX package's host engine (`tidb_use_tpu = 0`, whose
rows equal its device rungs'); in the cold leg their computed keys read
K2's decoded codes through K1's plain version.
"""

import os

import pytest
import torch

from tidb_tpu_torch import ops as tops

Q_NAMES = ("q1", "q6")


def _norm(rows):
    return [tuple(round(v, 6) if isinstance(v, float) else v for v in r)
            for r in rows]


def _queries():
    from tidb_tpu_torch.tpch_data import LINEITEM_Q1, LINEITEM_Q6

    return {"q1": LINEITEM_Q1, "q6": LINEITEM_Q6}


#: the second slice's cells (chip_smoke.py runs them at SF10 / SF1)
SLICE2 = {
    "ck1": "select lower(l_returnflag), l_linestatus, sum(l_quantity),"
           " sum(l_extendedprice * (1 - l_discount)), avg(l_discount),"
           " count(*) from lineitem where l_shipdate <= '1998-09-02'"
           " group by lower(l_returnflag), l_linestatus",
    "ck2": "select ascii(l_linestatus), count(*),"
           " sum(l_extendedprice * l_discount) from lineitem"
           " where l_shipdate >= '1994-01-01' and l_shipdate < '1995-01-01'"
           " group by ascii(l_linestatus)",
    "sa": "select l_orderkey, sum(l_quantity), count(*) from lineitem"
          " where l_orderkey <= 100000 group by l_orderkey",
    "tn": "select l_orderkey, l_extendedprice from lineitem"
          " where l_shipdate >= '1995-03-15'"
          " order by l_extendedprice desc, l_orderkey limit 10",
    "q18i": "select l_orderkey, sum(l_quantity) from lineitem"
            " group by l_orderkey having sum(l_quantity) > 300",
}


def _sorted(rows):
    return sorted(_norm(rows), key=lambda r: tuple(map(str, r)))


def _slice2_parity(env, name):
    from tidb_tpu_torch.metrics import REGISTRY

    sql = SLICE2[name]
    js = env["j"]
    js.execute("set tidb_use_tpu = 0")
    try:
        want = js.query(sql)
    finally:
        js.execute("set tidb_use_tpu = 1")
    s0 = REGISTRY.get("fusion_splits_total")
    got = env["t"].query(sql)
    assert REGISTRY.get("fusion_splits_total") == s0
    assert got and _sorted(got) == _sorted(want)
    if name == "tn":
        assert _norm(got) == _norm(want)  # ORDER BY: the order too
    engines = _explain_engines(env["t"], sql)
    assert engines and all("engine:mesh" in e for e in engines), engines


def _cold_cap(pkg_layout, table) -> int:
    """A hot cap between the unpackable columns' bytes (over the tuner's
    fill factor) and the table's wire bytes: the packable columns go
    cold, the rest stays resident."""
    at = pkg_layout.autotuner
    unpackable = sum(at._column_wire_bytes(table, ci)
                     for ci in range(table.n_cols)
                     if pkg_layout.coldtier.pack_info(table, ci) is None)
    cap = int(unpackable / at.LayoutEngine.HOT_FILL) + 1024
    assert cap < at._table_wire_bytes(table)
    return cap


def _lineitem(sess):
    d = sess.domain
    return d.storage.table(d.catalog.info_schema().table(
        "test", "lineitem").id)


@pytest.fixture(scope="module")
def env():
    saved = {k: os.environ.get(k)
             for k in ("TIDB_TPU_HBM_BYTES", "TIDB_TPU_LAYOUT_RETUNE_S")}
    os.environ["TIDB_TPU_LAYOUT_RETUNE_S"] = "0"
    tops.use_device("cpu")
    import tidb_tpu.layout as jlayout
    import tidb_tpu.tpch_data as jdata
    import tidb_tpu_torch.layout as tlayout
    import tidb_tpu_torch.tpch_data as tdata
    from tidb_tpu.copr.parallel import MESH_CACHE as J_MESH
    from tidb_tpu_torch.copr.parallel import MESH_CACHE as T_MESH

    caps = (J_MESH._c.capacity, T_MESH._c.capacity)
    js = jdata.build_lineitem(16_384, regions=4, seed=7)
    ts = tdata.build_lineitem(16_384, regions=4, seed=7)
    js.execute("set tidb_use_tpu = 1")
    ts.execute("set tidb_use_tpu = 1")
    yield {"j": js, "t": ts, "jlayout": jlayout, "tlayout": tlayout}
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    J_MESH._c.capacity, T_MESH._c.capacity = caps
    for lay, mesh in ((jlayout, J_MESH), (tlayout, T_MESH)):
        mesh.clear()
        lay.coldtier.clear()
        lay.LAYOUT.reset()


def test_base_blocks_identical(env):
    """Same seed, same numpy stream: byte-identical base blocks."""
    import numpy as np

    jt, tt = _lineitem(env["j"]), _lineitem(env["t"])
    assert jt.base_rows == tt.base_rows == 16_384
    cols = list(range(jt.n_cols))
    jb = list(jt.iter_base_blocks(cols, 0, jt.base_rows))
    tb = list(tt.iter_base_blocks(cols, 0, tt.base_rows))
    assert len(jb) == len(tb)
    for (jo, ja, jv), (to, ta, tv) in zip(jb, tb):
        assert jo == to
        for x, y in zip(ja, ta):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert [v is None for v in jv] == [v is None for v in tv]


def _explain_engines(sess, sql):
    rows = sess.execute("explain analyze " + sql)[0].rows
    return [r[4] for r in rows if "TableReader" in r[0]]


@pytest.mark.parametrize("name", Q_NAMES)
def test_hot_rows_match_reference(env, name):
    sql = _queries()[name]
    want = _norm(env["j"].query(sql))
    got = _norm(env["t"].query(sql))
    assert len(got) > 0
    assert got == want
    engines = _explain_engines(env["t"], sql)
    assert engines and all("engine:mesh" in e for e in engines), engines


@pytest.mark.parametrize("name", sorted(SLICE2))
def test_slice2_hot_rows_match_reference(env, name):
    _slice2_parity(env, name)


@pytest.mark.parametrize("name", Q_NAMES)
def test_cold_rows_match_reference(env, name, monkeypatch):
    from tidb_tpu_torch.copr.cuda import unpack as tunpack
    from tidb_tpu_torch.metrics import REGISTRY

    jlayout, tlayout = env["jlayout"], env["tlayout"]
    cap = _cold_cap(tlayout, _lineitem(env["t"]))
    assert cap == _cold_cap(jlayout, _lineitem(env["j"]))
    jlayout.set_hot_cap_bytes(cap)
    tlayout.set_hot_cap_bytes(cap)
    plain_calls = []
    real_plain = tunpack.unpack_codes_plain

    def spy(packed, bits, n, bias=None):
        plain_calls.append(bits)
        fused.append(bias is not None)
        return real_plain(packed, bits, n, bias)

    fused = []
    monkeypatch.setattr(tunpack, "unpack_codes_plain", spy)
    sql = _queries()[name]
    m0 = REGISTRY.snapshot()
    want = _norm(env["j"].query(sql))
    got = _norm(env["t"].query(sql))
    got2 = _norm(env["t"].query(sql))  # steady state: cold HITS
    m1 = REGISTRY.snapshot()
    assert got == want and got2 == want
    assert m1.get("layout_cold_hits_total", 0) > m0.get(
        "layout_cold_hits_total", 0)
    assert m1.get("layout_cold_fallbacks_total", 0) == m0.get(
        "layout_cold_fallbacks_total", 0)
    assert plain_calls and set(plain_calls) <= {1, 2, 4}
    assert all(fused)  # every cold column is a range column: fused decode
    if name == "q1":
        assert set(plain_calls) == {1, 2, 4}
    assert tunpack.unpack_codes.launches == 0  # CPU tensors: no kernel
    cold = {r[0] for r in env["t"].query(
        "select column_name from information_schema.tidb_tpu_column_layout"
        " where tier = 'cold'")}
    assert cold >= {"l_discount", "l_returnflag"} if name == "q1" \
        else cold >= {"l_discount"}
    engines = _explain_engines(env["t"], sql)
    assert engines and all("engine:mesh" in e for e in engines), engines


@pytest.mark.parametrize("name", sorted(SLICE2))
def test_slice2_cold_rows_match_reference(env, name, monkeypatch):
    """Cold cap on (set by the cold Q1/Q6 tests above, re-set here):
    computed keys remap the codes K2 unpacked."""
    from tidb_tpu_torch.copr.cuda import remap as tremap

    tlayout = env["tlayout"]
    tlayout.set_hot_cap_bytes(_cold_cap(tlayout, _lineitem(env["t"])))
    seen = []
    real = tremap.remap_codes_plain

    def spy(codes, mapping, n):
        seen.append((codes.dtype, mapping.dtype))
        return real(codes, mapping, n)

    monkeypatch.setattr(tremap, "remap_codes_plain", spy)
    _slice2_parity(env, name)
    if name in ("ck1", "ck2"):
        # the cold decode hands K1 int32 codes: l_returnflag with an
        # int32 map (a STRING key), l_linestatus with an int64 map (an
        # INT key)
        want_map = torch.int32 if name == "ck1" else torch.int64
        assert seen and set(seen) == {(torch.int32, want_map)}


def _arm_unpack(monkeypatch, env, exc):
    """Cold cap on, and the port's unpack raising `exc` at every call."""
    import tidb_tpu_torch.copr.cuda as tcuda

    tlayout = env["tlayout"]
    tlayout.set_hot_cap_bytes(_cold_cap(tlayout, _lineitem(env["t"])))

    def failing(packed, bits, n, bias=None):
        raise exc

    monkeypatch.setattr(tcuda, "unpack_codes", failing)


def _host_task_counts():
    from tidb_tpu_torch.metrics import REGISTRY

    snap = REGISTRY.snapshot()
    return (snap.get("cop_tasks_cpu_total", 0),
            snap.get("cop_tasks_tpu_total", 0))


def test_cold_unpack_failure_raises(env, monkeypatch):
    """A failing unpack kernel fails the statement: no query steps down
    to the per-region rung or the host engine."""
    _arm_unpack(monkeypatch, env, RuntimeError(
        "unpack_codes: CUDA launch failed (error 700)"))
    before = _host_task_counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        env["t"].query(_queries()["q6"])
    assert _host_task_counts() == before


def test_open_breaker_raises(env, monkeypatch):
    """A device failure that names the card trips its breaker; the
    statement and the next one fail typed instead of moving to the
    host engine, until the breaker is reset."""
    from tidb_tpu_torch.copr.device_health import DEVICE_HEALTH, DeviceFailure
    from tidb_tpu_torch.errors import DeviceUnavailableError

    card = tops.device_ids()
    _arm_unpack(monkeypatch, env, DeviceFailure("card fault",
                                                device_ids=card))
    before = _host_task_counts()
    try:
        with pytest.raises(DeviceUnavailableError, match="breaker is open"):
            env["t"].query(_queries()["q6"])
        monkeypatch.undo()
        with pytest.raises(DeviceUnavailableError):
            env["t"].query(_queries()["q6"])
        assert _host_task_counts() == before
    finally:
        DEVICE_HEALTH.reset()
    assert env["t"].query(_queries()["q6"]) == env["j"].query(
        _queries()["q6"])

"""Sort-mode aggregation, computed keys (K1), dictionary predicates and
device TopN: the port against the JAX package.

- K1 (`remap_codes`): the port's wrapper takes its plain version on CPU
  tensors and must equal the Pallas kernel, run in interpret mode (its
  CPU default), exactly, for every code dtype x mapping dtype, caps 2 to
  2**16 and codes outside [0, cap).
- The sort-group emitters and the masked top-k against the JAX
  package's functions on the same seeded numpy inputs.
- SQL: the port's rows (`tidb_use_tpu = 1`) against the JAX package's
  rows after `_norm`, on the recipes of tests/test_parallel.py (the `h`
  table: high NDV, NULL, float and multi keys, first_row) and
  tests/test_fusion.py (the `ft` table's zero-host-tail corpus, the
  overflow peel with TIDB_TPU_AGG_OUT=64).  The JAX package answers
  through its host engine (`tidb_use_tpu = 0`), whose rows equal its
  device rungs' on these queries; the port's scans must report
  `engine:mesh` and the corpus must cause no fusion split.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.copr import fusion as jfusion
from tidb_tpu.copr import pallas as jpallas
from tidb_tpu.expr.aggregation import AggDesc as JAggDesc
from tidb_tpu.expr.expression import ColumnExpr as JCol
from tidb_tpu.ops.topk import masked_top_k as j_top_k
from tidb_tpu.types import ty_float as jty_float, ty_int as jty_int
from tidb_tpu_torch import ops as tops
from tidb_tpu_torch.copr import cuda as tcuda
from tidb_tpu_torch.copr import fusion as tfusion
from tidb_tpu_torch.expr.aggregation import AggDesc as TAggDesc
from tidb_tpu_torch.expr.expression import ColumnExpr as TCol
from tidb_tpu_torch.metrics import REGISTRY
from tidb_tpu_torch.types import ty_float as tty_float, ty_int as tty_int


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    tops.use_device("cpu")


def _norm(rows):
    return [tuple(round(v, 6) if isinstance(v, float) else v for v in r)
            for r in rows]


def _sorted(rows):
    return sorted(_norm(rows), key=lambda r: tuple(
        (0, "") if x is None else (1, str(x)) for x in r))


# ---------------------------------------------------------------------------
# K1: remap_codes against the Pallas kernel
# ---------------------------------------------------------------------------

CODE_DTYPES = (np.uint8, np.int8, np.int16, np.int32, np.int64)


@pytest.mark.parametrize("map_dtype", (np.int32, np.int64))
@pytest.mark.parametrize("code_dtype", CODE_DTYPES)
def test_remap_codes_matches_pallas_kernel(code_dtype, map_dtype):
    rng = np.random.default_rng(11)
    info = np.iinfo(code_dtype)
    n = 2048
    for cap in (2, 4, 64, 1 << 10, 1 << 16):
        lo = max(int(info.min), -7)
        hi = min(int(info.max), cap + 40)
        codes = rng.integers(lo, hi + 1, n).astype(code_dtype)
        # both ends of the clip, whatever the draw gave
        codes[:2] = [lo, hi]
        mapping = rng.integers(-(1 << 31), 1 << 31, cap).astype(map_dtype)
        want = np.asarray(jpallas.remap_codes(jnp.asarray(codes),
                                              jnp.asarray(mapping), n))
        got = tcuda.remap_codes(torch.from_numpy(codes),
                                torch.from_numpy(mapping), n).numpy()
        assert got.dtype == want.dtype == map_dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, mapping[np.clip(codes.astype(np.int64), 0, cap - 1)])
    # CPU tensors take the plain version: no kernel launch is counted
    assert tcuda.remap_codes.launches == 0


def test_remap_codes_rejects_bad_inputs():
    c = torch.zeros(8, dtype=torch.int32)
    m = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tcuda.remap_codes(c, torch.zeros(3, dtype=torch.int32), 8)
    with pytest.raises(TypeError):
        tcuda.remap_codes(c, m.to(torch.int16), 8)
    with pytest.raises(TypeError):
        tcuda.remap_codes(c.to(torch.float32), m, 8)
    with pytest.raises(ValueError):
        tcuda.remap_codes(c, m, 9)
    with pytest.raises(ValueError):
        tcuda.remap_codes(torch.zeros(16, dtype=torch.int32)[::2], m, 8)


# ---------------------------------------------------------------------------
# sort-group emitters and top-k against the JAX package's
# ---------------------------------------------------------------------------

def _key_case(case: str, n: int, rng):
    """(key_bits, key_flags, mask) numpy arrays for one grouping case."""
    mask = rng.random(n) > 0.25
    if case == "int":
        bits = [rng.integers(0, 40, n).astype(np.int64)]
        flags = [np.ones(n, np.int64)]
    elif case == "null":
        v = rng.random(n) > 0.2
        bits = [np.where(v, rng.integers(0, 30, n), 0).astype(np.int64)]
        flags = [v.astype(np.int64)]
    elif case == "float":
        f = np.round(rng.uniform(-2, 2, n), 1)
        f[rng.random(n) < 0.1] = -0.0
        f = np.where(f == 0.0, 0.0, f)  # the engines' -0.0 fold
        bits = [f]
        flags = [np.ones(n, np.int64)]
    else:  # multi: an int key, a NULLable int key and a float key
        v = rng.random(n) > 0.1
        bits = [rng.integers(0, 4, n).astype(np.int64),
                np.where(v, rng.integers(0, 5, n), 0).astype(np.int64),
                np.round(rng.uniform(0, 1, n), 1)]
        flags = [np.ones(n, np.int64), v.astype(np.int64),
                 np.ones(n, np.int64)]
    return bits, flags, mask


def _aggs(pkg_desc, pkg_col, pkg_int, pkg_float):
    ci, cf = pkg_col(0, pkg_int()), pkg_col(1, pkg_float())
    return [pkg_desc("count", []), pkg_desc("count", [cf]),
            pkg_desc("sum", [ci]), pkg_desc("sum", [cf]),
            pkg_desc("avg", [cf]), pkg_desc("min", [ci]),
            pkg_desc("max", [cf]), pkg_desc("first_row", [ci])]


def _flat(states):
    out = []
    for s in states:
        out.extend(s if isinstance(s, tuple) else (s,))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("cap", [256, 8])  # 8: n_uniq > cap, overflow
@pytest.mark.parametrize("case", ["int", "null", "float", "multi"])
def test_sort_group_emitters_match_jax(case, cap):
    rng = np.random.default_rng(17)
    n = 1000
    bits, flags, mask = _key_case(case, n, rng)
    vi = rng.integers(-50, 50, n).astype(np.int64)
    vf = rng.uniform(0, 10, n)
    vf_valid = rng.random(n) > 0.1
    gofs = np.arange(n, dtype=np.int64) + 4096
    j = jfusion.sort_group_segments([jnp.asarray(b) for b in bits],
                                    [jnp.asarray(f) for f in flags],
                                    jnp.asarray(mask), cap)
    t = tfusion.sort_group_segments([torch.from_numpy(b) for b in bits],
                                    [torch.from_numpy(f) for f in flags],
                                    torch.from_numpy(mask), cap)
    jorder, jsm, jskeys, jseg, jpos, jn = j
    torder, tsm, tskeys, tseg, tpos, tn = t
    assert int(tn) == int(jn)
    assert (int(tn) > cap) == (cap == 8)
    for a, b in [(torder, jorder), (tsm, jsm), (tseg, jseg), (tpos, jpos)]:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tskeys, jskeys):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    jcols = {0: (jnp.asarray(vi), jnp.ones(n, bool)),
             1: (jnp.asarray(vf), jnp.asarray(vf_valid))}
    tcols = {0: (torch.from_numpy(vi), torch.ones(n, dtype=torch.bool)),
             1: (torch.from_numpy(vf), torch.from_numpy(vf_valid))}
    js = jfusion.grouped_partial_states(
        _aggs(JAggDesc, JCol, jty_int, jty_float),
        lambda e: jcols[e.index], jorder, jsm, jseg, cap,
        sgofs=jnp.asarray(gofs)[jorder], n_global=1 << 20)
    ts = tfusion.grouped_partial_states(
        _aggs(TAggDesc, TCol, tty_int, tty_float),
        lambda e: tcols[e.index], torder, tsm, tseg, cap,
        sgofs=torder + 4096, n_global=1 << 20)
    for a, b in zip(_flat(ts), _flat(js)):
        assert a.dtype == b.dtype
        if a.dtype == np.float64:
            # f64 sums: both add the sorted rows in order; rounding of
            # the last bit only
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("k", [1, 16, 700])
def test_masked_top_k_matches_jax(k, desc):
    rng = np.random.default_rng(29)
    n = 600
    key = rng.integers(0, 20, n).astype(np.float64)  # many ties
    key[rng.random(n) < 0.05] = -1.7e308             # NULL sentinels
    mask = rng.random(n) > 0.3
    kk = min(k, n)
    jidx, jcnt = j_top_k(jnp.asarray(key), jnp.asarray(mask), kk, desc)
    tidx, tcnt = tops.masked_top_k(torch.from_numpy(key),
                                   torch.from_numpy(mask), kk, desc)
    c = int(jcnt)
    assert int(tcnt) == c
    np.testing.assert_array_equal(tidx.numpy()[:c], np.asarray(jidx)[:c])


# ---------------------------------------------------------------------------
# SQL parity: the `h` recipe (sort-mode keys)
# ---------------------------------------------------------------------------

def _h_arrays():
    """tests/test_parallel.py's `h` table, draw for draw."""
    rng = np.random.default_rng(5)
    n = 30_000
    gv = rng.integers(0, 200_000, n)       # NDV far beyond the dense cap
    gvalid = rng.random(n) > 0.02          # ~2% NULL keys
    fv = np.round(rng.uniform(0, 3, n), 1)
    return ([np.arange(n, dtype=np.int64), fv, gv.astype(np.int64),
             rng.uniform(0, 10, n)], [None, None, gvalid, None])


def _ft_arrays():
    """tests/test_fusion.py's `ft` table, draw for draw."""
    n = 20_000
    rng = np.random.default_rng(23)
    tags = np.array([f"t{i:02d}" for i in range(12)], dtype=object)
    return [np.arange(n, dtype=np.int64),
            rng.integers(0, 5, n, dtype=np.int64),
            rng.uniform(0, 100, n),
            tags[rng.integers(0, 12, n)],
            rng.integers(0, 9000, n, dtype=np.int64)]


def _load(domain_cls, ddl, name, arrays, valids=None, regions=None,
          analyze=False):
    d = domain_cls()
    s = d.new_session()
    s.execute(ddl)
    t = d.catalog.info_schema().table("test", name)
    store = d.storage.table(t.id)
    store.bulk_load_arrays(arrays, valids, ts=d.storage.current_ts())
    if regions:
        d.storage.regions.split_even(t.id, regions, store.base_rows)
    if analyze:
        s.execute(f"analyze table {name}")
    return s


def _pair(ddl, name, arrays, valids=None, regions=None, analyze=False):
    from tidb_tpu.session import Domain as JDomain
    from tidb_tpu_torch.session import Domain as TDomain

    js = _load(JDomain, ddl, name, arrays, valids, regions, analyze)
    ts = _load(TDomain, ddl, name, arrays, valids, regions, analyze)
    js.execute("set tidb_use_tpu = 0")
    ts.execute("set tidb_use_tpu = 1")
    return js, ts


@pytest.fixture(scope="module")
def h_pair():
    arrays, valids = _h_arrays()
    return _pair("create table h (k bigint, f double, g bigint, x double)",
                 "h", arrays, valids, regions=5)


@pytest.fixture(scope="module")
def ft_pair():
    return _pair("create table ft (k bigint primary key, g bigint, "
                 "x double, c varchar(8), j bigint)", "ft", _ft_arrays(),
                 analyze=True)


def _engines(sess, sql):
    rows = sess.execute("explain analyze " + sql)[0].rows
    return [r[4] for r in rows if "TableReader" in r[0]]


def _mesh_parity(pair, sql):
    """Port rows == JAX rows after _norm, the port's scan on the mesh,
    and no fusion split; returns the port's rows."""
    js, ts = pair
    s0 = REGISTRY.get("fusion_splits_total")
    got = ts.query(sql)
    assert REGISTRY.get("fusion_splits_total") == s0, sql
    assert _sorted(got) == _sorted(js.query(sql)), sql
    eng = _engines(ts, sql)
    assert eng and all("engine:mesh" in e for e in eng), (sql, eng)
    return got


H_QUERIES = {
    "high_ndv": "select g, count(*), sum(x), min(x), max(x), avg(x) from h "
                "group by g order by g limit 50",
    "null_key": "select g, count(*) from h where g is null or g < 300 "
                "group by g",
    "float_key": "select f, count(*), sum(x) from h group by f order by f",
    "multi_key": "select f, g, count(*) from h where g < 1000 "
                 "group by f, g order by f, g",
    "first_row": "select g, min(k) from h where g < 5000 group by g "
                 "order by g",
}


@pytest.mark.parametrize("name", sorted(H_QUERIES))
def test_h_sort_agg_rows_match_reference(h_pair, name):
    rows = _mesh_parity(h_pair, H_QUERIES[name])
    assert rows
    if name == "null_key":
        assert any(r[0] is None for r in rows)
    if name == "float_key":
        assert len(rows) == 31


# ---------------------------------------------------------------------------
# SQL parity: the `ft` zero-host-tail corpus and dictionary predicates
# ---------------------------------------------------------------------------

HOST_TAIL_CORPUS = (
    "select substr(c, 2, 2), count(*), sum(x) from ft"
    " group by substr(c, 2, 2)",
    "select concat(c, '#'), min(x), max(k) from ft where x < 70"
    " group by concat(c, '#')",
    "select upper(c), count(*) from ft group by upper(c)",
    "select k, g, x from ft order by g desc, c, k limit 7",
    "select k from ft where x < 50 order by c, k limit 9",
)

DICT_PREDICATES = (
    "select count(*), sum(x) from ft where c like 't0%'",
    "select k, x from ft where substr(c, 2, 2) = '07' and x < 3",
    "select g, count(*) from ft where c like '%1' group by g",
)


FT_IDS = ([f"tail{i}" for i in range(len(HOST_TAIL_CORPUS))]
          + [f"pred{i}" for i in range(len(DICT_PREDICATES))])


@pytest.mark.parametrize("sql", HOST_TAIL_CORPUS + DICT_PREDICATES,
                         ids=FT_IDS)
def test_ft_corpus_rows_match_reference(ft_pair, sql):
    assert _mesh_parity(ft_pair, sql)


def test_single_key_topn_matches_reference(ft_pair):
    assert len(_mesh_parity(
        ft_pair, "select k, x from ft order by x desc limit 7")) == 7


def test_computed_key_rides_k1(ft_pair, monkeypatch):
    """A computed key regathers its codes through K1's wrapper, with an
    int32 mapping for a STRING key and int64 for an INT-valued one."""
    from tidb_tpu_torch.copr.cuda import remap as tremap

    seen = []
    real = tremap.remap_codes_plain

    def spy(codes, mapping, n):
        seen.append((codes.dtype, mapping.dtype, mapping.shape[0]))
        return real(codes, mapping, n)

    monkeypatch.setattr(tremap, "remap_codes_plain", spy)
    _mesh_parity(ft_pair, HOST_TAIL_CORPUS[2])
    _mesh_parity(ft_pair, "select length(c), ascii(c), count(*) from ft "
                          "group by length(c), ascii(c)")
    assert (torch.int8, torch.int32, 16) in seen
    assert (torch.int8, torch.int64, 16) in seen


def test_failing_k1_launch_raises(ft_pair, monkeypatch):
    """A failed K1 launch fails the statement: no query steps down to
    the per-region rung or the host engine."""
    import tidb_tpu_torch.copr.cuda as tcuda_mod

    def failing(codes, mapping, n):
        raise RuntimeError("remap_codes: CUDA launch failed (error 700)")

    monkeypatch.setattr(tcuda_mod, "remap_codes", failing)
    snap = REGISTRY.snapshot()
    before = (snap.get("cop_tasks_cpu_total", 0),
              snap.get("cop_tasks_tpu_total", 0))
    with pytest.raises(RuntimeError, match="launch failed"):
        ft_pair[1].query(HOST_TAIL_CORPUS[0])
    snap = REGISTRY.snapshot()
    assert (snap.get("cop_tasks_cpu_total", 0),
            snap.get("cop_tasks_tpu_total", 0)) == before


# ---------------------------------------------------------------------------
# the overflow peel: TIDB_TPU_AGG_OUT=64
# ---------------------------------------------------------------------------

def test_agg_overflow_peels_agg_to_host_tail(monkeypatch):
    """tests/test_fusion.py's peel recipe: a blown sort-agg budget
    re-runs the fragment with the AGG peeled to a host tail (scan +
    selection stay on the card) — the JAX package's rows, the peel
    counter, one labelled split, and the scan still on the mesh."""
    monkeypatch.setenv("TIDB_TPU_AGG_OUT", "64")
    rng = np.random.default_rng(5)
    n = 40000
    kvalid = [np.ones(n, np.bool_), None, None]
    kvalid[0][rng.integers(0, n, 500)] = False  # NULLable -> sort agg
    arrays = [rng.integers(0, 20000, n), rng.uniform(0, 10, n),
              rng.integers(0, 100, n)]
    js, ts = _pair("create table peelt (k bigint, v double, w bigint)",
                   "peelt", arrays, kvalid, analyze=True)
    q = "select k, count(*), sum(v) from peelt where w < 80 group by k"
    m0 = REGISTRY.get("mesh_agg_peel_total")
    r0 = REGISTRY.get("fusion_splits_reason_agg_overflow_total")
    got = ts.query(q)
    assert REGISTRY.get("mesh_agg_peel_total") == m0 + 1
    assert REGISTRY.get("fusion_splits_reason_agg_overflow_total") == r0 + 1
    assert _sorted(got) == _sorted(js.query(q))
    eng = _engines(ts, q)
    assert eng and all("engine:mesh" in e for e in eng), eng

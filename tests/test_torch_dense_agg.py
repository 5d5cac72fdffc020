"""K3, the dense aggregation's integer partial states in one pass
(`copr/cuda.dense_agg`), on the CPU, and the dispatch that picks it.

- The plain version (what the wrapper takes on a CPU tensor), which is
  the composition of ops/segment.py's masked sums and counts that
  `fusion.dense_agg_results` ran before K3, equals a numpy reference
  exactly: random codes, masks and validities, G in {1, 2, 6, 32}, K in
  {1, 7, 16} with count-only operands, values near +-2**63 whose sums
  wrap, n = 0 and n not a multiple of 16; a masked row's code past the
  groups counts nowhere, a masked-out row's code is not read, and one
  group reads no code.
- The wrapper checks its inputs on every device.
- Dispatch: on the card, unbatched aggregations of at most UNROLL_G
  groups take K3; the CPU, the micro-batcher's batched masks and G = 33
  keep the composed path.  The SQL tests below let the predicate pass
  a CPU mask as the card's (`k3_on_cpu`), so that the fused program's
  K3 branch runs here over the plain version: Q1 and Q6 move
  `copr_dense_agg_kernel_total`, batches and G = 33
  `copr_dense_agg_plain_total`, and float sums, min, max and first_row
  values stay on the composed reductions.  SQL rows equal the JAX
  package's host engine.
"""

import numpy as np
import pytest
import torch

from tidb_tpu_torch import ops as tops
from tidb_tpu_torch.copr import fusion as tfusion
from tidb_tpu_torch.copr.cuda import dense_agg, dense_agg_plain
from tidb_tpu_torch.copr.cuda.dense_agg import MAX_G, MAX_K
from tidb_tpu_torch.lint.kernelcheck import dense_agg_numpy
from tidb_tpu_torch.metrics import REGISTRY
from tidb_tpu_torch.ops.segment import UNROLL_G


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    tops.use_device("cpu")


def _inputs(n: int, K: int, G: int, seed: int, codes_hi=None):
    """Numpy inputs: codes in [0, codes_hi), values over the whole int64
    range (their sums wrap), every third operand count-only."""
    rng = np.random.default_rng(seed)
    gidx = rng.integers(0, G if codes_hi is None else codes_hi, n)
    mask = rng.random(n) < 0.8
    values = [None if k % 3 == 2 else
              rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
              for k in range(K)]
    valids = [rng.random(n) < 0.7 for _ in range(K)]
    return gidx, mask, values, valids


def _torch(gidx, mask, values, valids):
    t = torch.from_numpy
    return (t(gidx), t(mask), [None if v is None else t(v) for v in values],
            [t(ok) for ok in valids])


@pytest.mark.parametrize("n", [0, 1037])
@pytest.mark.parametrize("K", [1, 7, 16])
@pytest.mark.parametrize("G", [1, 2, 6, 32])
def test_plain_equals_composition_and_numpy(G, K, n):
    gidx, mask, values, valids = _inputs(n, K, G, seed=G * 100 + K)
    args = _torch(gidx, mask, values, valids)
    got = dense_agg_plain(*args, G)
    assert got.dtype == torch.int64 and got.shape == (1 + 2 * K, G)
    assert np.array_equal(got.numpy(), dense_agg_numpy(
        gidx, mask, values, valids, G))
    assert torch.equal(dense_agg(*args, G), got)


@pytest.mark.parametrize("G", [1, 6, 32])
def test_codes_outside_the_groups_count_nowhere(G):
    """Masked rows' codes past the groups and masked-out rows' negative
    codes count nowhere; with one group every masked row counts."""
    gidx, mask, values, valids = _inputs(777, 4, G, seed=5, codes_hi=G + 3)
    gidx[~mask] = -1 - gidx[~mask]
    args = _torch(gidx, mask, values, valids)
    assert np.array_equal(dense_agg(*args, G).numpy(),
                          dense_agg_numpy(gidx, mask, values, valids, G))


def _bad_inputs():
    gidx, mask, values, valids = _torch(*_inputs(64, 2, 6, seed=3))
    strided = torch.stack([valids[1], valids[1]], 1)[:, 0]
    return {
        "strided-validity": ((gidx, mask, values, [valids[0], strided], 6),
                             ValueError, "contiguous"),
        "strided-codes": ((gidx[::2], mask[::2], [v[::2] for v in values],
                           [ok[::2] for ok in valids], 6),
                          ValueError, "contiguous"),
        "int32-codes": ((gidx.int(), mask, values, valids, 6),
                        TypeError, "int64"),
        "uint8-mask": ((gidx, mask.to(torch.uint8), values, valids, 6),
                       TypeError, "bool"),
        "float-values": ((gidx, mask, [values[0].double(), values[1]],
                          valids, 6), TypeError, "int64"),
        "short-validity": ((gidx, mask, values, [valids[0],
                                                 valids[1][:-1]], 6),
                           ValueError, r"\[64\]"),
        "too-many-groups": ((gidx, mask, values, valids, MAX_G + 1),
                            ValueError, "num_groups"),
        "too-many-operands": ((gidx, mask, [values[0]] * (MAX_K + 1),
                               [valids[0]] * (MAX_K + 1), 6),
                              ValueError, "operands"),
        "batched-mask": ((gidx, mask.expand(2, 64), values, valids, 6),
                         ValueError, "one-dimensional"),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    args, exc, match = _bad_inputs()[case]
    with pytest.raises(exc, match=match):
        dense_agg(*args)


class _OnCard:
    """A mask as the dispatch predicate sees it on the card."""

    is_cuda = True

    def __init__(self, mask):
        self.mask = mask

    def dim(self):
        return self.mask.dim()


@pytest.mark.parametrize("dim,G,want", [
    (1, 1, True), (1, 6, True), (1, UNROLL_G, True),
    (2, 6, False), (1, UNROLL_G + 1, False)])
def test_dispatch_predicate(dim, G, want):
    mask = torch.ones((3, 8) if dim == 2 else (8,), dtype=torch.bool)
    assert tfusion.dense_agg_kernel_path(_OnCard(mask), G) is want
    assert tfusion.dense_agg_kernel_path(mask, G) is False  # the CPU
    assert MAX_G == UNROLL_G


@pytest.mark.parametrize("K", [0, 3, MAX_K + 7])
def test_int_states_over_k3_equal_the_composed_reductions(K):
    """The fused program's two sources of integer states agree, K3's
    in one launch per MAX_K operands: sums with values, count-only
    operands, and operands whose masked rows the caller made."""
    gidx, mask, values, valids = _torch(*_inputs(1037, K, 6, seed=K))
    operands = [(v, ok, mask & ok if k % 4 == 3 else None)
                for k, (v, ok) in enumerate(zip(values, valids))]
    g0, s0, c0 = tfusion._int_states(gidx, mask, operands, 6, kernel=False)
    g1, s1, c1 = tfusion._int_states(gidx, mask, operands, 6, kernel=True)
    assert torch.equal(g0, g1) and len(c1) == len(s1) == K
    for (v, _ok, _mv), a, b, x, y in zip(operands, s0, s1, c0, c1):
        assert torch.equal(x, y)
        assert v is None or torch.equal(a, b)


# ---------------------------------------------------------------------------
# SQL: which path each aggregation takes, and its rows
# ---------------------------------------------------------------------------


def _counters():
    return (REGISTRY.get("copr_dense_agg_kernel_total"),
            REGISTRY.get("copr_dense_agg_plain_total"))


@pytest.fixture
def k3_on_cpu(monkeypatch):
    """The dispatch predicate with a CPU mask taken as the card's."""
    real = tfusion.dense_agg_kernel_path
    monkeypatch.setattr(tfusion, "dense_agg_kernel_path",
                        lambda mask, G: real(_OnCard(mask), G))


def _load(domain_cls, arrays, valids):
    d = domain_cls()
    s = d.new_session()
    s.execute("create table da (k bigint, g32 bigint not null, "
              "g33 bigint not null, q decimal(15, 2), n bigint, f double)")
    t = d.catalog.info_schema().table("test", "da")
    store = d.storage.table(t.id)
    store.bulk_load_arrays(arrays, valids, ts=d.storage.current_ts())
    d.storage.regions.split_even(t.id, 3, store.base_rows)
    return s


@pytest.fixture(scope="module")
def da_pair():
    from tidb_tpu.session import Domain as JDomain
    from tidb_tpu_torch.session import Domain as TDomain

    n = 5000
    rng = np.random.default_rng(41)
    arrays = [np.arange(n, dtype=np.int64),
              np.arange(n, dtype=np.int64) % 32,
              np.arange(n, dtype=np.int64) % 33,
              rng.integers(-10**6, 10**6, n, dtype=np.int64),
              rng.integers(-(1 << 40), 1 << 40, n, dtype=np.int64),
              rng.uniform(-50, 50, n)]
    valids = [None, None, None, rng.random(n) < 0.9, rng.random(n) < 0.8,
              rng.random(n) < 0.95]
    js, ts = _load(JDomain, arrays, valids), _load(TDomain, arrays, valids)
    js.execute("set tidb_use_tpu = 0")
    ts.execute("set tidb_use_tpu = 1")
    return js, ts


def _sorted(rows):
    return sorted(tuple(round(v, 6) if isinstance(v, float) else v
                        for v in r) for r in rows)


#: name -> (query, takes K3)
DA_QUERIES = {
    "int-states-g32": ("select g32, count(*), count(n), sum(q), avg(q), "
                       "sum(n), avg(n) from da group by g32", True),
    "scalar": ("select count(*), sum(q), count(f) from da where k > 7",
               True),
    "float-minmax-g32": ("select g32, sum(f), avg(f), min(q), max(n) "
                         "from da group by g32", True),
    "first-row-g32": ("select g32, k from da group by g32", True),
    "int-states-g33": ("select g33, count(*), sum(q), avg(n) from da "
                       "group by g33", False),
}


@pytest.mark.parametrize("name", sorted(DA_QUERIES))
def test_sql_rows_and_path(da_pair, k3_on_cpu, name):
    js, ts = da_pair
    sql, kernel = DA_QUERIES[name]
    k0, p0 = _counters()
    got = ts.query(sql)
    k1, p1 = _counters()
    assert got and _sorted(got) == _sorted(js.query(sql))
    if kernel:
        assert k1 > k0 and p1 == p0
    else:
        assert p1 > p0 and k1 == k0


def test_float_min_max_first_row_keep_the_composed_reductions(
        da_pair, k3_on_cpu, monkeypatch):
    """On the K3 path a float sum's value, min, max and first_row still
    come from ops/segment.py, called by the fused program itself;
    integer sums and every count come from the K3 wrapper (whose plain
    version, on the CPU, composes the same reductions)."""
    import sys

    import tidb_tpu_torch.copr.cuda as kcuda

    _js, ts = da_pair
    calls, k3 = [], []
    for fn in ("masked_segment_sum", "masked_segment_min",
               "masked_segment_max", "masked_segment_count",
               "masked_segment_argfirst", "segment_min"):
        real = getattr(tops, fn)

        def spy(*a, _fn=fn, _real=real, **kw):
            if sys._getframe(1).f_globals["__name__"] == tfusion.__name__:
                calls.append((_fn, a[0].dtype))
            return _real(*a, **kw)

        monkeypatch.setattr(tops, fn, spy)
    real_k3 = kcuda.dense_agg

    def k3_spy(*a, **kw):
        k3.append(len(a[2]))
        return real_k3(*a, **kw)

    monkeypatch.setattr(kcuda, "dense_agg", k3_spy)
    ts.query(DA_QUERIES["int-states-g32"][0])
    assert calls == [] and k3 and all(k == 5 for k in k3)
    ts.query(DA_QUERIES["float-minmax-g32"][0])
    names = {c[0] for c in calls}
    assert ("masked_segment_sum", torch.float64) in calls
    assert {"masked_segment_min", "masked_segment_max"} <= names
    assert "masked_segment_count" not in names
    calls.clear()
    ts.query(DA_QUERIES["first-row-g32"][0])
    names = {c[0] for c in calls}
    assert names & {"segment_min", "masked_segment_argfirst"}
    assert not names & {"masked_segment_sum", "masked_segment_count"}


def test_cpu_keeps_the_composed_path(da_pair):
    _js, ts = da_pair
    k0, p0 = _counters()
    ts.query(DA_QUERIES["int-states-g32"][0])
    k1, p1 = _counters()
    assert p1 > p0 and k1 == k0


def test_q1_and_q6_take_k3_and_batches_keep_the_composed_path(k3_on_cpu):
    from tidb_tpu_torch.lint.kernelcheck import (CANONICAL_KERNEL_QUERIES,
                                                 _reader_dags,
                                                 trace_batch_kernel)
    from tidb_tpu_torch.lint.plancheck import _canonical_session
    from tidb_tpu_torch.parser import parse_one
    from tidb_tpu_torch.tpch_data import (LINEITEM_Q1, LINEITEM_Q6,
                                          build_lineitem)

    s = build_lineitem(8192, regions=2)
    s.execute("set tidb_use_tpu = 0")
    want = [s.query(LINEITEM_Q1), s.query(LINEITEM_Q6)]
    s.execute("set tidb_use_tpu = 1")
    k0, p0 = _counters()
    assert [s.query(LINEITEM_Q1), s.query(LINEITEM_Q6)] == want
    k1, p1 = _counters()
    assert k1 >= k0 + 2 and p1 == p0

    cs = _canonical_session()
    dom = cs.domain
    table = dom.storage.table(
        dom.catalog.info_schema().table("test", "lineitem").id)
    sql = dict(CANONICAL_KERNEL_QUERIES)["q6-scalar-agg"]
    dag = _reader_dags(cs._plan(parse_one(sql)))[0][1]
    trace_batch_kernel(table, dag)
    k2, p2 = _counters()
    assert p2 == p1 + 1 and k2 == k1

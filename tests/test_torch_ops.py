"""The torch port's device primitives against the JAX package's.

`ops.segment` and `copr.torch_eval.compile_expr` take the same numpy
inputs (made from a seed) as `tidb_tpu.ops` and
`tidb_tpu.copr.jax_eval`, on the CPU, and must give exactly the same
arrays: data and validity, ints and decimals bit for bit.  Float inputs
are multiples of 1/4, so every sum is exact in any order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tidb_tpu.copr.jax_eval as jx
import tidb_tpu.ops as jops
import tidb_tpu_torch.copr.torch_eval as tx
import tidb_tpu_torch.ops as tops
from tidb_tpu_torch import types as ttypes

N = 4096


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    tops.use_device("cpu")


def _segment_inputs(G: int, dtype):
    rng = np.random.default_rng(11 + G)
    gidx = rng.integers(0, G, N, dtype=np.int64)
    mask = rng.random(N) < 0.6
    if np.dtype(dtype).kind == "f":
        data = rng.integers(-4000, 4000, N).astype(np.float64) / 4.0
    else:
        data = rng.integers(-(1 << 40), 1 << 40, N, dtype=np.int64)
    return data, gidx, mask


@pytest.mark.parametrize("G", [1, 6, 40])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
@pytest.mark.parametrize("fn", ["masked_segment_sum", "masked_segment_min",
                                "masked_segment_max"])
def test_masked_segment_reductions(fn, dtype, G):
    data, gidx, mask = _segment_inputs(G, dtype)
    want = np.asarray(getattr(jops, fn)(
        jnp.asarray(data), jnp.asarray(gidx), jnp.asarray(mask), G))
    got = getattr(tops, fn)(torch.from_numpy(data), torch.from_numpy(gidx),
                            torch.from_numpy(mask), G).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("G", [1, 6, 40])
def test_masked_segment_count_argfirst_min(G):
    data, gidx, mask = _segment_inputs(G, np.int64)
    # every group holds a masked row, so "empty group" sentinels (which
    # differ by design above UNROLL_G in the JAX package) never arise
    assert len(np.unique(gidx[mask])) == G
    jg, jm, tg, tm = (jnp.asarray(gidx), jnp.asarray(mask),
                      torch.from_numpy(gidx), torch.from_numpy(mask))
    np.testing.assert_array_equal(
        tops.masked_segment_count(tg, tm, G).numpy(),
        np.asarray(jops.masked_segment_count(jg, jm, G)))
    np.testing.assert_array_equal(
        tops.masked_segment_argfirst(tg, tm, G).numpy(),
        np.asarray(jops.masked_segment_argfirst(jg, jm, G)))
    np.testing.assert_array_equal(
        tops.segment_min(torch.from_numpy(data), tg, G).numpy(),
        np.asarray(jops.segment_min(jnp.asarray(data), jg, G)))


# ---------------------------------------------------------------------------
# compile_expr
# ---------------------------------------------------------------------------

def _columns():
    """Scan columns (index -> (ftype factory, data, valid)) from a seed:
    decimals with negatives, int64 values near +-2^62, dates, floats in
    quarters, and NULLs in every column."""
    rng = np.random.default_rng(5)
    big = 1 << 62
    ints = rng.integers(-1000, 1000, N, dtype=np.int64)
    ints[:8] = [big, -big, big - 1, -big + 1, 0, 1, -1, 7]
    small = rng.integers(-9, 10, N, dtype=np.int64)
    small[::13] = 0  # division / modulo by zero -> NULL
    dec2 = rng.integers(-10**7, 10**7, N, dtype=np.int64)  # decimal(15,2)
    dec4 = rng.integers(-10**9, 10**9, N, dtype=np.int64)  # decimal(15,4)
    # exact halves at scale 4 -> 2 exercise round-half-away-from-zero
    dec4[:6] = [50, -50, 150, -150, 49, -51]
    dates = (8000 + rng.integers(0, 3000, N)).astype(np.int32)
    flts = rng.integers(-400, 400, N).astype(np.float64) / 4.0
    cols = {
        0: ("int", ints), 1: ("int", small), 2: ("dec2", dec2),
        3: ("dec4", dec4), 4: ("date", dates), 5: ("float", flts),
    }
    valids = {i: rng.random(N) >= 0.1 for i in cols}
    return cols, valids


def _ft(t, kind):
    return {
        "int": t.ty_int(), "dec2": t.ty_decimal(15, 2),
        "dec4": t.ty_decimal(15, 4), "dec6": t.ty_decimal(18, 6),
        "date": t.ty_date(), "float": t.ty_float(), "bool": t.ty_bool(),
    }[kind]


def _exprs(pkg):
    """The expression corpus, built from one package's own classes."""
    import importlib

    ex = importlib.import_module(pkg + ".expr.expression")
    t = importlib.import_module(pkg + ".types")
    cols, _ = _columns()

    def c(i):
        return ex.ColumnExpr(i, _ft(t, cols[i][0]), f"c{i}")

    def k(v, kind):
        return ex.Constant(v, _ft(t, kind))

    def f(name, args, kind, **meta):
        return ex.ScalarFunc(name, args, _ft(t, kind), meta)

    return [
        # int64 arithmetic at the edges, and MySQL div/% signs
        f("+", [c(0), c(1)], "int"), f("-", [c(0), c(1)], "int"),
        f("*", [c(1), c(1)], "int"),
        f("div", [c(0), c(1)], "int"), f("%", [c(0), c(1)], "int"),
        f("unaryminus", [c(1)], "int"),
        f("&", [c(0), c(1)], "int"), f(">>", [c(0), c(1)], "int"),
        # decimal rescales, products and narrowing casts (half away from 0)
        f("+", [c(2), c(3)], "dec4"), f("-", [c(3), c(2)], "dec4"),
        f("*", [c(2), c(2)], "dec4"), f("*", [c(2), c(3)], "dec2"),
        f("cast", [c(3)], "dec2"), f("cast", [c(3)], "int"),
        f("cast", [c(2)], "dec6"), f("round", [c(3), k(1, "int")], "dec2"),
        f("floor", [c(3)], "int"), f("ceil", [c(3)], "int"),
        f("*", [c(2), f("-", [k(1, "int"), c(2)], "dec2")], "dec4"),
        # comparisons across types, with date constants
        f("<=", [c(4), k("1998-09-02", "date")], "bool"),
        f(">=", [c(4), k("1994-01-01", "date")], "bool"),
        f("<", [c(2), c(3)], "bool"), f("=", [c(0), c(1)], "bool"),
        f("!=", [c(5), c(2)], "bool"),
        # three-valued logic, NULL tests, IN, CASE
        f("and", [f("<", [c(1), k(0, "int")], "bool"),
                  f(">", [c(5), k(0.0, "float")], "bool")], "bool"),
        f("or", [f("<", [c(1), k(0, "int")], "bool"),
                 f("isnull", [c(5)], "bool")], "bool"),
        f("not", [f("=", [c(1), k(3, "int")], "bool")], "bool"),
        f("in", [c(1), k(1, "int"), k(None, "int"), k(-4, "int")], "bool"),
        f("if", [f(">", [c(1), k(0, "int")], "bool"), c(2), c(3)], "dec4"),
        f("coalesce", [c(2), c(3), k(0, "dec4")], "dec4"),
        f("case", [f("<", [c(1), k(-3, "int")], "bool"), c(0),
                   f(">", [c(1), k(3, "int")], "bool"), c(1), k(9, "int")],
          "int"),
        # floats: exact ops only (quarters), and division by zero -> NULL
        f("+", [c(5), c(2)], "float"), f("/", [c(5), c(1)], "float"),
        f("*", [c(5), c(5)], "float"),
        # date parts
        f("year", [c(4)], "int"), f("month", [c(4)], "int"),
        f("day", [c(4)], "int"), f("quarter", [c(4)], "int"),
        f("dayofweek", [c(4)], "int"),
        f("datediff", [c(4), k("1995-06-17", "date")], "int"),
        f("date_add", [c(4), c(1)], "date", unit="day"),
    ]


@pytest.fixture(scope="module")
def corpus():
    cols, valids = _columns()
    jcols = {i: (jnp.asarray(d), jnp.asarray(valids[i]))
             for i, (_k, d) in cols.items()}
    tcols = {i: (torch.from_numpy(d.copy()), torch.from_numpy(valids[i]))
             for i, (_k, d) in cols.items()}
    return _exprs("tidb_tpu"), _exprs("tidb_tpu_torch"), jcols, tcols


@pytest.mark.parametrize("i", range(len(_exprs("tidb_tpu"))))
def test_compile_expr_matches_reference(corpus, i):
    jes, tes, jcols, tcols = corpus
    jd, jv = jx.compile_expr(jes[i], jcols, N)
    td, tv = tx.compile_expr(tes[i], tcols, N)
    jd, jv = np.asarray(jd), np.asarray(jv)
    td, tv = td.numpy(), tv.numpy()
    assert td.dtype == jd.dtype, (str(jes[i]), td.dtype, jd.dtype)
    np.testing.assert_array_equal(tv, jv, err_msg=str(jes[i]))
    # where a row is NULL its data slot is unspecified in both engines
    np.testing.assert_array_equal(td[tv], jd[jv], err_msg=str(jes[i]))


def test_decimal_rounding_is_half_away_from_zero():
    t = ttypes
    d = torch.tensor([50, -50, 150, -150, 49, -51, 0], dtype=torch.int64)
    e = tx.compile_expr(
        _cast(t, "tidb_tpu_torch"), {0: (d, torch.ones(7, dtype=torch.bool))},
        7)[0]
    assert e.tolist() == [1, -1, 2, -2, 0, -1, 0]


def _cast(t, pkg):
    import importlib

    ex = importlib.import_module(pkg + ".expr.expression")
    return ex.ScalarFunc(
        "cast", [ex.ColumnExpr(0, t.ty_decimal(15, 4), "d")],
        t.ty_decimal(15, 2), {})


def test_unsupported_raises_device_unsupported():
    import tidb_tpu_torch.expr.expression as ex

    e = ex.ScalarFunc("no_such_fn", [], ttypes.ty_int(), {})
    with pytest.raises(tx.DeviceUnsupported):
        tx.compile_expr(e, {}, 4, dev=torch.device("cpu"))


# ---------------------------------------------------------------------------
# float sums in one fixed order (no atomics)
# ---------------------------------------------------------------------------


def _no_index_add(monkeypatch):
    """Make any index_add_ fail: float sums must not scatter-add."""
    def boom(*_a, **_k):
        raise AssertionError("index_add_ reached by a float sum")

    monkeypatch.setattr(torch.Tensor, "index_add_", boom)


def _fsum_inputs(G: int, n: int = 20_000):
    rng = np.random.default_rng(23)
    data = rng.uniform(-1e6, 1e6, n) * 10.0 ** rng.integers(-6, 6, n)
    gidx = rng.integers(0, G, n, dtype=np.int64)
    mask = rng.random(n) < 0.7
    return data, gidx, mask


@pytest.mark.parametrize("G", [33, 100, 4097])
def test_float_segment_sum_above_unroll_is_fixed_order(monkeypatch, G):
    """Above UNROLL_G a float masked_segment_sum takes the stable sort and
    the direct per-span sum: no index_add_, the same bits on every call,
    and each group within 1e-12 relative of math.fsum of its rows."""
    import math

    from tidb_tpu_torch.ops.segment import UNROLL_G

    assert G > UNROLL_G
    data, gidx, mask = _fsum_inputs(G)
    _no_index_add(monkeypatch)
    t = [torch.from_numpy(x) for x in (data, gidx, mask)]
    runs = [tops.masked_segment_sum(*t, G).numpy() for _ in range(3)]
    for r in runs[1:]:
        assert r.tobytes() == runs[0].tobytes()
    for g in range(G):
        want = math.fsum(data[mask & (gidx == g)])
        assert runs[0][g] == pytest.approx(want, rel=1e-12, abs=1e-300), g


def test_batched_float_segment_sum_equals_each_member(monkeypatch):
    """A batch of masks [B, n] over G > UNROLL_G groups (B x G segments
    in one call) gives each member's solo sums bit for bit, with no
    index_add_."""
    G, B = 40, 4
    data, gidx, _ = _fsum_inputs(G)
    rng = np.random.default_rng(5)
    masks = rng.random((B, len(data))) < 0.5
    _no_index_add(monkeypatch)
    d, g = torch.from_numpy(data), torch.from_numpy(gidx)
    got = tops.masked_segment_sum(d, g, torch.from_numpy(masks), G)
    assert tuple(got.shape) == (B, G)
    for b in range(B):
        one = tops.masked_segment_sum(d, g, torch.from_numpy(masks[b]), G)
        assert got[b].numpy().tobytes() == one.numpy().tobytes()


def test_span_order_sorts_the_codes_once(monkeypatch):
    """Float sums sharing one `SpanOrder` sort the group codes once, solo
    and for a batch of masks, and give the same bits as sums that sort
    for themselves."""
    G, B = 40, 3
    data, gidx, mask = _fsum_inputs(G)
    rng = np.random.default_rng(9)
    masks = torch.from_numpy(rng.random((B, len(data))) < 0.5)
    d, g, m = (torch.from_numpy(x) for x in (data, gidx, mask))
    want = [tops.masked_segment_sum(d, g, m, G),
            tops.masked_segment_sum(d * 3.0, g, m, G),
            tops.masked_segment_sum(d, g, masks, G)]
    sorts = []
    real = torch.argsort

    def counting(*a, **k):
        sorts.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch, "argsort", counting)
    spans = tops.SpanOrder(g, G)
    got = [tops.masked_segment_sum(d, g, m, G, spans),
           tops.masked_segment_sum(d * 3.0, g, m, G, spans),
           tops.masked_segment_sum(d, g, masks, G, spans)]
    assert len(sorts) == 1
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_sort_mode_float_partials_are_fixed_order(monkeypatch):
    """grouped_partial_states and merge_grouped_partials sum floats per
    sorted span directly: no index_add_, equal to math.fsum per group."""
    import math

    from tidb_tpu_torch.copr import fusion
    from tidb_tpu_torch.expr.aggregation import AggDesc
    from tidb_tpu_torch.expr.expression import ColumnExpr
    from tidb_tpu_torch.types import FieldType, TypeKind

    G, cap = 50, 64
    data, keys, mask = _fsum_inputs(G)
    ft = FieldType(TypeKind.FLOAT)
    aggs = [AggDesc("sum", [ColumnExpr(0, ft)], False, ft)]
    _no_index_add(monkeypatch)
    kt, mt, dt = (torch.from_numpy(keys), torch.from_numpy(mask),
                  torch.from_numpy(data))
    flags = [torch.zeros_like(kt)]
    order, sm, _sk, seg, _pos, n_uniq = fusion.sort_group_segments(
        [kt], flags, mt, cap)
    assert int(n_uniq) == G
    (total, cnt), = fusion.grouped_partial_states(
        aggs, lambda e: (dt, torch.ones_like(mt)), order, sm, seg, cap)
    for slot in range(G):
        k = int(kt[order][torch.nonzero(seg == slot)[0, 0]])
        want = math.fsum(data[mask & (keys == k)])
        assert float(total[slot]) == pytest.approx(want, rel=1e-12), slot
    # merging two copies of the partials doubles every sum exactly
    rows = torch.cat([torch.arange(cap)] * 2)
    n_uniq2, _keys, merged = fusion.merge_grouped_partials(
        aggs, [rows], [torch.zeros_like(rows)],
        torch.cat([torch.arange(cap) < G] * 2),
        [(torch.cat([total, total]), torch.cat([cnt, cnt]))], cap)
    assert int(n_uniq2) == G
    np.testing.assert_array_equal(merged[0][0][:G].numpy(),
                                  2 * total[:G].numpy())

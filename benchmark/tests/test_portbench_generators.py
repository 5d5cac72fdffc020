"""The frozen TPC-H generator: the same seed gives the same tables,
another seed others, every seed the same sizes; each column keeps to
the value range its packed width in the configuration is computed from,
and the derived columns follow the spec's rules."""

import math

import numpy as np
import pytest

from benchmark import harness, traffic
from benchmark.generators import tpch

SCALE = 1 / 60
BOTH = ["lineitem", "orders"]


def _tables(seed):
    return tpch.generate(SCALE, traffic.seed_for(seed, 1), BOTH)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, -3])
def test_same_seed_same_tables(seed):
    a, b = _tables(seed), _tables(seed)
    for name in BOTH:
        (xa, da), (xb, db) = a[name], b[name]
        assert da == db
        for x, y in zip(xa, xb):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_other_seed_other_tables_of_the_same_sizes():
    a, b = _tables(11), _tables(12)
    for name in BOTH:
        assert [len(x) for x in a[name][0]] == [len(x) for x in b[name][0]]
    assert not np.array_equal(a["lineitem"][0][5], b["lineitem"][0][5])
    assert not np.array_equal(a["orders"][0][4], b["orders"][0][4])


def test_configured_sizes_and_widths():
    """`rows` is what the generator makes at the configuration's scale;
    `packed_bits` is ceil(log2) of the values in each column's range."""
    config = traffic.load_json(harness.HERE / "configs"
                               / "tpch_sf10_lineitem.json")
    sf = config["scale_factor"]
    for t in config["tables"]:
        assert tpch.sizes(sf)[t["name"]] == t["rows"]
        assert list(t["packed_bits"]) == tpch.COLUMNS[t["name"]]
        for col, bits in t["packed_bits"].items():
            assert bits == math.ceil(math.log2(tpch.domain(col, sf)))
    counts = tpch._line_counts(tpch.sizes(sf)["orders"],
                               tpch.sizes(sf)["lineitem"])
    assert counts.sum() == 59_986_052 and 1 <= counts.min() <= counts.max() <= 7


def test_values_stay_in_their_ranges():
    for name, (arrays, dicts) in _tables(3).items():
        for ci, (col, a) in enumerate(zip(tpch.COLUMNS[name], arrays)):
            assert int(a.max()) - int(a.min()) + 1 <= tpch.domain(col, SCALE)
            if ci in dicts:
                assert dicts[ci] == sorted(set(dicts[ci]))
                assert 0 <= a.min() and a.max() < len(dicts[ci])


def test_the_spec_rules():
    t = _tables(5)
    li = dict(zip(tpch.COLUMNS["lineitem"], t["lineitem"][0]))
    od = dict(zip(tpch.COLUMNS["orders"], t["orders"][0]))
    keys = od["o_orderkey"]
    assert np.all((keys - 1) % 32 < 8) and np.all(np.diff(keys) > 0)
    at = np.searchsorted(keys, li["l_orderkey"])
    assert np.array_equal(keys[at], li["l_orderkey"])       # every line's order
    pairs = li["l_orderkey"] * 8 + li["l_linenumber"]
    assert len(np.unique(pairs)) == len(pairs)               # the primary key
    part = li["l_partkey"]
    retail = 90_000 + (part // 10) % 20_001 + 100 * (part % 1_000)
    assert np.array_equal(li["l_extendedprice"], li["l_quantity"] // 100 * retail)
    ship, odate = li["l_shipdate"], od["o_orderdate"][at]
    assert np.all((ship - odate >= 1) & (ship - odate <= 121))
    assert np.all((li["l_commitdate"] - odate >= 30)
                  & (li["l_commitdate"] - odate <= 90))
    assert np.all((li["l_receiptdate"] - ship >= 1)
                  & (li["l_receiptdate"] - ship <= 30))
    late = li["l_receiptdate"] > tpch.CURRENTDATE
    assert np.all((li["l_returnflag"] == 1) == late)         # 'N'
    assert np.array_equal(li["l_linestatus"], ship > tpch.CURRENTDATE)
    assert np.all(od["o_custkey"] % 3 != 0)
    total = np.zeros(len(keys), np.int64)
    np.add.at(total, at, li["l_extendedprice"] * (100 + li["l_tax"])
              * (100 - li["l_discount"]))
    assert np.array_equal((total + 5_000) // 10_000, od["o_totalprice"])
    n_open = np.bincount(at, li["l_linestatus"], len(keys))
    n_all = np.bincount(at, minlength=len(keys))
    want = np.where(n_open == 0, 0, np.where(n_open == n_all, 1, 2))
    assert np.array_equal(od["o_orderstatus"], want)

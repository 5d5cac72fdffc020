"""The Q3 configuration's generator (`generators/tpch_q3.py`): customer
by the rules of Clause 4.2.3, orders and lineitem as the frozen `tpch`
generator makes them, the sizes and packed widths the configuration
states, and every order's customer present."""

import math

import numpy as np
import pytest

from benchmark import harness, traffic
from benchmark.generators import tpch, tpch_q3

SCALE = 1 / 60
ALL = ["customer", "orders", "lineitem"]
CONFIG = traffic.load_json(harness.HERE / "configs"
                           / "tpch_sf10_q3_keyed.json")


def _tables(seed, tables=ALL):
    return tpch_q3.generate(SCALE, traffic.seed_for(seed, 1), tables)


def _cols(made, name):
    arrays, dicts = made[name]
    return dict(zip(tpch_q3.COLUMNS[name], arrays)), dicts


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_same_seed_same_tables_and_the_frozen_generator_underneath(seed):
    a, b = _tables(seed), _tables(seed)
    for name in ALL:
        (xa, da), (xb, db) = a[name], b[name]
        assert da == db
        assert all(np.array_equal(x, y) for x, y in zip(xa, xb))
    frozen = tpch.generate(SCALE, traffic.seed_for(seed, 1),
                           ["lineitem", "orders"])
    for name in ("orders", "lineitem"):
        assert frozen[name][1] == a[name][1]
        assert all(np.array_equal(x, y)
                   for x, y in zip(frozen[name][0], a[name][0]))
    other = _tables(seed + 1, ["customer"])
    assert not np.array_equal(other["customer"][0][6], a["customer"][0][6])


def test_customer_keeps_the_spec_rules():
    made = _tables(4)
    cu, dicts = _cols(made, "customer")
    n = tpch_q3.sizes(SCALE)["customer"]
    assert np.array_equal(cu["c_custkey"], np.arange(1, n + 1))
    names = np.array(dicts[1], dtype=object)[cu["c_name"]]
    assert [f"Customer#{k:09d}" for k in cu["c_custkey"][:3]] == list(
        names[:3])
    assert len(set(names)) == n
    assert dicts[6] == tpch_q3.SEGMENTS
    share = np.bincount(cu["c_mktsegment"], minlength=5) / n
    assert share.min() > 0.15 and share.max() < 0.25   # uniform over 5
    assert cu["c_nationkey"].min() >= 0 and cu["c_nationkey"].max() <= 24
    phones = np.array(dicts[4], dtype=object)[cu["c_phone"]]
    for nation, ph in zip(cu["c_nationkey"][:200], phones[:200]):
        cc, a, b, c = ph.split("-")
        assert int(cc) == nation + 10 and len(ph) == 15
        assert 100 <= int(a) <= 999 and 100 <= int(b) <= 999
        assert 1000 <= int(c) <= 9999
    assert cu["c_acctbal"].min() >= -99_999
    assert cu["c_acctbal"].max() <= 999_999
    for ci, (lo, hi) in ((2, tpch_q3.TEXT_LEN["c_address"]),
                         (7, tpch_q3.TEXT_LEN["c_comment"])):
        lens = [len(t) for t in dicts[ci]]
        assert lo - 1 <= min(lens) and max(lens) <= hi
    od, _ = _cols(made, "orders")
    assert np.isin(od["o_custkey"], cu["c_custkey"]).all()
    assert np.all(od["o_custkey"] % 3 != 0)


def test_configured_sizes_and_widths():
    """`rows` is what the generator makes at SF10; `packed_bits` is
    ceil(log2) of the values in each column's range, for every column."""
    sf = CONFIG["scale_factor"]
    assert tpch_q3.sizes(sf) == {"customer": 1_500_000,
                                 "orders": 15_000_000,
                                 "lineitem": 59_986_052}
    for t in CONFIG["tables"]:
        assert tpch_q3.sizes(sf)[t["name"]] == t["rows"]
        assert list(t["packed_bits"]) == tpch_q3.COLUMNS[t["name"]]
        for col, bits in t["packed_bits"].items():
            assert bits == math.ceil(math.log2(tpch_q3.domain(col, sf)))
    assert [t["name"] for t in CONFIG["tables"]] == ALL


def test_values_stay_in_their_ranges():
    for name, (arrays, dicts) in _tables(3).items():
        for ci, (col, a) in enumerate(zip(tpch_q3.COLUMNS[name], arrays)):
            assert int(a.max()) - int(a.min()) + 1 <= tpch_q3.domain(col,
                                                                    SCALE)
            if ci in dicts:
                assert dicts[ci] == sorted(set(dicts[ci]))
                assert 0 <= a.min() and a.max() < len(dicts[ci])

"""Float sums that do not depend on how a fragment is chunked.

The whole-table program cuts a fragment into dispatch chunks, and the
host adds the chunks' float partials in chunk order.  The rows per
chunk come from the latency histograms that earlier statements filled
(`copr/chunking.chunk_budget_rows`), so a statement whose chunk edges
followed them could change its float sums with the process's history.
A fragment with a float SUM or AVG takes the fixed budget
`FLOAT_CHUNK_ROWS` instead; every other fragment keeps the learned one.

The table is chip_smoke's `fl` shape cut to 200,000 rows: doubles from
seed 8 grouped by 100 keys (past the 32 unrolled sums), in 8 regions.
Two histogram states, filled through `chunking.observe_chunk`, give the
learned budget 2 and 126 chunks.
"""

import math

import numpy as np
import pytest

from tidb_tpu_torch import ops
from tidb_tpu_torch.copr import chunking
from tidb_tpu_torch.metrics import REGISTRY, Histogram

ROWS = 200_000
GROUPS = 100
SEED = 8
REGIONS = 8
FLOAT_SQL = "select k, count(*), sum(x), avg(x) from fl group by k"
COUNT_SQL = "select k, count(*) from fl group by k"

#: (ms, rows) of one observed chunk: ~1 M rows/ms (a budget past the
#: table) and 32 rows/ms (the learned budget's floor region)
FAST = (1.0, 1 << 20)
SLOW = (64.0, 2048)


@pytest.fixture(scope="module")
def fl():
    from tidb_tpu_torch.session import Domain

    ops.use_device("cpu")
    rng = np.random.default_rng(SEED)
    keys = rng.integers(0, GROUPS, ROWS, dtype=np.int64)
    x = rng.random(ROWS)
    d = Domain()
    sess = d.new_session()
    sess.execute("create table fl (k bigint, x double)")
    t = d.catalog.info_schema().table("test", "fl")
    store = d.storage.table(t.id)
    store.bulk_load_arrays([keys, x], ts=d.storage.current_ts())
    d.storage.regions.split_even(t.id, REGIONS, store.base_rows)
    sess.execute("set tidb_use_tpu = 1")
    fsum = [math.fsum(x[keys == g]) for g in range(GROUPS)]
    return sess, fsum


@pytest.fixture
def histograms(monkeypatch):
    """Fills the agg chunk histograms with one state: 1000 chunks of
    (ms, rows), so the statement's own observations cannot move their
    medians."""
    monkeypatch.delenv("TIDB_TPU_DISPATCH_CHUNK_ROWS", raising=False)
    monkeypatch.delenv("TIDB_TPU_DISPATCH_CHUNK", raising=False)
    monkeypatch.setattr(chunking, "_CHUNK_MS", None)

    def fill(ms, rows):
        for name in ("dispatch_chunk_agg_ms", "dispatch_chunk_agg_rows"):
            monkeypatch.setitem(REGISTRY._hists, name, Histogram())
        for _ in range(1000):
            chunking.observe_chunk("agg", ms, rows)

    return fill


def _run(sess, sql):
    c0 = REGISTRY.get("dispatch_chunks_total")
    rows = sess.query(sql)
    engines = [r[4] for r in sess.execute("explain analyze " + sql)[0].rows
               if "TableReader" in r[0]]
    assert engines and all("engine:mesh" in e for e in engines), engines
    return sorted(rows), REGISTRY.get("dispatch_chunks_total") - c0


def test_learned_budgets_differ_between_the_two_states(histograms):
    histograms(*FAST)
    fast = chunking.chunk_budget_rows("agg")
    histograms(*SLOW)
    slow = chunking.chunk_budget_rows("agg")
    assert fast >= ROWS > 30 * slow
    assert chunking.chunk_budget_rows("agg", fixed=True) \
        == chunking.FLOAT_CHUNK_ROWS


def test_float_sums_are_bit_identical_whatever_the_histograms(fl,
                                                              histograms):
    """The float SUM and AVG take the fixed budget: the same chunk count
    and the same bits after either history, each group within 1e-12
    (relative) of math.fsum of its rows."""
    sess, fsum = fl
    histograms(*FAST)
    rows_a, chunks_a = _run(sess, FLOAT_SQL)
    histograms(*SLOW)
    rows_b, chunks_b = _run(sess, FLOAT_SQL)
    assert repr(rows_a) == repr(rows_b)
    assert chunks_a == chunks_b
    assert len(rows_a) == GROUPS
    for k, cnt, s, avg in rows_a:
        assert s == pytest.approx(fsum[k], rel=1e-12), k
        assert avg == pytest.approx(fsum[k] / cnt, rel=1e-12), k


def test_fragment_without_a_float_sum_follows_the_learned_budget(
        fl, histograms):
    sess, _fsum = fl
    histograms(*FAST)
    rows_a, chunks_a = _run(sess, COUNT_SQL)
    histograms(*SLOW)
    rows_b, chunks_b = _run(sess, COUNT_SQL)
    assert rows_a == rows_b
    # 8 regions, 4 range slots a dispatch: 2 chunks at the fast budget;
    # the slow budget cuts every region into many
    assert chunks_a == 2
    assert chunks_b > 10 * chunks_a

"""The port's mesh across processes: two OS processes join one gloo
torch.distributed group over localhost, each placing 4 positions on the
CPU, so one mesh spans 8 global positions (tests/torch_multihost_worker.py).

Both processes run the same statements over the same data.  Each runs
only its own shards; every shard's results are gathered to both, so
both must print the same rows, and those rows must equal the JAX
package's host engine (`tidb_use_tpu = 0`) and the port at one position
(ints and decimals exactly, floats after `_norm`).  Besides:

- each process's column cache holds only its own 4 shards, and K2 /
  K1 see per-shard inputs (cold Q1/Q6/ck1, the computed key);
- a float sum over 40 groups has the bits of the port at S = 8 in one
  process (shard-order merge, fixed chunk rows);
- the coordination plane forms with both members and 8 position ids,
  and process 1's trace reaches process 0;
- a shard of process 1 that fails mid-statement fails that statement
  on both processes (process 0 with `CollectiveError`, at once); the
  breaker it trips shrinks both meshes to 7 positions at the next
  epoch, and the probe restores 8 in both;
- processes that issue different statements both get
  `CollectiveError`, and the statements after run in step;
- when process 1 exits, process 0's next statement fails with the
  typed `CollectiveError` instead of hanging or running alone.

The JAX package's Q3 is its grouped rows ranked by value (its host sort
ranks DECIMAL(38, s) sums by their digits; tests/test_torch_join.py).
The workers run while this process computes the references.  A worker
timeout fails the test; it skips only when localhost TCP cannot bind.
"""

import json
import os
import socket
import subprocess
import sys
from decimal import Decimal

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK_ROWS = "16384"  # fixed dispatch chunks, here and in the workers
TIMEOUT_S = 240


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _norm(rows):
    return [tuple(round(v, 6) if isinstance(v, float) else v for v in r)
            for r in rows]


def _sorted(rows):
    return sorted(_norm(rows), key=lambda r: tuple(
        (0, "") if x is None else (1, str(x)) for x in r))


def _wire(rows):
    """Rows as the workers print them (JSON, non-JSON types as str)."""
    return json.loads(json.dumps(rows, default=str))


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    try:
        port, cport = _free_port(), _free_port()
    except OSError as e:
        pytest.skip(f"localhost TCP cannot bind here: {e}")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["TIDB_TPU_DISPATCH_CHUNK_ROWS"] = CHUNK_ROWS
    logs = [tmp_path_factory.mktemp("mh") / f"worker{pid}.log"
            for pid in (0, 1)]
    # output to files: a full pipe would stall a worker mid-collective
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(pid), "2", str(port), str(cport)],
        stdout=open(logs[pid], "w"), stderr=subprocess.STDOUT, env=env)
        for pid in (0, 1)]
    try:
        yield procs, logs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _results(fleet):
    procs, logs = fleet
    res = []
    for p, log in zip(procs, logs):
        try:
            p.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a mesh worker did not finish in {TIMEOUT_S} s")
        out = log.read_text()
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert p.returncode == 0 and line, out[-4000:]
        res.append(json.loads(line[-1][len("RESULT "):]))
    return res


def _references(monkeypatch):
    """{name: rows} of the JAX package's host engine and of the port at
    one position, and the port's float bits at S = 8."""
    sys.path.insert(0, os.path.dirname(WORKER))
    import torch_multihost_worker as w
    import tidb_tpu.tpch_data as jdata
    from tidb_tpu.session import Domain as JDomain
    import tidb_tpu_torch.tpch_data as tdata
    from tidb_tpu_torch import ops as tops
    from tidb_tpu_torch.session import Domain as TDomain

    monkeypatch.setenv("TIDB_TPU_DISPATCH_CHUNK_ROWS", CHUNK_ROWS)
    sqls = {"q1": tdata.LINEITEM_Q1, "q6": tdata.LINEITEM_Q6, "ck1": w.CK1,
            "q3": tdata.Q3_SQL, "mpp_inner": w.MPP_INNER,
            "mpp_grouped": w.MPP_GROUPED}
    refs = {}
    for pkg, data, dom, flag in (("jax", jdata, JDomain, 0),
                                 ("s1", tdata, TDomain, 1)):
        li = data.build_lineitem(16384, regions=4)
        q3 = data.build_q3_tables(16384, 512, regions=4)
        pair = w.load_pair(dom())
        sess = {"q3": q3, "mpp_inner": pair, "mpp_grouped": pair}
        for s in (li, q3, pair):
            s.execute(f"set tidb_use_tpu = {flag}")
        refs[pkg] = {n: _wire(sess.get(n, li).query(q))
                     for n, q in sqls.items()}
        if pkg == "jax":
            # the JAX package's host sort ranks DECIMAL(38, s) sums by
            # their digits (tests/test_torch_join.py): hold Q3 to its
            # grouped rows, ranked by value
            rows = q3.query(sqls["q3"].split(" order by")[0])
            refs[pkg]["q3"] = _wire(sorted(
                rows, key=lambda r: (-Decimal(str(r[3])), r[0]))[:10])
        if pkg == "s1":
            fl = w.load_fl(TDomain())
            fl.execute("set tidb_use_tpu = 1")
            tops.use_device("cpu", shards=8)
            try:
                refs["fl_s8"] = [[int(g), float(x).hex(), int(c)]
                                 for g, x, c in fl.query(w.FL)]
            finally:
                tops.use_device("cpu")
    return refs


@pytest.fixture(scope="module")
def outcome(fleet):
    mp = pytest.MonkeyPatch()
    try:
        from tidb_tpu_torch import ops as tops

        tops.use_device("cpu")
        refs = _references(mp)
    finally:
        mp.undo()
    return _results(fleet), refs


UNORDERED = ("ck1", "mpp_inner", "mpp_grouped")


def _same(a, b, name):
    if name.removeprefix("cold_") in UNORDERED:
        return _sorted(a) == _sorted(b)
    return _norm(a) == _norm(b)


@pytest.mark.parametrize("name", ["q1", "q6", "ck1", "q3", "mpp_inner",
                                  "mpp_grouped", "cold_q1", "cold_q6",
                                  "cold_ck1"])
def test_rows_equal_host_engine_and_one_position(outcome, name):
    res, refs = outcome
    base = name.removeprefix("cold_")
    got = [r["rows"][name] for r in res]
    assert got[0] == got[1], name          # both processes print the same
    assert got[0], name
    assert _same(got[0], refs["jax"][base], name), name
    assert _same(got[0], refs["s1"][base], name), name


def test_each_process_runs_and_caches_only_its_own_shards(outcome):
    res, _ = outcome
    for pid, r in enumerate(res):
        assert r["hot_mesh"] == list(range(8))
        assert r["cache_local_shards"] == [list(range(4 * pid,
                                                      4 * pid + 4))]
        assert r["mesh_scans"] >= 5
        assert r["mpp_shuffle"] >= 2 and r["mpp_fallback"] == 0
        # cold columns decode a shard at a time; the computed key
        # re-maps each shard's codes (16,384 rows / 8 shards)
        assert r["cold_tier"] > 0 and r["unpack_calls"] > 0
        assert r["unpack_max_n"] <= 2048
        assert r["remap_n"] == [2048]


def test_float_sums_have_the_single_process_bits(outcome):
    res, refs = outcome
    assert len(refs["fl_s8"]) == 40
    for r in res:
        assert r["fl_hex"] == refs["fl_s8"]


def test_plane_forms_and_carries_spans(outcome):
    res, _ = outcome
    for r in res:
        assert r["plane"]["members"] == [0, 1] and r["plane"]["formed"]
        assert r["plane"]["device_ids"] == list(range(8))
    assert res[0]["plane"]["kind"] == "coordinator"
    assert res[0]["spans_ingested"] >= 1
    assert res[1]["spans_forwarded"] >= 1


def test_breaker_trip_on_one_process_shrinks_both_meshes(outcome):
    """The trip comes from a shard that fails mid-statement on process
    1: both processes fail that statement together (neither waits for
    the group's timeout), then run on in step."""
    res, refs = outcome
    victim = 5
    assert res[0]["shard_fault"] == "CollectiveError"
    assert res[1]["shard_fault"] == "DeviceFailure"
    for r in res:
        assert r["shard_fault_s"] < 30
        assert r["trip_seen"] and r["restore_seen"]
        assert r["tripped_mesh"] == [i for i in range(8) if i != victim]
        assert r["restored_mesh"] == list(range(8))
        for q in ("q6_tripped", "q6_probe", "q6_restored"):
            assert _norm(r["rows"][q]) == _norm(refs["s1"]["q6"]), q
    assert res[1]["victim_state"] == "healthy"


def test_different_statements_fail_typed_and_the_fleet_stays_in_step(
        outcome):
    """Process 0 issues Q1 while process 1 issues Q6: the first
    collective's header shows different programs, both raise
    CollectiveError there, and the Q6 and MPP join that both issue next
    have the one-position rows."""
    res, refs = outcome
    for r in res:
        assert r["mismatch"] == "CollectiveError"
        assert _norm(r["rows"]["q6_after_mismatch"]) == \
            _norm(refs["s1"]["q6"])
        assert _sorted(r["rows"]["mpp_after_mismatch"]) == \
            _sorted(refs["s1"]["mpp_inner"])


def test_a_lost_process_fails_the_statement_with_a_typed_error(outcome):
    """Process 1 exits while process 0 issues a statement: the statement
    gets CollectiveError (at once: the exit closed the peer's
    connections; the group's timeout bounds any other wait), and
    process 0 never answers alone."""
    res, _ = outcome
    assert res[0]["lost_peer"] == "CollectiveError"
    assert res[0]["lost_peer_s"] < 60

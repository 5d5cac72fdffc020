"""One process of the port's 2-process mesh (tests/test_torch_multihost.py).

argv: [process_id, num_processes, dist_port, coord_port].  Each process
places 4 mesh positions on the CPU (`use_device("cpu", shards=4)`), so
the mesh spans 8 global positions; the processes join one gloo
torch.distributed group (TIDB_TPU_COORDINATOR) and form the
coordination plane (TIDB_TPU_COORD_ADDR).  Every process runs the SAME
script over the same data (SPMD): identical builds from one seed,
identical statements in one order.

The process prints one `RESULT <json>` line: the rows of every
statement (Q1, Q6, a computed key, the broadcast-join Q3, MPP shuffle
joins, hot and cold), the bits of a float sum over 40 groups, what its
column cache holds, the plane's view, the errors both get when a shard
of process 1 fails mid-statement, the meshes around the breaker trip
that failure causes and its probe, the errors both get when they issue
different statements and the rows of the statements after, and, after
the last process exits without a word, the error the other's next
statement gets.  The test holds the rows against the
JAX package's host engine and the port at one position.  No jax here.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CK1 = ("select lower(l_returnflag), l_linestatus, sum(l_quantity),"
       " sum(l_extendedprice * (1 - l_discount)), avg(l_discount),"
       " count(*) from lineitem where l_shipdate <= '1998-09-02'"
       " group by lower(l_returnflag), l_linestatus")
MPP_INNER = ("select l_orderkey, l_qty, o_flag, o_total from li join orders"
             " on l_orderkey = o_orderkey where l_qty < 40")
MPP_GROUPED = ("select o_flag, substr(o_clerk, 2, 2), count(*),"
               " sum(l_price), min(l_qty), max(o_total) from li join"
               " orders on l_orderkey = o_orderkey"
               " group by o_flag, substr(o_clerk, 2, 2)")
FL = "select g, sum(x), count(*) from fl group by g order by g"
N_FL, G_FL = 30_000, 40


def load_pair(d):
    """4,000 orders, 24,000 line rows (tests/test_mpp.py's shape)."""
    import numpy as np

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


def load_fl(d):
    """N_FL doubles in G_FL groups: dense float sums above 32 groups."""
    import numpy as np

    s = d.new_session()
    s.execute("create table fl (g bigint, x double)")
    t = d.catalog.info_schema().table("test", "fl")
    rng = np.random.default_rng(8)
    d.storage.table(t.id).bulk_load_arrays(
        [rng.integers(0, G_FL, N_FL, dtype=np.int64),
         rng.uniform(-1e3, 1e3, N_FL)], ts=d.storage.current_ts())
    d.storage.regions.split_even(t.id, 4, N_FL)
    return s


def cold_cap(table) -> int:
    """A hot cap below the table's packable columns: they go cold."""
    from tidb_tpu_torch import layout

    at = layout.autotuner
    unpackable = sum(at._column_wire_bytes(table, ci)
                     for ci in range(table.n_cols)
                     if layout.coldtier.pack_info(table, ci) is None)
    return int(unpackable / at.LayoutEngine.HOT_FILL) + 1024


def _wait(pred, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def main() -> int:
    pid, nproc, port, cport = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    os.environ["TIDB_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["TIDB_TPU_NUM_PROCESSES"] = str(nproc)
    os.environ["TIDB_TPU_PROCESS_ID"] = str(pid)
    os.environ["TIDB_TPU_COORD_ADDR"] = f"127.0.0.1:{cport}"
    os.environ.setdefault("TIDB_TPU_DIST_TIMEOUT_S", "120")
    os.environ["TIDB_TPU_TILE"] = "1024"
    os.environ["TIDB_TPU_LAYOUT_RETUNE_S"] = "0"

    import numpy as np

    from tidb_tpu_torch import ops

    ops.use_device("cpu", shards=4)
    # the processes share the host's cores: no oversubscribed torch pool
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    from tidb_tpu_torch.copr import parallel as pl
    from tidb_tpu_torch.copr.cuda import remap as tremap
    from tidb_tpu_torch.copr.cuda import unpack as tunpack
    from tidb_tpu_torch.copr.device_health import DEVICE_HEALTH, DeviceFailure
    from tidb_tpu_torch.coord import get_plane
    from tidb_tpu_torch.metrics import REGISTRY
    from tidb_tpu_torch.session import Domain
    from tidb_tpu_torch.tpch_data import (LINEITEM_Q1, LINEITEM_Q6, Q3_SQL,
                                          build_lineitem, build_q3_tables)

    pl._maybe_init_multihost()
    assert ops.process_count() == nproc and ops.process_index() == pid
    mesh = pl.get_mesh()
    assert mesh.size == 4 * nproc, mesh.ids
    assert mesh.local == tuple(range(4 * pid, 4 * pid + 4)), mesh.local

    # K1 / K2 plain versions: the sizes they see (per-shard inputs)
    seen = {"unpack": [], "remap": []}
    real_u, real_r = tunpack.unpack_codes_plain, tremap.remap_codes_plain

    def spy_u(packed, bits, n, bias=None):
        seen["unpack"].append(int(n))
        return real_u(packed, bits, n, bias)

    def spy_r(codes, mapping, n):
        seen["remap"].append(int(n))
        return real_r(codes, mapping, n)

    tunpack.unpack_codes_plain = spy_u
    tremap.remap_codes_plain = spy_r

    sess = build_lineitem(16384, regions=4)
    s3 = build_q3_tables(16384, 512, regions=4)
    plan = [r[0] for r in s3.execute("explain " + Q3_SQL)[0].rows]
    assert any("DeviceJoinReader" in op for op in plan), plan
    dom = Domain()
    sp = load_pair(dom)
    sf = load_fl(dom)
    for s in (sess, s3, sp, sf):
        s.execute("set tidb_use_tpu = 1")

    def run(s, q):
        return json.loads(json.dumps(s.query(q), default=str))

    out = {"pid": pid, "rows": {}}
    m0 = REGISTRY.get("mesh_scans_total")
    for name, s, q in (("q1", sess, LINEITEM_Q1), ("q6", sess, LINEITEM_Q6),
                       ("ck1", sess, CK1), ("q3", s3, Q3_SQL),
                       ("mpp_inner", sp, MPP_INNER),
                       ("mpp_grouped", sp, MPP_GROUPED)):
        seen["remap"].clear()
        out["rows"][name] = run(s, q)
        if name == "ck1":
            out["remap_n"] = sorted(set(seen["remap"]))
    out["mesh_scans"] = REGISTRY.get("mesh_scans_total") - m0
    out["mpp_shuffle"] = (REGISTRY.get("mpp_joins_shuffle_total")
                          + REGISTRY.get("mpp_joins_shuffle_grouped_total"))
    out["mpp_fallback"] = REGISTRY.get("mpp_fallback_total")
    fl = sf.query(FL)
    out["fl_hex"] = [[int(g), float(x).hex(), int(c)] for g, x, c in fl]
    out["hot_mesh"] = list(pl._MESH.ids)

    # what this process's column cache holds: its own shards only
    held = []
    for key, val in pl.MESH_CACHE._cache.items():
        data = val[0]
        held.append([i for i, t in enumerate(data) if t is not None])
    out["cache_local_shards"] = sorted({tuple(h) for h in held})

    # cold tier: every packable column bit-packed, decoded a shard
    from tidb_tpu_torch import layout

    li = sess.domain.storage.table(sess.domain.catalog.info_schema().table(
        "test", "lineitem").id)
    layout.set_hot_cap_bytes(cold_cap(li))
    h0 = REGISTRY.get("layout_cold_hits_total") \
        + REGISTRY.get("layout_cold_loads_total")
    seen["unpack"].clear()
    for name, q in (("cold_q1", LINEITEM_Q1), ("cold_q6", LINEITEM_Q6),
                    ("cold_ck1", CK1)):
        out["rows"][name] = run(sess, q)
    out["cold_tier"] = (REGISTRY.get("layout_cold_hits_total")
                        + REGISTRY.get("layout_cold_loads_total") - h0)
    out["unpack_max_n"] = max(seen["unpack"] or [0])
    out["unpack_calls"] = len(seen["unpack"])
    layout.set_hot_cap_bytes(8 << 30)

    # the coordination plane: both members, 8 global position ids, and
    # process 1's trace forwarded to process 0
    plane = get_plane()
    view = plane.view()
    out["plane"] = {"members": sorted(view.members), "formed": view.formed,
                    "device_ids": sorted(view.device_ids()),
                    "kind": plane.kind}
    sess.execute("trace format='row' select count(*) from lineitem")
    if pid == 0:
        _wait(lambda: REGISTRY.get("coord_spans_ingested_total") >= 1, 20)
        out["spans_ingested"] = REGISTRY.get("coord_spans_ingested_total")
    else:
        out["spans_forwarded"] = REGISTRY.get("coord_spans_forwarded_total")

    # a shard of process 1 fails mid-statement (its second local shard,
    # position 5): process 1 trips that position's breaker and fails
    # the statement; process 0, waiting at the statement's gather, fails
    # the same statement with CollectiveError.  The trip then shrinks
    # BOTH meshes at the next epoch; the probe restores both
    from tidb_tpu_torch.errors import CollectiveError

    victim = 4 * (nproc - 1) + 1
    e0 = plane.current_epoch()
    ops.agree(0)  # both past their reads of the old epoch
    real_calls = pl._shard_calls
    if pid == nproc - 1:
        def faulty(core, *args):
            n = [0]

            def failing(*a):
                n[0] += 1
                if n[0] == 2:
                    raise DeviceFailure("injected shard fault", (victim,))
                return core(*a)

            return real_calls(failing, *args)

        pl._shard_calls = faulty
    t0 = time.monotonic()
    try:
        run(sess, LINEITEM_Q6)
        out["shard_fault"] = "no error"
    except Exception as e:  # noqa: BLE001 - the type is the result
        out["shard_fault"] = type(e).__name__
    finally:
        pl._shard_calls = real_calls
    out["shard_fault_s"] = time.monotonic() - t0
    out["trip_seen"] = _wait(lambda: victim not in plane.view().device_ids()
                             and plane.current_epoch() > e0)
    ops.agree(0)
    out["rows"]["q6_tripped"] = run(sess, LINEITEM_Q6)
    out["tripped_mesh"] = list(pl._MESH.ids)
    if pid == nproc - 1:
        DEVICE_HEALTH.expire_cooldowns()
    ops.agree(0)
    out["rows"]["q6_probe"] = run(sess, LINEITEM_Q6)
    out["restore_seen"] = _wait(
        lambda: victim in plane.view().device_ids())
    ops.agree(0)
    out["rows"]["q6_restored"] = run(sess, LINEITEM_Q6)
    out["restored_mesh"] = list(pl._MESH.ids)
    out["victim_state"] = DEVICE_HEALTH.state_of(victim)

    # the processes issue different statements (the order a client of
    # each must keep): both fail typed at the first collective, and
    # the next statement they share runs in step
    ops.agree(0)
    try:
        run(sess, LINEITEM_Q1 if pid == 0 else LINEITEM_Q6)
        out["mismatch"] = "no error"
    except CollectiveError:
        out["mismatch"] = "CollectiveError"
    out["rows"]["q6_after_mismatch"] = run(sess, LINEITEM_Q6)
    out["rows"]["mpp_after_mismatch"] = run(sp, MPP_INNER)

    # a process that dies while the others wait: the statement of the
    # survivor fails with the typed CollectiveError, it does not hang
    # and does not run alone
    ops.agree(0)
    if pid == nproc - 1:
        print("RESULT " + json.dumps(out), flush=True)
        os._exit(0)
    t0 = time.monotonic()
    try:
        run(sess, LINEITEM_Q6)
        out["lost_peer"] = "no error"
    except CollectiveError as e:
        out["lost_peer"] = type(e).__name__
    out["lost_peer_s"] = time.monotonic() - t0
    print("RESULT " + json.dumps(out), flush=True)
    plane.stop()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())

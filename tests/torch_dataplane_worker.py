"""One member of the port's 2-process sharded data plane
(tests/test_torch_dataplane.py), on the pattern of tests/dataplane_worker.py.

Each member builds the SAME lineitem table from one seed, joins the
test process's Coordinator, activates the data plane (its fragment RPC
server advertised through the membership broadcast) and shards the
table; then each member materializes only its own partitions and every
scan scatters over the fleet.  Each round prints parity against the
port's host engine and the counters that prove where the round ran:
`dp` (statements the data plane served), `card` (partition fragments
this member ran on its card through the mesh program), `cpu` (host
engine region runs, which must stay 0) and `bypass`.  A SIGKILL of the
peer must show as a bumped epoch, a survivor re-shard, and ok=1 rounds
that keep carrying dp >= 1.

argv: [process_id, coordinator_port].  Env: COORD_LEASE_S,
COORD_WORKER_MAX_S, TIDB_TPU_DATAPLANE_DIR (the shared replay
directory), TIDB_TPU_DATAPLANE_RF.  No jax here.
"""

import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

QUERIES = [
    ("q6", "select sum(l_extendedprice * l_discount) from lineitem"
           " where l_discount between 0.05 and 0.07"
           " and l_quantity < 24"),
    ("q1", "select l_returnflag, l_linestatus, sum(l_quantity),"
           " sum(l_extendedprice), count(*) from lineitem"
           " where l_shipdate <= '1998-09-02'"
           " group by l_returnflag, l_linestatus"
           " order by l_returnflag, l_linestatus"),
    ("agg", "select l_returnflag, count(*), sum(l_quantity)"
            " from lineitem group by l_returnflag"
            " order by l_returnflag"),
    ("ck1", "select lower(l_returnflag), l_linestatus, sum(l_quantity),"
            " count(*) from lineitem group by lower(l_returnflag),"
            " l_linestatus order by 1, 2"),
    ("join", "select l_returnflag, count(*) from lineitem"
             " join flags on l_returnflag = f_flag"
             " where f_ord >= 0 group by l_returnflag"
             " order by l_returnflag"),
]


def _approx(a, b):
    if isinstance(a, float) or isinstance(b, float):
        try:
            return abs(float(a) - float(b)) <= 1e-6 * max(
                1.0, abs(float(a)), abs(float(b)))
        except (TypeError, ValueError):
            return a == b
    return a == b


def _rows_match(got, want):
    if len(got) != len(want):
        return False
    return all(len(g) == len(w) and all(_approx(x, y)
               for x, y in zip(g, w))
               for g, w in zip(got, want))


def main() -> int:
    pid, port = int(sys.argv[1]), int(sys.argv[2])
    os.environ.setdefault("TIDB_TPU_TILE", "1024")

    from tidb_tpu_torch import ops

    ops.use_device("cpu")
    # the processes share the host's cores: no oversubscribed torch pool
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    from tidb_tpu_torch.coord import activate_worker
    from tidb_tpu_torch.dataplane import activate_dataplane
    from tidb_tpu_torch.metrics import REGISTRY
    from tidb_tpu_torch.tpch_data import build_lineitem

    lease_s = float(os.environ.get("COORD_LEASE_S", "1.5"))
    max_s = float(os.environ.get("COORD_WORKER_MAX_S", "120"))
    t0 = time.monotonic()

    sess = build_lineitem(8192, regions=4)
    dom = sess.domain
    tid = dom.catalog.info_schema().table("test", "lineitem").id
    sess.execute("create table flags (f_flag varchar(1), f_ord bigint)")
    sess.execute("insert into flags values ('A', 0), ('N', 1), ('R', 2)")

    plane = activate_worker(("127.0.0.1", port), pid=pid,
                            devices=list(ops.device_ids()),
                            lease_s=lease_s)
    dp = activate_dataplane(dom.storage, plane=plane, pid=pid)

    # shard once the fleet formed and every fragment endpoint is
    # advertised: ownership derived before formation would flap
    expect = int(os.environ.get("COORD_EXPECT", "2"))
    while time.monotonic() - t0 < 30:
        v = plane.view()
        if v.formed and len(v.members) >= expect and len(v.addrs) >= expect:
            break
        time.sleep(0.05)
    dp.shard_table(tid)
    st = dp.lookup(tid)
    print(f"SHARDED pid={pid} loaded={len(st.loaded)}/{st.n_parts}",
          flush=True)

    sess.execute("set tidb_use_tpu = 0")
    oracles = {name: sess.query(q) for name, q in QUERIES}
    sess.execute("set tidb_use_tpu = 1")
    print(f"READY pid={pid}", flush=True)

    stop = [False]
    signal.signal(signal.SIGTERM, lambda *_a: stop.__setitem__(0, True))

    def cnt(name):
        return int(REGISTRY.get(name) or 0)

    rounds = 0
    while not stop[0] and time.monotonic() - t0 < max_s:
        names = ("dataplane_queries_total", "dataplane_card_fragments_total",
                 "cop_region_cpu_runs_total", "dataplane_bypass_total",
                 "dataplane_failover_bypass_total")
        before = [cnt(n) for n in names]
        ok = 1
        for name, q in QUERIES:
            if not _rows_match(sess.query(q), oracles[name]):
                ok = 0
                print(f"MISMATCH pid={pid} q={name}", flush=True)
        dp_used, card, cpu, byp, fbyp = (cnt(n) - b
                                         for n, b in zip(names, before))
        print(f"ROUND pid={pid} n={rounds} epoch={plane.current_epoch()} "
              f"ok={ok} dp={dp_used} card={card} cpu={cpu} "
              f"bypass={byp + fbyp} "
              f"promote={cnt('dataplane_replica_promotions_total')} "
              f"cold={cnt('dataplane_cold_reloads_total')}", flush=True)
        rounds += 1
        time.sleep(0.05)

    plane.leave()
    plane.stop()
    print(f"DRAINED pid={pid} rounds={rounds}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

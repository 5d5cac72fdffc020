"""The multi-process fleet over several cards: one process a card, nccl.

    python tools/fleet_cards.py       # on a machine with 4 or more cards

`chip_smoke.py` runs its fleet phases as processes sharing the one card
over gloo.  This script runs the same phases with one process a card,
where the backend is nccl (`copr.parallel.dist_backend`):

- `mh`: four processes, each `ops.use_device("cuda:<rank>")`, one mesh
  of four positions across them: SF10 Q1, Q6 and ck1 hot and cold (K1
  and K2 on each process's inputs, held against their plain versions),
  Domain T's t3 and tsj (the exchange's all_to_all between cards),
  fl_dense; every process's rows against numpy and card 0 alone
  (`ops.use_device("cuda:0")` in this process, S = 1), the steady walls
  side by side;
- `dp`: four data-plane members, one a card, RF = 2: rounds through
  the data plane hot and cold, then SIGKILL of member 3, whose
  partitions member 0 takes over by promoting its warm replicas
  (`dataplane_replica_promotions_total` moves,
  `dataplane_cold_reloads_total` does not); the time to recover.

Prints the cards' names and power limits, the cells and one JSON line
of the walls; exits non-zero when fewer than four cards are visible or
a cell fails.  No jax here.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

CARDS = 4


def main() -> int:
    import torch

    if torch.cuda.device_count() < CARDS:
        print(f"fleet_cards: {torch.cuda.device_count()} CUDA cards, "
              f"need {CARDS}", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tidb_tpu_torch import ops
    from tidb_tpu_torch.copr.cuda import build_all
    from tidb_tpu_torch.layout import hot_cap_bytes, set_hot_cap_bytes
    from tidb_tpu_torch.tpch_data import (TPCH_QUERIES, build_lineitem,
                                          build_tpch_domain)

    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    for c in cards:
        cs.log(f"card: {c}")
    os.environ["TIDB_TPU_DISPATCH_CHUNK_ROWS"] = str(cs.CHUNK_ROWS)
    ops.use_device("cuda:0")
    build_all()

    # card 0 alone: the same cells in this process, S = 1
    t0 = time.perf_counter()
    sess = build_lineitem(cs.SF10_ROWS, seed=cs.SEED)
    d = sess.domain
    table = d.storage.table(d.catalog.info_schema().table(
        "test", "lineitem").id)
    want = cs.numpy_reference(cs.SF10_ROWS)
    cs.log(f"SF10 built and referenced in {time.perf_counter() - t0:.1f} s")
    cells = [(n, cs._sql(n, q)) for n, q in cs.MH_CELLS]
    s1 = {}
    hot = cs.run_queries(sess, "card 0 hot", cs.SF10_ROWS, cells)
    cs.check_rows("card 0 hot", hot, want)
    cs.reset_device_state()
    default_cap = hot_cap_bytes()
    set_hot_cap_bytes(cs.cold_cap(table))
    cold = cs.run_queries(sess, "card 0 cold", cs.SF10_ROWS, cells)
    cs.check_rows("card 0 cold", cold, want)
    set_hot_cap_bytes(default_cap)
    s1.update({f"hot {k}": v for k, v in hot.items()})
    s1.update({f"cold {k}": v for k, v in cold.items()})
    del sess, d, table
    gc.collect()
    cs.reset_device_state()
    sess = build_tpch_domain(scale=cs.T_SCALE, seed=cs.T_SEED, regions=8)
    sess.execute("set tidb_allow_mpp = 1")
    sql = {"t3": TPCH_QUERIES["q3"], "tsj": cs.SJ}
    t = cs.mpp_cells(sess, "card 0 T", int(8000 * cs.T_SCALE),
                     [(n, sql[n], "MPPJoinTree", "mpp_tree_joins_total")
                      for n in cs.MH_T], None, reps=2)
    s1.update({f"T {k}": v for k, v in t.items()})
    del sess
    gc.collect()
    cs.reset_device_state()
    fl, _want, _fsum = cs.fl_table()
    times = []
    for _ in range(cs.FL_RUNS):
        t0 = time.perf_counter()
        rows = fl.query(cs.FL_DENSE)
        times.append(time.perf_counter() - t0)
    s1["fl_dense"] = {"rows": rows, "steady_s": statistics.median(times[1:])}
    del fl
    gc.collect()
    cs.reset_device_state()

    # a fleet phase that stalls must not hold four cards for long
    cs.FLEET_TIMEOUT_S = 240
    fleet = cs.mh_phase(want, s1, nprocs=CARDS, layout="cards")
    fleet.update(cs.dp_phase(want, members=CARDS, rf=2, layout="cards"))
    print(json.dumps({
        "cards": cards,
        "card0_steady_s": {k: v["steady_s"] for k, v in s1.items()},
        "fleet": {ph: {k: v for k, v in r.items()
                       if k in ("launches", "wall_s", "recover_s")}
                  for ph, r in fleet.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

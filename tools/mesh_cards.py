"""The mesh over several cards: one mesh position a card.

    python tools/mesh_cards.py        # on a machine with 4 or more cards

`chip_smoke.py` runs the mesh as four positions on one card.  This
script runs the same SF10 cells with the default mesh of a multi-card
machine, `ops.use_device("cuda")` (one position per visible card), so
the shards live in separate memories and run concurrently: hot q1, q6,
ck1, tn and mf, cold q1, q6 and ck1, failover (position 3 fails once
during Q1; the rebuilt mesh holds the other cards, a probe restores
it) and mA10.  Each cell's rows must equal numpy and the same cell on
card 0 alone (`ops.use_device("cuda:0")`, S = 1); steady walls are
printed side by side, with every card's peak device memory for mA10.
Prints the cards' names and power limits, then one JSON line of the
cells; exits non-zero when fewer than four cards are visible or a cell
fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main() -> int:
    import torch

    if torch.cuda.device_count() < 4:
        print(f"mesh_cards: {torch.cuda.device_count()} CUDA cards, "
              "need 4", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from tidb_tpu_torch import ops
    from tidb_tpu_torch.copr.cuda import build_all
    from tidb_tpu_torch.layout import hot_cap_bytes, set_hot_cap_bytes
    from tidb_tpu_torch.tpch_data import (LINEITEM_Q1, LINEITEM_Q6,
                                          build_lineitem, load_arrays)

    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    for c in cards:
        cs.log(f"card: {c}")
    n_cards = torch.cuda.device_count()
    os.environ["TIDB_TPU_DISPATCH_CHUNK_ROWS"] = str(cs.CHUNK_ROWS)
    ops.use_device("cuda:0")
    build_all()
    t0 = time.perf_counter()
    sess = build_lineitem(cs.SF10_ROWS, seed=cs.SEED)
    d = sess.domain
    table = d.storage.table(d.catalog.info_schema().table(
        "test", "lineitem").id)
    want = cs.numpy_reference(cs.SF10_ROWS)
    cs.log(f"SF10 built and referenced in {time.perf_counter() - t0:.1f} s")
    cells = [("q1", LINEITEM_Q1), ("q6", LINEITEM_Q6), ("ck1", cs.CK1),
             ("tn", cs.TN), ("mf", cs.MF)]
    hot = cs.run_queries(sess, "card 0 hot", cs.SF10_ROWS, cells)
    cs.check_rows("card 0 hot", hot, want)
    cs.reset_device_state()
    default_cap = hot_cap_bytes()
    set_hot_cap_bytes(cs.cold_cap(table))
    cold = cs.run_queries(sess, "card 0 cold", cs.SF10_ROWS, cells[:3])
    cs.check_rows("card 0 cold", cold, want)
    set_hot_cap_bytes(default_cap)
    out, _k1, _k2 = cs.mesh_phase(sess, table, want, hot, cold, False,
                                  shards=None)

    keys, prio = cs.ma10_orders(cs.SF10_ROWS)
    sess.execute("create table orders (o_orderkey bigint,"
                 " o_orderpriority varchar(15))")
    load_arrays(sess, "orders", [keys, prio], {1: cs.PRIORITIES})
    sess.execute("analyze table orders")
    wm = {"mA10": cs.ma10_reference(cs.SF10_ROWS, prio)}
    spec = [("mA10", cs.MA10, "MPPJoin", "mpp_joins_shuffle_grouped_total")]
    peaks = {}
    for label, dev in (("card 0", "cuda:0"), (f"{n_cards} cards", "cuda")):
        cs.reset_device_state()
        ops.use_device(dev)
        for i in range(n_cards):
            torch.cuda.synchronize(i)
            torch.cuda.reset_peak_memory_stats(i)
        res = cs.mpp_cells(sess, label, cs.SF10_ROWS, spec, wm)
        peaks[label] = [torch.cuda.max_memory_allocated(i)
                        for i in range(n_cards)]
        cs.log(f"{label} mA10: peak device memory per card (GiB) "
               f"{[round(p / 2**30, 2) for p in peaks[label]]}")
        out[f"{label} mA10"] = res["mA10"]
    cs.compare_s1(f"{n_cards} cards", {"mA10": out[f"{n_cards} cards mA10"]},
                  {"mA10": out["card 0 mA10"]}, n_cards)
    cs.reset_device_state()
    ops.use_device("cuda:0")
    print(json.dumps({name: {k: v for k, v in r.items() if k in (
        "steady_s", "s1_steady_s", "first_s", "route", "failed_s",
        "probe_s", "rebuilt", "launches")} for name, r in out.items()}))
    print(json.dumps({"cards": cards, "mA10_peak_bytes": peaks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""TPC-H Q3 at SF10 on the keyed schema, on one card, in one process: the
route the planner takes and what the join tree counts while it holds.

    python3 tools/q3_card.py [--seed N] [--warm 10] [--statements 30]

Loads the benchmark configuration `tpch_sf10_q3_keyed` (customer,
orders, lineitem, unanalyzed) as a run of the `sf10_join_s3` cell does,
prints one EXPLAIN ANALYZE, sends `--warm` statements drawn as the
cell's warm-up draws them, then `--statements` more one after another,
each held against the plain reference, and reports the MPP counters'
moves over those (the overflow, fallback and peel counters, the tree's
groups a statement, the rows host joins emitted, the emission fill
share: rows the rungs' count passes found over the slots their emission
buffers held), each statement's host-clock time, the median host-clock
time of each phase of the tree (`mpp.rung` by index, `mpp.tree.final`:
each holds the device door, so alone they are the door's holds) and the
card's peak memory.  Prints one JSON line.  Imports nothing of the JAX
package."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: counters that move when the tree re-runs a rung, peels or leaves the card
STEADY = ("mpp_tree_emit_overflow_total", "mpp_partition_overflow_total",
          "mpp_tree_fallback_total", "mpp_grouped_agg_overflow_total",
          "mpp_grouped_agg_fallback_total", "host_join_rows_total")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("tools/q3_card.py")
    ap.add_argument("--seed", type=int, default=2147483659)
    ap.add_argument("--warm", type=int, default=10)
    ap.add_argument("--statements", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness, traffic
    from tidb_tpu_torch import ops
    from tidb_tpu_torch.metrics import REGISTRY
    from tidb_tpu_torch.session import Domain
    from tidb_tpu_torch.trace import recorder

    cell = harness.load_cell("sf10_join_s3")
    scale = cell.config["scale_factor"] if args.scale is None else args.scale
    ops.use_device(args.device)
    sess = Domain().new_session()
    data = harness.build_tables(sess, cell.config, args.seed, scale,
                                args.device)
    q3 = cell.shapes["q3"]
    stmts = traffic.streams(dict(cell.workload, streams=1), cell.shapes,
                            args.seed, args.warm + args.statements)[0]
    explain = [" | ".join(str(v) for v in r if v) for r in sess.execute(
        "explain analyze " + stmts[0][1])[0].rows]
    for _shape, sql, _p in stmts[:args.warm]:
        sess.query(sql)
    tables = {t: {c: torch.from_numpy(data[t][c]).to(args.device)
                  for c in cols} for t, cols in q3["reads"].items()}
    traces = []
    recorder.chain_export_hook(traces.append)
    snap0 = REGISTRY.snapshot()
    ms, bad = [], 0
    for _shape, sql, p in stmts[args.warm:]:
        t0 = time.perf_counter()
        got = sess.query(sql)
        ms.append((time.perf_counter() - t0) * 1e3)
        want = q3["module"].reference(tables, p)
        bad += harness.compare([tuple(str(v) for v in r) for r in got],
                               want, True)
    snap1 = REGISTRY.snapshot()
    recorder.unchain_export_hook(traces.append)
    n = len(ms)
    moved = {k: snap1.get(k, 0) - snap0.get(k, 0)
             for k in STEADY + ("mpp_tree_groups_total",
                                "mpp_tree_joins_total",
                                "mpp_tree_emit_rows_total",
                                "mpp_tree_emit_slots_total")}
    phases = {}
    for tr in traces:
        for sp in _walk(tr.root):
            if sp.name == "mpp.rung":
                key = f"rung{(sp.attrs or {}).get('idx')}"
            elif sp.name == "mpp.tree.final":
                key = "final"
            else:
                continue
            phases.setdefault(key, []).append(sp.dur_ns / 1e6)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip() if args.device == "cuda" \
        else "cpu"
    from tidb_tpu_torch.mpp.engine import group_limit, group_slot_bytes

    # Q3's grouped final: three group keys, one sum (value and count)
    out = {"card": card, "seed": args.seed, "statements": n,
           "group_slot_bytes": group_slot_bytes(3, 2, 1),
           "group_limit": group_limit(3, 2, 1),
           "mismatched_values": bad, "moved": moved,
           "groups_per_stmt": moved["mpp_tree_groups_total"] / max(n, 1),
           "emit_fill_pct": 100.0 * moved["mpp_tree_emit_rows_total"]
           / max(moved["mpp_tree_emit_slots_total"], 1),
           "phase_ms_median": {k: statistics.median(v)
                               for k, v in sorted(phases.items())},
           "memory_peak_bytes": torch.cuda.max_memory_allocated()
           if args.device == "cuda" else None,
           "stmt_ms_median": statistics.median(ms), "stmt_ms_max": max(ms),
           "explain": explain}
    print(json.dumps(out))
    return 0 if bad == 0 and not any(moved[k] for k in STEADY) else 1


def _walk(span):
    yield span
    for c in span.children:
        yield from _walk(c)


if __name__ == "__main__":
    sys.exit(main())

"""Sets of runs of one cell, for the spread a bound is set from.

    python3 benchmark/spread.py --workload <name> --seeds 11,12,13 \
        --seconds 20 [--trace 0] [--sets 2] [--out DIR, default build/spread]

Runs `benchmark/run.py` once per seed and set, one run at a time, keeps
each run's result line and standard error in DIR, and prints per metric
and set the median and the spread: the distance between the first and
third quartiles (`statistics.quantiles(values, n=4)`) over the median."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def spread(values: list) -> float:
    q1, _q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark/spread.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--out", default="build/spread")
    args = ap.parse_args(argv)
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    for k in range(args.sets):
        for seed in seeds:
            tag = f"{args.workload}.t{args.trace}.set{k}.{seed}"
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "benchmark/run.py", "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 str(args.seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True, timeout=1200)
            wall = time.perf_counter() - t0
            (out / f"{tag}.err").write_text(p.stderr)
            lines = p.stdout.strip().splitlines()
            res = None
            if p.returncode == 0 and lines:
                res = json.loads(lines[-1])
            runs.append({"set": k, "seed": seed, "rc": p.returncode,
                         "wall_s": wall, "result": res})
            with open(out / f"{args.workload}.t{args.trace}.jsonl", "a") as f:
                f.write(json.dumps(runs[-1]) + "\n")
            print(f"{tag}: rc {p.returncode}, wall {wall:.1f} s, "
                  + (json.dumps({"correct": res["correct"],
                                 "attempted": res["attempted"],
                                 "failed": res["failed"],
                                 **{m: v["value"] for m, v in
                                    res["metrics"].items()},
                                 "checks": {c: v["value"] for c, v in
                                            res["checks"].items()}})
                     if res else p.stderr[-3000:]), flush=True)
    names = sorted({m for r in runs if r["result"]
                    for m in r["result"]["metrics"]})
    for k in range(args.sets):
        for m in names:
            vals = [r["result"]["metrics"][m]["value"] for r in runs
                    if r["set"] == k and r["result"]
                    and m in r["result"]["metrics"]]
            if len(vals) >= 2:
                print(f"set {k} {m}: n {len(vals)}, median "
                      f"{statistics.median(vals)!r}, spread "
                      f"{spread(vals)!r}, values {vals!r}", flush=True)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())

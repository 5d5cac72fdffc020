"""K3 (`copr/cuda.dense_agg`) on one card: build, check, time.

    python3 tools/dense_agg_card.py

Builds the kernel's source alone from cold (its nvcc seconds, and
ptxas's registers and spills per kernel instance), holds it against
its plain version (the composition of ops/segment.py's masked sums and
counts, one per group and operand, that it replaced) at the benchmark
cell's dispatch shape, then times the two in turns, each the median of
25 CUDA-event timings with the 50 MB L2 flushed before each.  Shapes:
one Q1 dispatch of `sf10_q1q6_s3` (20 M rows, 6 groups, 7 operands),
one Q6 dispatch (1 operand, one group, so no group code is read), and
Q1's operands over 32 groups.  The bound is the bytes the kernel must
read at 3.35 TB/s.  Prints one JSON line and writes it to
chiprun_out/dense_agg_card.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

HBM_BYTES_PER_S = 3.35e12
ROWS = 20_000_000


def card() -> dict:
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": out.stdout.strip(), "torch": torch.__version__,
            "cuda": torch.version.cuda}


def time_turns(fns: dict, flush, reps: int = 25) -> dict:
    """Median ms of each function, run in turns (order reversed every
    other round), the L2 flushed before each run.  A spin of ~0.3 ms
    queued ahead of the start event keeps the host's launch overhead
    out of the interval."""
    import torch

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    order = list(fns)
    for rep in range(reps):
        for k in (order if rep % 2 == 0 else order[::-1]):
            flush.zero_()
            torch.cuda._sleep(500_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[k]()
            b.record()
            b.synchronize()
            times[k].append(a.elapsed_time(b))
    return {k: statistics.median(v) for k, v in times.items()}


def main() -> int:
    import torch

    from tidb_tpu_torch import ops
    from tidb_tpu_torch.copr.cuda import (build_all, dense_agg,
                                          dense_agg_plain, ptxas_report)

    if not torch.cuda.is_available():
        print("dense_agg_card: no CUDA device", file=sys.stderr)
        return 2
    ops.use_device("cuda")
    res = {"card": card()}
    t0 = time.perf_counter()
    res["build_s"] = build_all(["dense_agg"])["dense_agg"]
    res["build_wall_s"] = time.perf_counter() - t0
    res["ptxas"] = [{"kernel": k, "registers": r, "spill_stores": st,
                     "spill_loads": ld}
                    for k, r, st, ld in ptxas_report("dense_agg")]
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    shapes = [("q1", 7, 6), ("q6", 1, 1), ("q1_g32", 7, 32)]
    res["shapes"] = []
    for tag, K, G in shapes:
        gidx = torch.randint(0, G, (ROWS,), device=dev, generator=gen)
        mask = torch.rand(ROWS, device=dev, generator=gen) < 0.97
        values = [torch.randint(-(1 << 40), 1 << 40, (ROWS,), device=dev,
                                generator=gen) for _ in range(K)]
        valids = [torch.rand(ROWS, device=dev, generator=gen) < 0.999
                  for _ in range(K)]
        args = (gidx, mask, values, valids, G)
        got = dense_agg(*args)
        exact = bool(torch.equal(got, dense_agg_plain(*args)))
        t = time_turns({"ms": lambda: dense_agg(*args),
                        "plain_ms": lambda: dense_agg_plain(*args)}, flush)
        nbytes = ROWS * ((8 if G > 1 else 0) + 1 + 9 * K)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"shape": tag, "n": ROWS, "K": K, "G": G, "exact": exact,
               "bytes": nbytes, "bound_ms": bound, **t,
               "pct_of_bound": 100.0 * bound / t["ms"]}
        res["shapes"].append(row)
        print(json.dumps(row), flush=True)
        del gidx, mask, values, valids, got, args
        torch.cuda.empty_cache()
    res["ok"] = all(r["exact"] for r in res["shapes"])
    line = json.dumps(res)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "dense_agg_card.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

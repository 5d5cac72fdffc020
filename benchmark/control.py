"""The control of the check that decides `correct`: the plain reference
in the program's place, computed in the precision below the one the
configuration states (decimals as doubles where it states exact
decimals), held to the exact reference the way a run holds the
program's answers.  A sound check reads it as not correct.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \
        [--device cuda] [--scale SF] [--statements 64]

At the cell's own sizes by default: the configuration's tables from each
seed, the distinct statements among the first `--statements` of each
stream the run would send.  Prints one JSON line a seed with the
control's `mismatched_values` beside the limit.  The benchmark's own
runs never run it."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_reading(cell, seed: int, device: str, scale: float,
                    statements: int) -> dict:
    """The control's `mismatched_values` for one seed."""
    import torch

    from benchmark import harness, traffic

    config = cell.config
    gen = harness.load_module(harness.HERE / "generators"
                              / f"{config['generator']}.py")
    made = gen.generate(scale, traffic.seed_for(seed, config["seed_salt"]),
                        [t["name"] for t in config["tables"]], device)
    tables = {name: {c: torch.from_numpy(a).to(device)
                     for c, a in zip(gen.COLUMNS[name], arrays)}
              for name, (arrays, _d) in made.items()}
    streams = traffic.streams(cell.workload, cell.shapes, seed, statements)
    distinct = {sql: (shape, p) for st in streams for shape, sql, p in st}
    bad = 0
    t0 = time.perf_counter()
    for sql, (shape, p) in distinct.items():
        ref = cell.shapes[shape]["module"].reference
        bad += harness.compare(ref(tables, p, exact=False), ref(tables, p),
                               cell.shapes[shape]["ordered"])
    return {"workload": cell.name, "seed": seed, "device": device,
            "scale": scale, "statements": len(distinct),
            "mismatched_values": bad, "limit": 0,
            "correct": bad == 0, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--statements", type=int, default=64)
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != ROOT / "benchmark"]
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    scale = cell.config["scale_factor"] if args.scale is None else args.scale
    for s in args.seeds.split(","):
        print(json.dumps(control_reading(cell, int(s), args.device, scale,
                                         args.statements)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

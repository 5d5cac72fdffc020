"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Set-up (`setup_s`) runs from here to the
end of the warm-up: the port on the card, the configuration's tables
generated from the seed and bulk-loaded, the port's MySQL wire server on
a free loopback port, the cell's statement shapes warmed up.  Then a
child process drives the cell's closed-loop streams over the wire for
`--seconds`, every distinct answer is held against the plain reference,
and the last line of standard output is the result:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics, read from a torch.profiler trace of the window and
the program's own statement traces.  Each number the check compares is
printed beside its limit as the last lines of standard error and under
`checks`.  Exits non-zero with no result without a CUDA card, without
the port in the checkout, or when a module of the JAX stack or the JAX
package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: build and kernel caches at fixed paths inside the checkout, so only a
#: checkout's first run builds (the port's own kernels go to build/kernels)
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton",
          "CUDA_CACHE_PATH": "build/cuda_cache"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(ROOT / v)
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve() != ROOT / "benchmark"]
    import torch

    from benchmark import harness

    chips = next((w.get("chips", 1) for w in
                  json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import tidb_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the port is not in this checkout: {e}",
              file=sys.stderr)
        return 3
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), T_START)
    except harness.ForbiddenImport as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:  # a failed run prints its traceback, no result
        import traceback

        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # the port's daemon threads (prefetch, server pool) need no join
    os._exit(code)

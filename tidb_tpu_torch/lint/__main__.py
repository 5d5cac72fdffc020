"""CLI: python -m tidb_tpu_torch.lint [--passes purity,plan,kernel,...]
[--json] [--update-baseline] [--device cuda|cpu]

Exit code 0 iff every finding is covered by the checked-in baseline
allowlist.  The AST families (purity, concur, metric, chaos) and the
plan family need no device.  The kernel family runs its programs on the
card unless `--device cpu` asks for the host: without a card and without
`--device cpu` it exits 2 with a message naming the missing device, and
never carries on on the CPU.  `--update-baseline` rewrites only the
kernel stats of the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ALL_PASSES = "purity,plan,kernel,metric,concur,chaos"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tidb_tpu_torch.lint")
    ap.add_argument("--passes", default=ALL_PASSES,
                    help="comma list of pass families to run")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--update-baseline", action="store_true",
                    help="refresh the kernel-contract stats of --device "
                         "in baseline.json")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the kernel family runs (default: the card)")
    args = ap.parse_args(argv)
    passes = [p.strip() for p in args.passes.split(",") if p.strip()]
    kernels = "kernel" in passes or args.update_baseline

    if args.device == "cpu":
        # small tiles on the host, as the CPU tests run (read when the
        # engine is first imported)
        os.environ.setdefault("TIDB_TPU_TILE", "1024")
    import torch

    if kernels and args.device == "cuda" and not torch.cuda.is_available():
        print("python -m tidb_tpu_torch.lint: the kernel family runs on "
              "the card, and no CUDA device is present; pass --device cpu "
              "to run it on the host", file=sys.stderr)
        return 2
    from .. import ops

    ops.use_device(args.device)
    from . import PASS_RULES, assign_ordinals, run_all
    from .baseline import apply, load_baseline, save_baseline

    ran_rules = set()
    for p in passes:
        ran_rules.update(PASS_RULES.get(p, ()))
    if args.update_baseline:
        ran_rules.update(PASS_RULES["kernel"])  # kernels run regardless

    baseline = load_baseline()
    if args.update_baseline:
        from .kernelcheck import lint_kernels

        stats: dict = {}
        # one kernel run collects the fresh stats AND reports
        # baseline-independent contract breaks (failed programs,
        # divergences, recompiles)
        findings = lint_kernels(collect_stats=stats, device=args.device)
        baseline.setdefault("kernels", {})[args.device] = stats
        save_baseline(baseline)
        # stderr: --json promises machine-readable stdout
        print(f"baseline kernels ({args.device}) refreshed: "
              f"{json.dumps(stats)}", file=sys.stderr)
        rest = [p for p in passes if p != "kernel"]
        if rest:  # run_all treats an empty list as "all families"
            findings += run_all(passes=rest, device=args.device)
        findings = assign_ordinals(findings)
    else:
        findings = run_all(passes=passes, device=args.device)
    new, stale = apply(findings, baseline, ran_rules=ran_rules)

    if args.json:
        print(json.dumps({
            "findings": [vars(f) for f in new],
            "stale_baseline": stale,
            "allowlisted": len(findings) - len(new),
            "device": args.device,
        }))
    else:
        for f in new:
            print(f.render())
        for k in stale:
            print(f"stale baseline entry (site fixed? remove it): {k}")
        print(f"tidb_tpu_torch.lint: {len(new)} new finding(s), "
              f"{len(findings) - len(new)} allowlisted, "
              f"{len(stale)} stale baseline entr(ies); passes "
              f"{','.join(passes)}; kernel device {args.device}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())

"""Baseline allowlist: findings on today's tree, each with a one-line
justification.

Workflow (README, the port's static analysis):

* `python -m tidb_tpu_torch.lint` fails on any finding whose key is not in
  ``baseline.json`` — new hazards never land silently.
* Fixing a site makes its baseline entry STALE; the runner reports stale
  entries so the allowlist only shrinks deliberately (it never fails the
  build on its own, so a fix is never punished).
* `--update-baseline` rewrites the kernel-contract stats of the device
  that ran (``"kernels": {"cpu": {...}, "cuda": {...}}``: the port runs
  different programs on the two devices, K1/K2 launches on the card and
  their plain versions on the CPU) from the current tree; the allowlist
  is hand-maintained on purpose — every allowlisted host-sync needs a
  human-written justification.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

from . import Finding

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


def kernel_stats(baseline: dict, device: str) -> dict:
    """The kernel-contract stats section of one device kind."""
    return baseline.get("kernels", {}).get(device, {})


def load_baseline(path: str = BASELINE_PATH) -> dict:
    if not os.path.exists(path):
        return {"allow": {}, "kernels": {}}
    with open(path, "r", encoding="utf-8") as f:
        b = json.load(f)
    b.setdefault("allow", {})
    b.setdefault("kernels", {})
    return b


def save_baseline(b: dict, path: str = BASELINE_PATH):
    with open(path, "w", encoding="utf-8") as f:
        json.dump(b, f, indent=1, sort_keys=True)
        f.write("\n")


def apply(findings: List[Finding], baseline: dict,
          ran_rules=None) -> Tuple[List[Finding], List[str]]:
    """(new findings not allowlisted, stale allowlist keys).

    ran_rules, when given, limits staleness to entries whose rule was
    actually checked this run — a `--passes plan` run must not report
    every purity entry stale and bait the operator into deleting
    still-needed allowlist entries."""
    allow: Dict[str, str] = baseline.get("allow", {})
    hit = set()
    new: List[Finding] = []
    for f in findings:
        if f.key in allow:
            hit.add(f.key)
        else:
            new.append(f)
    stale = sorted(
        k for k in allow
        if k not in hit
        and (ran_rules is None or k.split(":", 1)[0] in ran_rules))
    return new, stale

"""tidb_tpu_torch.lint — the port's own static analysis.

The same six pass families as the JAX package's `tidb_tpu.lint`, with
its rule names, finding keys (`rule:path:scope:token#ordinal`) and CLI
flags, over `tidb_tpu_torch/`:

1. purity    — AST hot-path lint over the engine directories in PyTorch
               terms: host syncs (`.item()`, `.tolist()`, `.cpu()`,
               `.numpy()`, `.to("cpu")`, `torch.cuda.synchronize`,
               `np.asarray`), Python row loops over chunk data, and
               inside program bodies int()/float()/bool() coercions,
               host clocks and host RNG; unhashable program-cache keys.
2. plancheck — a `vet` for physical plans (schema/dtype propagation, the
               device-executable registry); also wired into plan build
               time behind `tidb_check_plan`.
3. kernelcheck — runs every canonical device program once on canonical
               TILE-shaped inputs on the chosen device under an aten op
               recorder (plus the K1/K2 launch counters): contract
               breaks, operand-value divergence, recompile bombs
               (ProgramCache growth, nvcc builds) and int64-op growth
               against the baseline of the device that ran.
4. metricnames, 5. concur (lock ranks, order, blocking, guards, waits),
6. chaoscover (every failpoint armed by a port test).

Findings on today's tree are either fixed or recorded in
``baseline.json`` with a one-line justification; `python -m
tidb_tpu_torch.lint` exits non-zero on anything new.  The AST families
need no device; the kernel family runs on the card unless the caller
asks for the CPU.
"""


from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Finding:
    """One lint finding with a line-number-stable identity.

    ``key`` intentionally omits the line number: baselines must survive
    unrelated edits to the same file.  Identity is (rule, file, enclosing
    scope, flagged token, ordinal within that scope).
    """

    rule: str          # e.g. "host-sync", "plan-schema", "kernel-contract"
    path: str          # repo-relative path
    line: int
    scope: str         # qualified enclosing function/class ("" = module)
    token: str         # the flagged call/op text, e.g. "np.asarray"
    message: str
    ordinal: int = 0   # nth identical (rule, path, scope, token) hit

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.scope}:{self.token}#{self.ordinal}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.message}"
                f"  (key: {self.key})")


class LintError(Exception):
    """Raised by check entry points when findings must abort the caller
    (the plan-build-time hook raises through PlanError instead)."""

    def __init__(self, findings: List[Finding]):
        self.findings = findings
        super().__init__(
            "; ".join(f.render() for f in findings[:8])
            + (f" ... and {len(findings) - 8} more" if len(findings) > 8
               else ""))


def assign_ordinals(findings: List[Finding]) -> List[Finding]:
    """Stamp per-(rule, path, scope, token) ordinals in line order so keys
    are unique and stable under line drift."""
    seen: dict = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line)):
        k = (f.rule, f.path, f.scope, f.token)
        f.ordinal = seen.get(k, 0)
        seen[k] = f.ordinal + 1
    return findings


#: finding rules each pass family can emit — staleness of a baseline
#: entry is only decidable when its family actually ran
PASS_RULES = {
    "purity": ("host-sync", "tracer-coercion", "row-loop", "time-in-jit",
               "rng-in-jit", "static-unhashable"),
    "plan": ("plan-schema",),
    "kernel": ("kernel-contract",),
    "metric": ("metric-name",),
    "concur": ("lock-rank", "lock-order", "lock-blocking", "lock-guard",
               "lock-wait"),
    "chaos": ("chaos-cover",),
}


def run_all(repo_root: Optional[str] = None,
            passes: Optional[List[str]] = None,
            device: str = "cuda") -> List[Finding]:
    """Run the requested pass families (default: all six) and return
    raw findings — baseline filtering is the caller's job
    (see baseline.apply).  `device` is where the kernel family runs
    ("cuda" or "cpu")."""
    import os

    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    passes = passes or ["purity", "plan", "kernel", "metric", "concur",
                        "chaos"]
    findings: List[Finding] = []
    if "purity" in passes:
        from .purity import lint_tree

        findings += lint_tree(repo_root)
    if "concur" in passes:
        from .concur import lint_tree as lint_concur

        findings += lint_concur(repo_root)
    if "chaos" in passes:
        from .chaoscover import lint_tree as lint_chaos_cover

        findings += lint_chaos_cover(repo_root)
    if "metric" in passes:
        from .metricnames import lint_tree as lint_metric_names

        findings += lint_metric_names(repo_root)
    if "plan" in passes:
        from .plancheck import lint_canonical_plans

        findings += lint_canonical_plans()
    if "kernel" in passes:
        from .kernelcheck import lint_kernels

        findings += lint_kernels(device=device)
    return assign_ordinals(findings)

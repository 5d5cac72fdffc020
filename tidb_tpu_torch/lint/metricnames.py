"""Metric-naming static pass.

Every literal metric name passed to ``REGISTRY.inc / observe /
observe_hist / set`` must match ``[a-z0-9_]+`` and carry a conventional
suffix so the registry stays machine-readable: counters end ``_total``,
distributions end in a unit (``_ms/_us/_seconds/_bytes/_rows``), gauges
in a unit or count form.  The fleet merge (metrics.merge_fleet) RELIES
on the ``_total`` convention to decide sum-vs-per-host semantics, so a
misnamed counter silently becomes a gauge — exactly the class of bug a
static pass catches and a runtime test cannot.

f-strings are checked on their constant fragments: the charset rule
applies to every literal part, the suffix rule only when the name's
TAIL is literal (``f"slo_{cls}_breach_total"`` checks; a fully dynamic
tail is skipped — the call site owns the convention there).

It walks `tidb_tpu_torch/`.  The port keeps the JAX package's metric
names, so its metrics read like the reference's; the names that break
the convention there (`coord_epoch`, `gc_safe_point`,
`serving_batch_size`) are allowlisted with the same reasons.
"""

from __future__ import annotations

import ast
import os
import re
from typing import List, Optional

from . import Finding

RULE = "metric-name"

_NAME_RE = re.compile(r"\A[a-z0-9_]+\Z")

#: method -> acceptable name suffixes
SUFFIXES = {
    "inc": ("_total",),
    "observe": ("_ms", "_us", "_seconds", "_bytes", "_rows"),
    "observe_hist": ("_ms", "_us", "_seconds", "_bytes", "_rows"),
    "set": ("_total", "_ms", "_us", "_seconds", "_bytes", "_rows",
            "_depth", "_count", "_ratio"),
}


def _is_registry(node: ast.AST) -> bool:
    """True for `REGISTRY.<m>(...)` and `<mod>.REGISTRY.<m>(...)`."""
    if isinstance(node, ast.Name):
        return node.id == "REGISTRY"
    if isinstance(node, ast.Attribute):
        return node.attr == "REGISTRY"
    return False


def _literal_parts(arg: ast.AST):
    """(normalized_name, tail_is_literal) for a Constant-str or
    JoinedStr first argument; None for non-literal names (a variable —
    the convention is the producer's job there)."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value, True
    if isinstance(arg, ast.JoinedStr):
        parts = []
        for v in arg.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                parts.append(v.value)
            else:
                # placeholder: charset-neutral stand-in
                parts.append("x")
        tail = arg.values[-1] if arg.values else None
        tail_lit = isinstance(tail, ast.Constant) \
            and isinstance(tail.value, str)
        return "".join(parts), tail_lit
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.scope: List[str] = []
        self.findings: List[Finding] = []

    def _qual(self) -> str:
        return ".".join(self.scope)

    def visit_FunctionDef(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def visit_Call(self, node: ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in SUFFIXES \
                and _is_registry(f.value) and node.args:
            got = _literal_parts(node.args[0])
            if got is not None:
                name, tail_lit = got
                if not _NAME_RE.match(name):
                    self.findings.append(Finding(
                        RULE, self.path, node.lineno, self._qual(), name,
                        f"metric name {name!r} must match [a-z0-9_]+"))
                elif tail_lit and not name.endswith(SUFFIXES[f.attr]):
                    want = "|".join(SUFFIXES[f.attr])
                    self.findings.append(Finding(
                        RULE, self.path, node.lineno, self._qual(), name,
                        f"metric {name!r} passed to REGISTRY.{f.attr} "
                        f"lacks a conventional suffix ({want})"))
        self.generic_visit(node)


def lint_source(src: str, path: str) -> List[Finding]:
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return []
    v = _Visitor(path)
    v.visit(tree)
    return v.findings


def lint_tree(repo_root: Optional[str] = None) -> List[Finding]:
    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    pkg = os.path.join(repo_root, "tidb_tpu_torch")
    findings: List[Finding] = []
    for dirpath, _dirs, files in os.walk(pkg):
        if "__pycache__" in dirpath:
            continue
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, repo_root)
            try:
                with open(full, "r", encoding="utf-8") as f:
                    src = f.read()
            except OSError:
                continue
            findings += lint_source(src, rel)
    return findings

"""Chaos-site coverage lint: every failpoint a test can arm must be one
a test DOES arm.

The reference TiDB gates gofail sites through CI jobs that sweep them;
a failpoint nobody injects is dead chaos surface — the recovery path
behind it ships unexercised, which is exactly the bug class failpoints
exist to prevent.  This pass:

1. AST-walks ``tidb_tpu_torch/`` for every ``FAILPOINTS.hit(<name>, ...)``
   call site, resolving the name argument through string literals and
   module-level ``NAME = "..."`` constants (including constants
   imported from another module — the cold tier's
   ``DECOMPRESS_FAILPOINT`` pattern);
2. text-scans the port's tests (``tests/test_torch_*.py`` and
   ``tests/torch_*_worker.py``) for each resolved site name — a JAX
   package test that names a failpoint exercises that package's site,
   not the port's;
3. emits a ``chaos-cover`` finding per site name that no test mentions.

A name the walker cannot resolve statically (a computed f-string) is
itself a finding: a chaos site must be greppable or it cannot be
audited.  Pre-existing uncovered sites, if any, live in baseline.json
like every other debt.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Tuple

from . import Finding

RULE_COVER = "chaos-cover"


def _module_constants(tree: ast.Module) -> Dict[str, str]:
    """Module-level NAME = "string" assignments."""
    out: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str):
            out[node.targets[0].id] = node.value.value
    return out


def _port_test(fn: str) -> bool:
    """A test file of the port: tests/test_torch_*.py or one of its
    worker scripts, tests/torch_*_worker.py."""
    return fn.endswith(".py") and (
        fn.startswith("test_torch_")
        or (fn.startswith("torch_") and fn.endswith("_worker.py")))


def _hit_sites(tree: ast.Module, relpath: str, consts: Dict[str, str],
               global_consts: Dict[str, str]
               ) -> List[Tuple[Optional[str], str, int]]:
    """(resolved name | None, raw token, line) per FAILPOINTS.hit call."""
    out: List[Tuple[Optional[str], str, int]] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr != "hit" \
                or not isinstance(node.func.value, ast.Name) \
                or node.func.value.id != "FAILPOINTS" \
                or not node.args:
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            out.append((arg.value, arg.value, node.lineno))
        elif isinstance(arg, ast.Name):
            name = consts.get(arg.id, global_consts.get(arg.id))
            out.append((name, arg.id, node.lineno))
        else:
            out.append((None, ast.dump(arg)[:40], node.lineno))
    return out


def lint_tree(repo_root: Optional[str] = None) -> List[Finding]:
    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    pkg = os.path.join(repo_root, "tidb_tpu_torch")
    parsed: List[Tuple[str, ast.Module, Dict[str, str]]] = []
    global_consts: Dict[str, str] = {}
    for dirpath, _dirs, files in os.walk(pkg):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, repo_root)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    tree = ast.parse(f.read())
            except SyntaxError:
                continue
            consts = _module_constants(tree)
            parsed.append((rel, tree, consts))
            # cross-module constant fallback: failpoint name constants
            # follow the *_FAILPOINT convention and are globally unique
            for k, v in consts.items():
                if k.endswith("FAILPOINT"):
                    global_consts.setdefault(k, v)

    # site name -> first (path, token, line); unresolvable args flag
    sites: Dict[str, Tuple[str, str, int]] = {}
    out: List[Finding] = []
    for rel, tree, consts in parsed:
        for name, token, line in _hit_sites(tree, rel, consts,
                                            global_consts):
            if name is None:
                out.append(Finding(
                    RULE_COVER, rel, line, "", token,
                    f"FAILPOINTS.hit name {token!r} is not statically "
                    f"resolvable: chaos sites must be greppable string "
                    f"literals or module-level constants"))
            elif name not in sites:
                sites[name] = (rel, token, line)

    tests_dir = os.path.join(repo_root, "tests")
    corpus: List[str] = []
    if os.path.isdir(tests_dir):
        for dirpath, _dirs, files in os.walk(tests_dir):
            for fn in sorted(files):
                if _port_test(fn):
                    try:
                        with open(os.path.join(dirpath, fn), "r",
                                  encoding="utf-8") as f:
                            corpus.append(f.read())
                    except OSError:
                        continue

    for name in sorted(sites):
        if any(name in src for src in corpus):
            continue
        rel, _token, line = sites[name]
        out.append(Finding(
            RULE_COVER, rel, line, "", name,
            f"failpoint {name!r} is armed by no port test under tests/: "
            f"the recovery path behind it ships unexercised"))
    return out

"""Hot-path purity lint: AST pass over the engine directories.

"Query Processing on Tensor Computation Runtimes" (PAPERS.md) makes the
case that the hot path must stay on the device; every host sync (a
tensor read back to the host, a device-wide synchronize) or Python row
loop is a stall that turns a multi-GB/s scan into a per-row interpreter
crawl.  These hazards are syntactically recognizable, so they are
linted — sites that are genuinely host boundaries (the readback of a
finished program's result) live in baseline.json with a justification.

A "program" in the port is what the JAX package jits: a callable that a
`ProgramCache` stores and the function its builder returns
(`PROGRAM_BUILDERS`: `parallel._build_mesh_core` and its sort-agg core,
`torch_engine._tile_core` / `_build_tile_fn`, `mpp/engine._build_mpp_fn`,
`mpp/jointree`'s rung and final builders, and the canonical programs
of `mpp/exchange`, all module-level functions).  Every function defined
inside a builder is a program body.

Rules
-----
host-sync        `.item()`, `.tolist()`, `.cpu()`, `.numpy()` (the last
                 two unless they read what a `.cpu()` just copied),
                 `.to("cpu")` method calls, `torch.cuda.synchronize()`
                 and `np.asarray` / `numpy.asarray` calls in engine
                 code, and the size reads `torch.nonzero` /
                 `torch.bincount` (their output size depends on the
                 data, so the host waits for the device before it can
                 allocate) — gated on device-tensor PROVENANCE: (a) a
                 module that never imports torch cannot hold a device
                 tensor (they are only created by torch APIs, and the
                 engine contract keeps Chunk columns numpy), so nothing
                 there syncs;
                 (b) a read of the direct result of a program-bound
                 callable (``out = fn(...)`` with ``fn`` from a builder
                 or a ProgramCache, then ``out.cpu()`` /
                 ``np.asarray(out)``) is the DESIGNED readback boundary:
                 the program completed, the sync is its one intended
                 result transfer; (c) a tensor made on the host
                 (`torch.zeros/ones/empty/full/arange/tensor/from_numpy`
                 without a device) reads host memory.
tracer-coercion  float()/int()/bool() on a value inside a program body:
                 on a tensor it is a hidden device sync (the launch
                 queue drains before the host gets its number).
row-loop         for-loops / comprehensions iterating chunk rows
                 (`.to_pylist()`, `.iter_rows()`, `range(.. .num_rows ..)`)
                 — per-row Python in engine code.
time-in-jit      time.time()/perf_counter()/datetime.now() inside a
                 program body: launches are asynchronous, so a host clock
                 there times the enqueue, not the device work, and a
                 program whose result depends on it is not a function of
                 its operands.
rng-in-jit       `random.*` / `np.random.*` inside a program body: host
                 RNG makes a program's output differ between runs and
                 between the processes of one SPMD statement, so equal
                 inputs no longer give equal rows.
static-unhashable  a ProgramCache fingerprint (`cache.get(key)` /
                 `cache.put(key, fn)` on a name bound to
                 `ProgramCache(...)`) given a list/dict/set literal:
                 unhashable -> TypeError at the first dispatch.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Set

from . import Finding

ENGINE_DIRS = ("tidb_tpu_torch/coord", "tidb_tpu_torch/copr",
               "tidb_tpu_torch/executor", "tidb_tpu_torch/expr",
               "tidb_tpu_torch/layout", "tidb_tpu_torch/lifecycle",
               "tidb_tpu_torch/mpp", "tidb_tpu_torch/ops",
               "tidb_tpu_torch/planner", "tidb_tpu_torch/serving")

HOST_SYNC_DOTTED = {"np.asarray", "numpy.asarray", "torch.cuda.synchronize"}
#: calls whose output size depends on the data: a hidden readback
SIZE_READS = {"torch.nonzero", "torch.bincount"}
#: constructors whose tensor lies on the host unless given a device
HOST_CTORS = {"torch.zeros", "torch.ones", "torch.empty", "torch.full",
              "torch.arange", "torch.tensor", "torch.from_numpy"}
HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
TRACER_COERCIONS = {"float", "int", "bool"}
TIME_DOTTED = {"time.time", "time.perf_counter", "time.monotonic",
               "datetime.now", "datetime.datetime.now"}
ROW_ITER_METHODS = {"to_pylist", "iter_rows"}
ROW_COUNT_ATTRS = {"num_rows"}
#: functions that build (and return) a device program: every function
#: defined inside one is a program body, and a name bound from calling
#: one is a program callable
PROGRAM_BUILDERS = {"_build_mesh_core", "_build_sort_agg_core",
                    "_tile_core", "_build_tile_fn", "_build_mpp_fn",
                    "_build_rung_fn", "_build_emit_fn", "_build_final_fn",
                    "_canonical_join_fn", "_canonical_tree_fn",
                    "_canonical_grouped_fn"}
#: the class whose instances store programs by fingerprint
PROGRAM_CACHE = "ProgramCache"


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _imports_torch(tree: ast.Module) -> bool:
    """True when the module imports torch in any form.  Device tensors
    are created only by torch APIs; a module that never names torch can
    only hold host values, so host-sync hazards cannot occur there."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name == "torch" or a.name.startswith("torch.")
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "torch" or mod.startswith("torch."):
                return True
    return False


def _program_caches(tree: ast.Module) -> Set[str]:
    """Module-level names bound to `ProgramCache(...)`."""
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _dotted(node.value.func) in (PROGRAM_CACHE,
                                                 f"cache.{PROGRAM_CACHE}"):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return out


def _program_sources(tree: ast.Module) -> Set[str]:
    """Dotted callables whose result is a program callable: the builders
    and `<cache>.get` of the module's ProgramCaches."""
    return PROGRAM_BUILDERS | {f"{c}.get" for c in _program_caches(tree)}


_SCOPE_STOPS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def _targets(tgt) -> List[str]:
    if isinstance(tgt, ast.Name):
        return [tgt.id]
    if isinstance(tgt, (ast.Tuple, ast.List)):
        return [n for e in tgt.elts for n in _targets(e)]
    return []


def _scan_boundary(node, visible: Set[str], sources: Set[str]) -> Set[str]:
    """Readback-boundary names bound in ONE scope's immediate body
    (nested defs excluded — they compute their own set with this one
    visible, matching closure capture): names bound to program callables
    (`fn = _COMPILED.get(fp)`, `core = _build_mesh_core(...)`), names
    assigned from calling one (`out = fn(...)`, `gcount, res = fn(...)`)
    — the finished program's output, whose readback is the designed
    boundary — and names bound to a host tensor (`_host_ctor`).  Scoped
    per function so an unrelated `out` elsewhere is never whitelisted."""
    out: Set[str] = set()

    def walk(n):
        for child in ast.iter_child_nodes(n):
            if isinstance(child, _SCOPE_STOPS):
                continue
            if isinstance(child, ast.Assign) \
                    and isinstance(child.value, ast.Call):
                d = _dotted(child.value.func)
                if d in sources or d in visible or d in out \
                        or _host_ctor(child.value):
                    for tgt in child.targets:
                        out.update(_targets(tgt))
            walk(child)

    walk(node)
    return out


def _host_ctor(call: ast.Call) -> bool:
    """A torch constructor that makes its tensor on the host: no
    `device` keyword (pinned host memory is still host memory)."""
    return _dotted(call.func) in HOST_CTORS and not any(
        k.arg == "device" for k in call.keywords)


def _program_bodies(tree: ast.Module) -> list:
    """The FunctionDef nodes that are program bodies: every function
    defined (at any depth) inside a module-level program builder."""
    out = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in PROGRAM_BUILDERS:
            out += [sub for sub in ast.walk(node) if sub is not node
                    and isinstance(sub, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
    return out


def _program_defs(tree: ast.Module) -> Set[int]:
    """ids of the program bodies' FunctionDef nodes."""
    return {id(n) for n in _program_bodies(tree)}


def _jitted_names(tree: ast.Module) -> Set[str]:
    """Names of the program bodies defined in this module (the JAX
    package's jitted functions; lint.concur flags calling one under a
    lock)."""
    return {n.name for n in _program_bodies(tree)}


def _is_cpu_copy(node: ast.AST) -> bool:
    """`x.cpu()` or `x.to("cpu")`: the call that moved a tensor to the
    host (a `.numpy()` of its result reads host memory)."""
    if not isinstance(node, ast.Call) \
            or not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr == "cpu":
        return True
    return node.func.attr == "to" and _to_cpu(node)


def _to_cpu(node: ast.Call) -> bool:
    """`.to("cpu")` / `.to(device="cpu")` / `.to(torch.device("cpu"))`."""
    args = list(node.args) + [k.value for k in node.keywords
                              if k.arg == "device"]
    for a in args[:1]:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if isinstance(a, ast.Call) and _dotted(a.func) == "torch.device" \
                and a.args and isinstance(a.args[0], ast.Constant) \
                and a.args[0].value == "cpu":
            return True
    return False


class _PurityVisitor(ast.NodeVisitor):
    def __init__(self, relpath: str, programs: Set[int],
                 sources: Set[str], has_torch: bool = True,
                 module_boundary: Optional[Set[str]] = None):
        self.relpath = relpath
        self.programs = programs
        self.sources = sources
        self.has_torch = has_torch  # module can hold device tensors at all
        # readback-boundary names, one set per lexical scope (closures
        # see enclosing scopes' names; siblings never see each other's)
        self.boundary_stack: List[Set[str]] = [module_boundary or set()]
        self.scope: List[str] = []
        self.jit_depth = 0  # >0 while inside a program body
        self.findings: List[Finding] = []

    # -- scope bookkeeping ------------------------------------------------
    def _visible_boundary(self) -> Set[str]:
        return set().union(*self.boundary_stack)

    def _enter(self, node, is_program: bool):
        self.scope.append(node.name)
        self.boundary_stack.append(
            _scan_boundary(node, self._visible_boundary(), self.sources))
        if is_program:
            self.jit_depth += 1
        self.generic_visit(node)
        if is_program:
            self.jit_depth -= 1
        self.boundary_stack.pop()
        self.scope.pop()

    def visit_FunctionDef(self, node):
        self._enter(node, id(node) in self.programs)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        self.scope.append(node.name)
        self.boundary_stack.append(set())
        self.generic_visit(node)
        self.boundary_stack.pop()
        self.scope.pop()

    def _emit(self, rule: str, node: ast.AST, token: str, message: str):
        self.findings.append(Finding(
            rule=rule, path=self.relpath, line=node.lineno,
            scope=".".join(self.scope), token=token, message=message))

    # -- rules ------------------------------------------------------------
    def _is_boundary(self, a: ast.AST) -> bool:
        """`a` is (an item or attribute of) the direct result of a
        program-bound callable: the designed readback once the program
        completed.  Names resolve through the lexical scope stack."""
        visible = self._visible_boundary()
        while isinstance(a, (ast.Subscript, ast.Attribute)):
            a = a.value
        if isinstance(a, ast.Call) and (_dotted(a.func) in visible
                                        or _host_ctor(a)):
            return True
        return isinstance(a, ast.Name) and a.id in visible

    def _host_sync(self, node: ast.Call, d: Optional[str]):
        if d in SIZE_READS:
            self._emit("host-sync", node, d,
                       f"{d}() sizes its output from the data: the host "
                       "waits for every queued launch to allocate it")
            return
        if d in HOST_SYNC_DOTTED:
            if d == "torch.cuda.synchronize" or not (
                    node.args and self._is_boundary(node.args[0])):
                self._emit("host-sync", node, d,
                           f"{d}() forces a device->host sync; the host "
                           "waits for every queued launch")
            return
        if not isinstance(node.func, ast.Attribute):
            return
        m = node.func.attr
        recv = node.func.value
        if m == "to":
            if not _to_cpu(node):
                return
            m = "to(cpu)"
        elif m not in HOST_SYNC_METHODS:
            return
        if m in ("numpy", "tolist") and _is_cpu_copy(recv):
            return  # the .cpu() it reads was the sync
        if self._is_boundary(recv):
            return
        self._emit("host-sync", node, f".{m}",
                   f".{m}() reads a tensor back to the host inside "
                   "engine code: the host waits for the device")

    def visit_Call(self, node: ast.Call):
        d = _dotted(node.func)
        if self.has_torch:
            self._host_sync(node, d)
        if self.jit_depth:
            if d in TRACER_COERCIONS and node.args:
                self._emit("tracer-coercion", node, f"{d}()",
                           f"{d}() on a value inside a program body: on "
                           "a tensor it is a hidden device sync")
            elif d in TIME_DOTTED:
                self._emit("time-in-jit", node, d,
                           f"{d}() inside a program body times the "
                           "enqueue, not the device work, and makes the "
                           "program depend on the host clock")
            elif d is not None and (d.startswith("np.random.")
                                    or d.startswith("numpy.random.")
                                    or d.startswith("random.")):
                self._emit("rng-in-jit", node, d,
                           f"{d}() inside a program body is host RNG: "
                           "equal operands no longer give equal rows")
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in ROW_ITER_METHODS):
            self._emit(
                "row-loop", node, f".{node.func.attr}",
                f".{node.func.attr}() materializes rows into Python "
                "objects in engine code — per-row interpreter work on "
                "the hot path; stay on column arrays")
        self.generic_visit(node)

    def visit_For(self, node: ast.For):
        self._check_row_iter(node, node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node):
        for gen in node.generators:
            self._check_row_iter(node, gen.iter)
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_SetComp = _visit_comp
    visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    def _check_row_iter(self, node, it: ast.AST):
        for sub in ast.walk(it):
            if (isinstance(sub, ast.Call)
                    and _dotted(sub.func) == "range"
                    and any(isinstance(a, ast.Attribute)
                            and a.attr in ROW_COUNT_ATTRS
                            for arg in sub.args
                            for a in ast.walk(arg))):
                self._emit(
                    "row-loop", node, "range(num_rows)",
                    "Python loop over per-row range(.num_rows) in "
                    "engine code; vectorize over column arrays")
                return


def _lint_cache_keys(tree: ast.Module, relpath: str,
                     findings: List[Finding]):
    """ProgramCache fingerprints given an unhashable list/dict/set
    literal: `get` raises TypeError at the first dispatch."""
    caches = _program_caches(tree)
    if not caches:
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in ("get", "put") or not node.args:
            continue
        name = _dotted(node.func.value)
        if name not in caches:
            continue
        if isinstance(node.args[0], (ast.List, ast.Dict, ast.Set)):
            findings.append(Finding(
                rule="static-unhashable", path=relpath, line=node.lineno,
                scope="", token=name,
                message=(f"{name}.{node.func.attr}() is a ProgramCache "
                         "fingerprint but gets an unhashable "
                         "list/dict/set literal — TypeError at the first "
                         "dispatch; pass a str or tuple")))


def lint_source(src: str, relpath: str) -> List[Finding]:
    """Lint one module's source text (also the negative-test entry)."""
    tree = ast.parse(src)
    sources = _program_sources(tree)
    visitor = _PurityVisitor(relpath, _program_defs(tree), sources,
                             has_torch=_imports_torch(tree),
                             module_boundary=_scan_boundary(
                                 tree, set(), sources))
    visitor.visit(tree)
    _lint_cache_keys(tree, relpath, visitor.findings)
    return visitor.findings


def lint_tree(repo_root: str,
              dirs: tuple = ENGINE_DIRS) -> List[Finding]:
    findings: List[Finding] = []
    for d in dirs:
        absdir = os.path.join(repo_root, d)
        if not os.path.isdir(absdir):
            continue
        for base, _subdirs, files in sorted(os.walk(absdir)):
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                p = os.path.join(base, fn)
                rel = os.path.relpath(p, repo_root)
                with open(p, "r", encoding="utf-8") as f:
                    findings += lint_source(f.read(), rel)
    return findings

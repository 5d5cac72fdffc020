"""Concurrency lint: static deadlock/race analysis over the port.

The reference TiDB leans on Go's race detector and deadlock-prone-path
review; this reproduction machine-checks the same invariants from the
AST.  Four rules over the whole tree:

lock-rank      every ``threading.Lock/RLock/Condition`` construction
               must go through ``util_concurrency.make_lock`` /
               ``make_rlock`` with a name literal that (a) matches the
               construction site (``module:Owner.attr``) and (b) has a
               declared rank in :data:`LOCK_RANKS`.
lock-order     the acquires-while-holding digraph.  For every ``with
               <lock>:`` body, nested acquisitions and one-level call
               resolution (same module, plus cross-module via imports
               and :data:`KNOWN_INSTANCES`; same-class ``*_locked``
               helpers are inlined recursively) yield edges; any edge
               whose ranks do not STRICTLY increase — or any cycle —
               fails.  Ranks are global: two locks may nest in one
               order only, everywhere.
lock-blocking  no ``time.sleep``, socket/file I/O, ``subprocess``,
               thread ``.join()``/``.wait()``, or a device program's
               call (`purity._jitted_names`) inside a lock body (a
               device dispatch, an nvcc build or a disk fsync under a
               hot mutex stalls every thread behind it).  Justified
               holds (the slow-log io mutex exists to make append+rotate
               atomic; one nvcc build at a time) live in baseline.json.
lock-guard     instance attributes written under a ``self`` lock in any
               non-``__init__`` method are GUARDED: reading or writing
               them without the lock elsewhere in the class is a race.
               ``*_locked`` helper methods count as lock-held context
               (the pervasive repo convention).  CROSS-OBJECT form:
               a class may declare ``_guarded_by_ =
               "<lock key>"`` — its instances' state then belongs to
               ANOTHER object's lock (the batcher's ``_Group`` rides
               ``MicroBatcher._mu``).  Any store to such an instance's
               attributes (plain assignment or a mutating container
               call: append/pop/extend/...) through a local constructed
               from — or annotated with — the class, without the
               declared lock held, fails.  Loads stay free: the
               lock-free ``Event`` handshakes are the point.

lock-wait      a ``.wait()`` under a held ranked lock whose notifier
               needs a lock ranked at or below the waiter's.

The static pass covers paths tests never execute; the runtime witness
(`util_concurrency.RankedLock`, ``TIDB_TPU_LOCKCHECK=1``) validates the
same :data:`LOCK_RANKS` table against real executions.  The pass walks
`tidb_tpu_torch/`; module keys are relative to that package.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from . import Finding

RULE_RANK = "lock-rank"
RULE_ORDER = "lock-order"
RULE_BLOCKING = "lock-blocking"
RULE_GUARD = "lock-guard"
RULE_WAIT = "lock-wait"

#: method names that park a thread on a condition/event until some
#: notifier runs (the lock-wait rule pairs them with _NOTIFY_METHODS)
_WAIT_METHODS = {"wait", "wait_for"}
_NOTIFY_METHODS = {"notify", "notify_all", "set"}

#: the class attribute declaring the cross-object guard, and the
#: container-mutator method names that count as STORES through it
GUARDED_BY_ATTR = "_guarded_by_"
_MUTATOR_METHODS = {"append", "pop", "extend", "clear", "add", "remove",
                    "insert", "update", "setdefault", "popitem",
                    "appendleft", "discard"}

#: Global lock-rank table: every lock in the tree, keyed
#: ``module:Owner.attr`` (instance locks) or ``module:GLOBAL`` (module
#: locks), module path relative to ``tidb_tpu_torch`` (a package's
#: ``__init__.py`` is the bare package path).  `util_concurrency` reads
#: it when TIDB_TPU_LOCKCHECK=1 turns the runtime witness on.  A thread
#: may only acquire locks in STRICTLY increasing rank order — so
#: coarse/outer locks rank low, leaf locks (metrics, per-trace span
#: mutexes) rank high.  Gaps are deliberate: a new lock slots between its neighbors
#: without renumbering the world.  The README "Concurrency model"
#: section documents the bands.
LOCK_RANKS: Dict[str, int] = {
    # ---- outermost: global dispatch / mesh construction -----------------
    # one statement's collectives across processes: held from the mesh
    # build to the last gather, around every dispatch of the statement
    "ops.collective:_PROGRAM_LOCK": 5,
    # resource-group admission sits IN FRONT of the dispatch door: its
    # registry mutex may be taken before DISPATCH_LOCK (never across it)
    "lifecycle.resgroup:ResourceGroupRegistry._mu": 8,
    "copr.parallel:DISPATCH_LOCK": 10,
    "copr.parallel:_MESH_LOCK": 20,
    # ---- session / DDL coarse state -------------------------------------
    "serving:_mu": 30,
    "session.domain:Domain._mu": 40,
    "coord:_PLANE_LOCK": 50,
    "lifecycle.scope:QueryScope._mu": 60,
    "session.priv:PrivManager._mu": 70,
    "catalog.catalog:Catalog._mu": 80,
    "statistics.handle:StatsHandle._mu": 90,
    "statistics.feedback:QueryFeedback._mu": 95,
    # the shard manager sits IN FRONT of the storage band: re-shard
    # attaches partition stores (rank 100/110) while holding it, and it
    # is never held across a dispatch
    "dataplane.shard:Dataplane._mu": 97,
    # leaf locks of the chaos-hardened RPC layer: held only around dict
    # bookkeeping, never across a dial, socket I/O, or another lock
    "dataplane.rpc:PeerPool._mu": 242,
    "dataplane.rpc:DataplaneServer._dedup_mu": 244,
    # ---- storage engine --------------------------------------------------
    "store.storage:BlockStorage._mu": 100,
    "store.blockstore:TableStore._mu": 110,
    "store.regions:RegionManager._mu": 120,
    "store.index:IndexManager._mu": 130,
    "store.deadlock:DeadlockDetector._mu": 140,
    "store.oracle:Oracle._lock": 150,
    # ---- serving / coordination plane -----------------------------------
    "serving.batcher:MicroBatcher._mu": 160,
    "coord.plane:Coordinator._save_io_mu": 170,
    "coord.plane:Coordinator._mu": 180,
    "coord.plane:LocalPlane._mu": 190,
    "coord.plane:WorkerPlane._mu": 195,
    "coord.plane:WorkerPlane._span_mu": 200,
    "copr.device_health:DeviceHealthRegistry._mu": 210,
    # ---- caches / layout -------------------------------------------------
    "copr.cache:ByteCapCache._mu": 220,
    "copr.cache:ProgramCache._mu": 225,
    "layout.autotuner:LayoutEngine._mu": 230,
    "layout.coldtier:_mu": 235,
    "native:_lib_mu": 240,
    # one nvcc build at a time (copr/cuda/build.py): held across the
    # compiler processes, never while taking another lock
    "copr.cuda.build:_mu": 241,
    # ---- observability / leaves ------------------------------------------
    "trace.slowlog:SlowQueryLog._mu": 250,
    "trace.slowlog:SlowQueryLog._io_mu": 255,
    "store.fault:FailpointRegistry._mu": 260,
    "util_memory:MemTracker._mu": 270,
    "executor.join:_STR_DICT_MU": 275,
    # the computed-key remap cache: leaf, dict bookkeeping only
    "copr.fusion:_REMAP_MU": 276,
    "trace.profiler:Profiler._mu": 280,
    "trace.recorder:_EXPORT_MU": 282,
    "trace.recorder:QueryTrace._mu": 285,
    # SLO AUTO rolling-window tracker: leaf, bucket arithmetic only
    "trace.slo:SloAutoWindows._mu": 287,
    "metrics:Registry._mu": 290,
}

#: process-global singletons whose method calls resolve to a class in
#: the registry (one-level interprocedural edges across modules)
KNOWN_INSTANCES: Dict[str, str] = {
    "REGISTRY": "metrics:Registry",
    "DEVICE_HEALTH": "copr.device_health:DeviceHealthRegistry",
    "FAILPOINTS": "store.fault:FailpointRegistry",
    "PROFILER": "trace.profiler:Profiler",
    "BATCHER": "serving.batcher:MicroBatcher",
    "SLOW_LOG": "trace.slowlog:SlowQueryLog",
}

#: dotted call names that block (I/O, sleeps, subprocesses) — none may
#: run while a registered lock is held
_BLOCKING_DOTTED = {
    "time.sleep", "open", "os.fsync", "os.replace", "os.rename",
    "os.remove", "socket.create_connection", "torch.cuda.synchronize",
}
_BLOCKING_PREFIXES = ("subprocess.", "socket.")
#: method names that block regardless of receiver (.wait on events/
#: conditions, socket verbs, device sync); ``.join`` is special-cased
#: to exclude str.join
_BLOCKING_METHODS = {"wait", "accept", "recv", "sendall", "connect",
                     "block_until_ready"}

_FACTORIES = {"make_lock": False, "make_rlock": True}
_RAW_LOCKS = {"threading.Lock", "threading.RLock", "threading.Condition",
              "Lock", "RLock", "Condition"}
#: the one module allowed to construct raw threading locks (it IS the
#: factory, plus its internal stats mutex)
_FACTORY_MODULE = "util_concurrency"
#: the package the pass walks; lock and module keys are relative to it
_PKG = "tidb_tpu_torch"


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _modkey(relpath: str) -> Tuple[str, bool]:
    """('copr.cache', False) for tidb_tpu_torch/copr/cache.py; a package
    __init__ keys as the bare package ('coord', True)."""
    p = relpath.replace(os.sep, "/")
    if p.startswith(_PKG + "/"):
        p = p[len(_PKG) + 1:]
    p = p[:-3] if p.endswith(".py") else p
    parts = p.split("/")
    if parts[-1] == "__init__":
        return ".".join(parts[:-1]), True
    return ".".join(parts), False


class _Lock:
    """One lock construction site."""

    __slots__ = ("key", "reentrant", "line", "raw", "literal")

    def __init__(self, key, reentrant, line, raw, literal):
        self.key = key            # module:Owner.attr (derived from site)
        self.reentrant = reentrant
        self.line = line
        self.raw = raw            # bare threading.* (lock-rank finding)
        self.literal = literal    # the name literal passed to make_lock


class _Func:
    """Per-function facts gathered in one AST walk."""

    __slots__ = ("qual", "cls", "line", "acqs", "calls", "blocking",
                 "attr_accesses", "waits", "notifies", "obj_stores")

    def __init__(self, qual, cls, line):
        self.qual = qual
        self.cls = cls            # owning class name or None
        self.line = line
        # (lock_key, line, held_keys_tuple) per lexical acquisition
        self.acqs: List[tuple] = []
        # (desc, line, held_keys_tuple) per call; desc is
        # ('self'|'bare'|'attr', ...) for one-level resolution
        self.calls: List[tuple] = []
        # (token, line, held_keys_tuple) per blocking call
        self.blocking: List[tuple] = []
        # (attr, line, is_store, held_bool) for the guard pass
        self.attr_accesses: List[tuple] = []
        # (receiver, line, held_keys_tuple) per `.wait()` under a held
        # lock — the lock-wait rule pairs each with the receiver's
        # notify sites
        self.waits: List[tuple] = []
        # (receiver, line, held_keys_tuple) per `.notify/.notify_all/
        # .set()` — recorded regardless of held state (the notifier's
        # lock REQUIREMENT also includes its lexical acquisitions)
        self.notifies: List[tuple] = []
        # (clsref, attr, line, held_keys_tuple) per store through a
        # ctor/annotation-typed local — filtered in the global pass to
        # classes declaring _guarded_by_
        self.obj_stores: List[tuple] = []


class _Module:
    __slots__ = ("key", "path", "is_pkg", "class_locks", "module_locks",
                 "funcs", "from_imports", "rank_findings", "jitted",
                 "guarded_classes")

    def __init__(self, key, path, is_pkg):
        self.key = key
        self.path = path
        self.is_pkg = is_pkg
        # (class, attr) -> _Lock ; global name -> _Lock
        self.class_locks: Dict[Tuple[str, str], _Lock] = {}
        self.module_locks: Dict[str, _Lock] = {}
        # class name -> declared cross-object guard lock key
        self.guarded_classes: Dict[str, str] = {}
        self.funcs: Dict[str, _Func] = {}
        # local name -> (resolved module key, original name)
        self.from_imports: Dict[str, Tuple[str, str]] = {}
        self.rank_findings: List[Finding] = []
        self.jitted: Set[str] = set()


def _resolve_relative(modkey: str, is_pkg: bool, level: int,
                      module: Optional[str]) -> str:
    parts = modkey.split(".") if modkey else []
    pkg = parts if is_pkg else parts[:-1]
    if level > 1:
        pkg = pkg[: len(pkg) - (level - 1)] if level - 1 <= len(pkg) else []
    out = list(pkg)
    if module:
        out += module.split(".")
    return ".".join(out)


def _lock_ctor(call: ast.Call) -> Optional[Tuple[bool, bool, Optional[str]]]:
    """(reentrant, raw, literal) when `call` constructs a lock."""
    d = _dotted(call.func)
    if d in ("make_lock", "make_rlock",
             "util_concurrency.make_lock", "util_concurrency.make_rlock"):
        reentrant = d.endswith("make_rlock")
        lit = None
        if call.args and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, str):
            lit = call.args[0].value
        return reentrant, False, lit
    if d in ("threading.Lock", "threading.RLock", "threading.Condition"):
        return d == "threading.RLock", True, None
    return None


def _collect_defs(tree: ast.Module, mod: _Module):
    """Phase 1: lock construction sites + imports (no bodies yet)."""

    def scan_assign(node, cls: Optional[str], in_init: bool):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1 \
                or not isinstance(node.value, ast.Call):
            return
        ctor = _lock_ctor(node.value)
        if ctor is None:
            return
        reentrant, raw, literal = ctor
        tgt = node.targets[0]
        td = _dotted(tgt)
        if cls is not None and td and td.startswith("self.") \
                and "." not in td[5:]:
            attr = td[5:]
            key = f"{mod.key}:{cls}.{attr}"
            mod.class_locks[(cls, attr)] = _Lock(
                key, reentrant, node.lineno, raw, literal)
        elif cls is None and isinstance(tgt, ast.Name):
            key = f"{mod.key}:{tgt.id}"
            mod.module_locks[tgt.id] = _Lock(
                key, reentrant, node.lineno, raw, literal)

    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            resolved = (_resolve_relative(mod.key, mod.is_pkg, node.level,
                                          node.module) if node.level
                        else (node.module or ""))
            if resolved.startswith(_PKG + "."):
                resolved = resolved[len(_PKG) + 1:]
            for a in node.names:
                mod.from_imports[a.asname or a.name] = (resolved, a.name)
    # module-level locks
    for node in tree.body:
        scan_assign(node, None, False)
    # class attribute locks (anywhere inside the class's methods)
    for cls_node in tree.body:
        if not isinstance(cls_node, ast.ClassDef):
            continue
        for meth in cls_node.body:
            if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(meth):
                    scan_assign(sub, cls_node.name,
                                meth.name == "__init__")
            elif isinstance(meth, ast.Assign) \
                    and len(meth.targets) == 1 \
                    and isinstance(meth.targets[0], ast.Name) \
                    and meth.targets[0].id == GUARDED_BY_ATTR \
                    and isinstance(meth.value, ast.Constant) \
                    and isinstance(meth.value.value, str):
                mod.guarded_classes[cls_node.name] = meth.value.value


def _check_registry(mod: _Module, ranks: Dict[str, int]) -> List[Finding]:
    """lock-rank findings: raw constructions, bad/missing literals,
    literals absent from LOCK_RANKS."""
    out: List[Finding] = []
    allow_raw = mod.key == _FACTORY_MODULE
    sites = ([(f"{c}.{a}", c, lk)
              for (c, a), lk in mod.class_locks.items()]
             + [(g, "", lk) for g, lk in mod.module_locks.items()])
    for token, scope, lk in sites:
        if lk.raw:
            if not allow_raw:
                out.append(Finding(
                    RULE_RANK, mod.path, lk.line, scope, token,
                    f"raw threading lock {lk.key!r}: construct via "
                    f"util_concurrency.make_lock/make_rlock with a "
                    f"rank declared in lint.concur.LOCK_RANKS"))
            continue
        if lk.literal is None:
            out.append(Finding(
                RULE_RANK, mod.path, lk.line, scope, token,
                f"lock {lk.key!r} name must be a string literal "
                f"(the registry key)"))
        elif lk.literal != lk.key:
            out.append(Finding(
                RULE_RANK, mod.path, lk.line, scope, token,
                f"lock name {lk.literal!r} does not match its "
                f"construction site {lk.key!r}"))
        elif lk.literal not in ranks:
            out.append(Finding(
                RULE_RANK, mod.path, lk.line, scope, token,
                f"lock {lk.literal!r} has no rank in "
                f"lint.concur.LOCK_RANKS"))
    return out


def _is_threadlike_join(call: ast.Call) -> bool:
    """.join() with no args, a numeric arg, or a timeout kwarg is a
    thread/process join; str.join(iterable) is not."""
    if any(kw.arg == "timeout" for kw in call.keywords):
        return True
    if not call.args:
        return True
    if len(call.args) == 1 and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, (int, float)):
        return True
    return False


def _blocking_token(call: ast.Call, jitted: Set[str]) -> Optional[str]:
    d = _dotted(call.func)
    if d:
        if d in _BLOCKING_DOTTED:
            return d
        if d.startswith(_BLOCKING_PREFIXES):
            return d
        if d in jitted or (("." not in d) and d in jitted):
            return d  # a program called under a lock: a dispatch stall
    if isinstance(call.func, ast.Attribute):
        m = call.func.attr
        if m in _BLOCKING_METHODS:
            return "." + m
        if m == "join" and _is_threadlike_join(call):
            return ".join"
    return None


class _BodyWalker:
    """Walks one function body tracking the held-lock stack."""

    def __init__(self, mod: _Module, func: _Func, resolve_lock,
                 jitted: Set[str], base_held: Tuple[str, ...],
                 arg_types: Optional[Dict[str, str]] = None):
        self.mod = mod
        self.func = func
        self.resolve_lock = resolve_lock
        self.jitted = jitted
        self.base_held = base_held
        # local var -> "modkey:ClassName" for ctor-typed / annotated
        # locals (the cross-object guard pass consumes the stores)
        self.types: Dict[str, str] = dict(arg_types or {})

    def _clsref(self, name: str) -> Optional[str]:
        """Resolve a bare class-looking Name to 'modkey:ClassName'."""
        stem = name.lstrip("_")
        if not stem or not stem[0].isupper():
            return None
        if name in self.mod.from_imports:
            m, orig = self.mod.from_imports[name]
            return f"{m}:{orig}"
        return f"{self.mod.key}:{name}"

    def walk(self, body, held: Tuple[str, ...]):
        for stmt in body:
            self._stmt(stmt, held)

    def _stmt(self, node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs execute later, with their own stack
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            # ctor-typed local binding (x = ClassName(...)); any other
            # re-assignment of the name drops the binding
            self._expr(node.value, held)
            tgt = node.targets[0].id
            ref = None
            if isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Name):
                ref = self._clsref(node.value.func.id)
            if ref is not None:
                self.types[tgt] = ref
            else:
                self.types.pop(tgt, None)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            add: List[str] = []
            for item in node.items:
                self._expr(item.context_expr, held)
                key = self.resolve_lock(item.context_expr, self.func.cls)
                if key is not None:
                    self.func.acqs.append((key, node.lineno,
                                           held + tuple(add)))
                    add.append(key)
            self.walk(node.body, held + tuple(add))
            return
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, ast.stmt):
                self._stmt(sub, held)
            elif isinstance(sub, ast.ExceptHandler):
                self.walk(sub.body, held)
            else:
                self._expr(sub, held)

    def _expr(self, node, held):
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                continue
            if isinstance(sub, ast.Call):
                self._call(sub, held)
            elif isinstance(sub, ast.Attribute):
                self._attr(sub, held)

    def _attr(self, node, held):
        if isinstance(node.value, ast.Name) and node.value.id == "self":
            is_store = isinstance(node.ctx, (ast.Store, ast.Del))
            self.func.attr_accesses.append(
                (node.attr, node.lineno, is_store,
                 bool(held) or bool(self.base_held)))
        elif isinstance(node.value, ast.Name) \
                and node.value.id in self.types \
                and isinstance(node.ctx, (ast.Store, ast.Del)):
            self.func.obj_stores.append(
                (self.types[node.value.id], node.attr, node.lineno,
                 held if held else self.base_held))

    def _call(self, node, held):
        effective = held if held else self.base_held
        if isinstance(node.func, ast.Attribute):
            recv = _dotted(node.func.value)
            if recv is not None:
                if node.func.attr in _NOTIFY_METHODS:
                    self.func.notifies.append(
                        (recv, node.lineno, effective))
                elif node.func.attr in _WAIT_METHODS and effective:
                    self.func.waits.append(
                        (recv, node.lineno, effective))
            if node.func.attr in _MUTATOR_METHODS:
                # g.items.append(x) mutates guarded attribute `items`;
                # g.append(x) mutates the guarded object itself
                inner = node.func.value
                if isinstance(inner, ast.Attribute) \
                        and isinstance(inner.value, ast.Name) \
                        and inner.value.id in self.types:
                    self.func.obj_stores.append(
                        (self.types[inner.value.id], inner.attr,
                         node.lineno, effective))
                elif isinstance(inner, ast.Name) \
                        and inner.id in self.types:
                    self.func.obj_stores.append(
                        (self.types[inner.id], node.func.attr,
                         node.lineno, effective))
        if effective:
            tok = _blocking_token(node, self.jitted)
            if tok is not None:
                self.func.blocking.append((tok, node.lineno, effective))
        if held:  # call targets matter only while a lexical lock is held
            d = _dotted(node.func)
            if d is None:
                return
            parts = d.split(".")
            if parts[0] == "self" and len(parts) == 2:
                self.func.calls.append((("self", parts[1]),
                                        node.lineno, held))
            elif len(parts) == 1:
                self.func.calls.append((("bare", parts[0]),
                                        node.lineno, held))
            elif len(parts) == 2:
                self.func.calls.append((("attr", parts[0], parts[1]),
                                        node.lineno, held))


def _analyze_module(tree: ast.Module, relpath: str,
                    lock_name_index: Dict[str, str],
                    ranks: Dict[str, int]) -> _Module:
    """Phases 1+2 for one file: definitions, then function facts."""
    from .purity import _jitted_names

    key, is_pkg = _modkey(relpath)
    mod = _Module(key, relpath, is_pkg)
    _collect_defs(tree, mod)
    mod.jitted = _jitted_names(tree)
    mod.rank_findings = _check_registry(mod, ranks)

    def resolve_lock(expr, cls: Optional[str]) -> Optional[str]:
        d = _dotted(expr)
        if d is None:
            return None
        if d.startswith("self.") and "." not in d[5:]:
            attr = d[5:]
            if cls and (cls, attr) in mod.class_locks:
                return mod.class_locks[(cls, attr)].key
            return None
        if "." in d:
            return None
        if d in mod.module_locks:
            return mod.module_locks[d].key
        if d in mod.from_imports:
            m, orig = mod.from_imports[d]
            cand = f"{m}:{orig}"
            if cand in ranks or cand in lock_name_index:
                return cand
        return None

    def visit_funcs(body, cls: Optional[str]):
        for node in body:
            if isinstance(node, ast.ClassDef):
                visit_funcs(node.body, node.name)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{cls}.{node.name}" if cls else node.name
                func = _Func(qual, cls, node.lineno)
                mod.funcs[qual] = func
                # *_locked helpers of lock-owning classes run with the
                # caller's lock held (the repo convention): their body
                # is lock-held context for blocking + guard purposes
                class_keys = tuple(
                    lk.key for (c, _a), lk in mod.class_locks.items()
                    if c == cls) if cls else ()
                base = (("<caller-lock>",) if
                        node.name.endswith("_locked") and class_keys
                        else ())
                walker = _BodyWalker(mod, func, resolve_lock,
                                     mod.jitted, base)
                for a in (node.args.args + node.args.kwonlyargs
                          + node.args.posonlyargs):
                    ann = a.annotation
                    name = None
                    if isinstance(ann, ast.Name):
                        name = ann.id
                    elif isinstance(ann, ast.Constant) \
                            and isinstance(ann.value, str):
                        name = ann.value.strip("'\"")
                    if name:
                        ref = walker._clsref(name)
                        if ref is not None:
                            walker.types[a.arg] = ref
                walker.walk(node.body, ())
                # nested defs (closures, hook functions) get their own
                # empty-stack analysis under the enclosing qualname
                for sub in ast.walk(ast.Module(body=node.body,
                                               type_ignores=[])):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)) \
                            and sub is not node:
                        nqual = f"{qual}.{sub.name}"
                        nfunc = _Func(nqual, cls, sub.lineno)
                        mod.funcs[nqual] = nfunc
                        _BodyWalker(mod, nfunc, resolve_lock,
                                    mod.jitted, ()).walk(sub.body, ())

    visit_funcs(tree.body, None)
    return mod


# ---------------------------------------------------------------------------
# cross-module edge construction
# ---------------------------------------------------------------------------

class _Index:
    """All modules, with helpers for one-level call resolution."""

    def __init__(self, modules: List[_Module]):
        self.modules = {m.key: m for m in modules}
        self.funcs: Dict[str, Tuple[_Module, _Func]] = {}
        self.lock_names: Dict[str, str] = {}
        for m in modules:
            for lk in list(m.module_locks.values()) \
                    + list(m.class_locks.values()):
                self.lock_names[lk.key] = lk.key
            for q, f in m.funcs.items():
                self.funcs[f"{m.key}:{q}"] = (m, f)

    def reentrant(self, key: str) -> bool:
        for m in self.modules.values():
            for lk in list(m.module_locks.values()) \
                    + list(m.class_locks.values()):
                if lk.key == key:
                    return lk.reentrant
        return False

    def resolve_call(self, mod: _Module, cls: Optional[str],
                     desc: tuple) -> Optional[str]:
        kind = desc[0]
        if kind == "self":
            return f"{mod.key}:{cls}.{desc[1]}" if cls else None
        if kind == "bare":
            name = desc[1]
            if name in mod.from_imports:
                m, orig = mod.from_imports[name]
                return f"{m}:{orig}"
            return f"{mod.key}:{name}"
        if kind == "attr":
            base, meth = desc[1], desc[2]
            if base in KNOWN_INSTANCES:
                return f"{KNOWN_INSTANCES[base]}.{meth}"
            if base in mod.from_imports:
                m, orig = mod.from_imports[base]
                sub = f"{m}.{orig}" if m else orig
                if f"{sub}:{meth}" in self.funcs:
                    return f"{sub}:{meth}"
        return None

    def reach(self, fq: str, seen: Optional[Set[str]] = None,
              one_level: bool = True) -> Set[str]:
        """Locks `fq` may acquire: its lexical acquisitions, plus (one
        level) its callees' lexical acquisitions; same-class *_locked
        callees are inlined recursively."""
        if fq not in self.funcs:
            return set()
        seen = seen if seen is not None else set()
        if fq in seen:
            return set()
        seen.add(fq)
        mod, func = self.funcs[fq]
        out = {k for k, _l, _h in func.acqs}
        for desc, _line, _held in func.calls:
            tgt = self.resolve_call(mod, func.cls, desc)
            if tgt is None or tgt not in self.funcs:
                continue
            _tm, tf = self.funcs[tgt]
            if tgt.rsplit(".", 1)[-1].endswith("_locked") \
                    and tf.cls == func.cls:
                out |= self.reach(tgt, seen)
            elif one_level:
                out |= {k for k, _l, _h in tf.acqs}
        return out


def _order_findings(index: _Index, ranks: Dict[str, int]) -> List[Finding]:
    out: List[Finding] = []
    edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}

    def add_edge(h, k, mod, line, scope):
        if h == "<caller-lock>" or k == "<caller-lock>":
            return
        if (h, k) not in edges:
            edges[(h, k)] = (mod.path, line, scope)

    for fq, (mod, func) in index.funcs.items():
        for k, line, held in func.acqs:
            for h in held:
                add_edge(h, k, mod, line, func.qual)
        for desc, line, held in func.calls:
            tgt = index.resolve_call(mod, func.cls, desc)
            if tgt is None:
                continue
            tl = tgt.rsplit(".", 1)[-1].endswith("_locked")
            reached = (index.reach(tgt) if tl
                       else index.reach(tgt, one_level=True))
            for k in reached:
                for h in held:
                    add_edge(h, k, mod, line, func.qual)

    for (h, k), (path, line, scope) in sorted(edges.items()):
        token = f"{h}->{k}"
        if h == k:
            if not index.reentrant(h) and h in ranks:
                out.append(Finding(
                    RULE_ORDER, path, line, scope, token,
                    f"non-reentrant lock {h!r} may be re-acquired "
                    f"while held (self-deadlock)"))
            continue
        rh, rk = ranks.get(h), ranks.get(k)
        if rh is None or rk is None:
            continue  # unranked locks already carry a lock-rank finding
        if rh >= rk:
            out.append(Finding(
                RULE_ORDER, path, line, scope, token,
                f"acquires {k!r} (rank {rk}) while holding {h!r} "
                f"(rank {rh}): ranks must strictly increase"))

    # cycle check over the whole digraph (safety net: with strict-rank
    # edges the graph is a DAG by construction, but unranked locks can
    # still close a loop)
    graph: Dict[str, Set[str]] = {}
    for (h, k) in edges:
        if h != k:
            graph.setdefault(h, set()).add(k)
    state: Dict[str, int] = {}
    stack: List[str] = []
    cycles: List[Tuple[str, ...]] = []

    def dfs(n):
        state[n] = 1
        stack.append(n)
        for nxt in sorted(graph.get(n, ())):
            if state.get(nxt, 0) == 1:
                cyc = tuple(stack[stack.index(nxt):]) + (nxt,)
                cycles.append(cyc)
            elif state.get(nxt, 0) == 0:
                dfs(nxt)
        stack.pop()
        state[n] = 2

    for n in sorted(graph):
        if state.get(n, 0) == 0:
            dfs(n)
    for cyc in cycles:
        h, k = cyc[0], cyc[1]
        path, line, scope = edges[(h, k)]
        out.append(Finding(
            RULE_ORDER, path, line, "<graph>",
            "cycle:" + "->".join(cyc),
            f"lock-order cycle: {' -> '.join(cyc)}"))
    return out


def _blocking_findings(index: _Index) -> List[Finding]:
    out: List[Finding] = []
    for fq, (mod, func) in index.funcs.items():
        seen: Set[tuple] = set()
        for tok, line, held in func.blocking:
            holder = next((h for h in held if h != "<caller-lock>"),
                          held[0] if held else "")
            dkey = (func.qual, tok, line)
            if dkey in seen:
                continue
            seen.add(dkey)
            if holder == "<caller-lock>":
                msg = (f"blocking call {tok!r} in lock-held helper "
                       f"{func.qual!r} (callers hold the class lock)")
            else:
                msg = (f"blocking call {tok!r} while holding "
                       f"{holder!r}")
            out.append(Finding(RULE_BLOCKING, mod.path, line,
                               func.qual, tok, msg))
    return out


def _wait_findings(index: _Index, ranks: Dict[str, int]) -> List[Finding]:
    """lock-wait: a `.wait()` under a held ranked lock whose notifier —
    any `.notify/.notify_all/.set()` on the same receiver in the same
    class (self.*) or module — holds or lexically acquires a lock
    ranked at or below the waiter's: the notifier can block behind the
    very lock the waiter holds, so the wait never wakes (the classic
    condition-under-lock inversion).  The runtime half is
    util_concurrency.witness_wait_check."""
    out: List[Finding] = []
    notif: Dict[tuple, List[Set[str]]] = {}
    for _fq, (mod, func) in index.funcs.items():
        acq_keys = {k for k, _l, _h in func.acqs}
        for recv, _line, held in func.notifies:
            skey = ((mod.key, func.cls) if recv.startswith("self.")
                    else (mod.key, None))
            req = {h for h in held if h != "<caller-lock>"} | acq_keys
            notif.setdefault((skey, recv), []).append(req)
    for _fq, (mod, func) in index.funcs.items():
        flagged: Set[tuple] = set()
        for recv, line, held in func.waits:
            held_ranked = [h for h in held if h in ranks]
            if not held_ranked:
                continue
            min_held = min(ranks[h] for h in held_ranked)
            skey = ((mod.key, func.cls) if recv.startswith("self.")
                    else (mod.key, None))
            for req in notif.get((skey, recv), ()):
                bad = sorted(k for k in req
                             if k in ranks and ranks[k] <= min_held)
                if bad and (func.qual, recv, line) not in flagged:
                    flagged.add((func.qual, recv, line))
                    holder = min(held_ranked, key=lambda h: ranks[h])
                    out.append(Finding(
                        RULE_WAIT, mod.path, line, func.qual, recv,
                        f"waits on {recv!r} while holding {holder!r} "
                        f"(rank {min_held}) but its notifier needs "
                        f"{bad[0]!r} (rank {ranks[bad[0]]}): the "
                        f"notifier can block behind the held lock and "
                        f"the wait never wakes"))
                    break
    return out


def _guard_findings(index: _Index) -> List[Finding]:
    out: List[Finding] = []
    for mod in index.modules.values():
        by_cls: Dict[str, List[_Func]] = {}
        for f in mod.funcs.values():
            if f.cls is not None:
                by_cls.setdefault(f.cls, []).append(f)
        lock_attrs = {(c, a) for (c, a) in mod.class_locks}
        for cls, funcs in by_cls.items():
            if not any(c == cls for (c, _a) in lock_attrs):
                continue
            guarded: Set[str] = set()
            for f in funcs:
                base = f.qual.split(".", 1)[1] if "." in f.qual else f.qual
                if base == "__init__" or "__init__." in f.qual:
                    continue
                for attr, _line, is_store, held in f.attr_accesses:
                    if is_store and held and (cls, attr) not in lock_attrs:
                        guarded.add(attr)
            if not guarded:
                continue
            for f in funcs:
                base = f.qual.split(".", 1)[1] if "." in f.qual else f.qual
                if base == "__init__" or "__init__." in f.qual:
                    continue
                flagged: Set[str] = set()
                for attr, line, _is_store, held in f.attr_accesses:
                    if attr in guarded and not held \
                            and attr not in flagged:
                        flagged.add(attr)
                        out.append(Finding(
                            RULE_GUARD, mod.path, line, f.qual, attr,
                            f"attribute self.{attr} is written under "
                            f"{cls}'s lock elsewhere but accessed "
                            f"here without it"))
    return out


def _xguard_findings(index: _Index) -> List[Finding]:
    """Cross-object lock-guard: stores to instances of a
    class declaring ``_guarded_by_ = "<lock key>"`` must hold THAT lock
    — the declared key lexically, or the caller-lock convention when
    the key is one of the enclosing class's own locks (so a batcher
    ``*_locked`` helper mutating a _Group stays legal)."""
    out: List[Finding] = []
    guarded: Dict[str, str] = {}
    for m in index.modules.values():
        for cls, lockkey in m.guarded_classes.items():
            guarded[f"{m.key}:{cls}"] = lockkey
    if not guarded:
        return out
    for _fq, (mod, func) in index.funcs.items():
        class_keys = ({lk.key for (c, _a), lk in mod.class_locks.items()
                       if c == func.cls} if func.cls else set())
        flagged: Set[tuple] = set()
        for clsref, attr, line, held in func.obj_stores:
            lockkey = guarded.get(clsref)
            if lockkey is None:
                continue
            if lockkey in held or ("<caller-lock>" in held
                                   and lockkey in class_keys):
                continue
            cname = clsref.rsplit(":", 1)[-1]
            if (clsref, attr) in flagged:
                continue
            flagged.add((clsref, attr))
            out.append(Finding(
                RULE_GUARD, mod.path, line, func.qual,
                f"{cname}.{attr}",
                f"{cname} declares _guarded_by_ {lockkey!r}: this "
                f"store to .{attr} does not hold it"))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _findings_for(modules: List[_Module],
                  ranks: Dict[str, int]) -> List[Finding]:
    index = _Index(modules)
    out: List[Finding] = []
    for m in modules:
        out += m.rank_findings
    out += _order_findings(index, ranks)
    out += _blocking_findings(index)
    out += _wait_findings(index, ranks)
    out += _guard_findings(index)
    out += _xguard_findings(index)
    return out


def lint_source(src: str, relpath: str,
                ranks: Optional[Dict[str, int]] = None) -> List[Finding]:
    """Single-file entry (tests): `ranks` overrides LOCK_RANKS so
    negatives can declare their own tiny rank tables."""
    ranks = LOCK_RANKS if ranks is None else ranks
    tree = ast.parse(src)
    mod = _analyze_module(tree, relpath, {}, ranks)
    return _findings_for([mod], ranks)


def lint_tree(repo_root: Optional[str] = None) -> List[Finding]:
    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
    pkg = os.path.join(repo_root, _PKG)
    modules: List[_Module] = []
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
            modules.append(_analyze_module(tree, rel, {}, LOCK_RANKS))
    return _findings_for(modules, LOCK_RANKS)

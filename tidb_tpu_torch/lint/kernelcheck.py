"""Kernel-contract checker: run every canonical device program once.

The JAX package abstract-traces its jitted programs (`jax.make_jaxpr`).
The port's programs are eager PyTorch, and their sizes depend on the
data (`nonzero`, `bincount`, size reads), so meta or fake tensors cannot
stand in for the inputs; here "trace" means RUNNING the program once on
canonical TILE-shaped inputs on the chosen device under an op recorder
(`trace_program`): a `TorchDispatchMode` that records every aten op with
its output dtypes, plus the K1/K2 launches the kernel wrappers count (a
ctypes launch is not an aten op).  The stats of one program are
``{"ops": n, "i64_ops": m, "k1": a, "k2": b}`` — the counterpart of the
JAX package's ``{"eqns", "i64_eqns"}``.

For every canonical program shape (the per-tile programs of
`torch_engine._build_tile_fn` over CANONICAL_KERNEL_QUERIES, the
whole-fragment mesh programs of `parallel._build_mesh_core` over
FUSED_FRAGMENT_KERNELS and the cold class, the canonical MPP exchange,
tree and grouped programs of `mpp/exchange.py`, the micro-batcher's
batched program, and the two CUDA kernels), this pass fails on:

1. a contract break: the program raises on its canonical inputs;
2. operand-value divergence: under shifted keys, another group budget,
   shifted dictionary operands, another range count, a bumped membership
   epoch or another batch fill, the sequence of op names and output
   dtypes must be identical — values are runtime operands, never
   program shape;
3. context capture: an active query trace or deadline scope adds no op;
4. a recompile bomb: running the canonical corpus a second time (also
   under an active trace) adds no entry to any `ProgramCache` and starts
   no nvcc build, and the corpus' entries stay under the baseline's
   `__signatures__` cap;
5. growth: a program's `i64_ops` past the baseline of the device that
   ran (the port runs different programs on the two devices: K1/K2 on
   the card, their plain versions on the CPU).

On the card the CUDA kernels must equal their plain versions exactly;
on the CPU their plain versions must meet the kernels' contract.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from . import Finding

#: queries whose cop DAGs define the per-tile program corpus; shapes
#: cover every `_build_tile_fn` kind
CANONICAL_KERNEL_QUERIES = [
    ("q1-dense-agg",
     "select l_returnflag, l_linestatus, sum(l_quantity),"
     " sum(l_extendedprice * (1 - l_discount)), avg(l_discount), count(*)"
     " from lineitem where l_shipdate <= '1998-09-02'"
     " group by l_returnflag, l_linestatus"),
    ("q6-scalar-agg",
     "select sum(l_extendedprice * l_discount) from lineitem"
     " where l_discount between 0.05 and 0.07 and l_quantity < 24"),
    ("filter-project",
     "select l_orderkey, l_extendedprice * (1 - l_discount) from lineitem"
     " where l_quantity < 10"),
    ("topn",
     "select l_orderkey from lineitem order by l_extendedprice desc"
     " limit 5"),
    ("minmax-agg",
     "select l_returnflag, min(l_quantity), max(l_extendedprice)"
     " from lineitem group by l_returnflag"),
]

#: MPP exchange programs (mpp/exchange.py) at S = 1: the partition /
#: all_to_all shuffle and the all_gather broadcast rung of the
#: partitioned join, both with the two-pass count+emit expansion
MPP_EXCHANGE_KERNELS = ("mpp-shuffle-join", "mpp-broadcast-join")

#: the grouped-partial + on-device-merge program (mpp/exchange.py
#: trace_grouped_agg_kernel): the group BUDGET is a runtime scalar
#: tensor; two budget values must run identical op sequences
MPP_GROUPED_KERNEL = "mpp-grouped-agg-merge"

#: the 3-way join-tree rung-ladder program (mpp/exchange.py
#: trace_tree_join_kernel): two exchange/local-join rungs in ONE program
#: with the intermediate on the device — identical op sequences under
#: key operand shifts, and EXECUTED against the row-at-a-time oracle
TREE_JOIN_KERNEL = "mpp-tree-3way-join"

#: the micro-batcher's batched program (torch_engine._tile_core with
#: batched=True): the q6-scalar-agg shape with predicate constants
#: hoisted to parameter slots, over a pow2-padded batch of B members
VMAP_BATCH_KERNEL = "serving-vmapped-batch"
VMAP_BATCH_B = 4

#: the cold-tier fused program: the q6 scalar-agg fragment with every
#: packable column riding as bit-packed codes that unpack through K2;
#: the dictionary VALUES are runtime operands — shifted contents must
#: run the identical op sequence
COLD_FRAGMENT_KERNEL = "fused-mesh-cold-agg"

#: whole-fragment fused MESH programs (copr/fusion.py emitters composed
#: by parallel._build_mesh_core): one entry per fused shape class
FUSED_FRAGMENT_KERNELS = [
    ("fused-mesh-dense-agg",
     "select l_returnflag, l_linestatus, sum(l_quantity),"
     " sum(l_extendedprice * (1 - l_discount)), avg(l_discount), count(*)"
     " from lineitem where l_shipdate <= '1998-09-02'"
     " group by l_returnflag, l_linestatus"),
    ("fused-mesh-scalar-agg",
     "select sum(l_extendedprice * l_discount) from lineitem"
     " where l_discount between 0.05 and 0.07 and l_quantity < 24"),
    ("fused-mesh-sort-agg",
     "select l_discount, count(*), sum(l_quantity) from lineitem"
     " group by l_discount"),
    ("fused-mesh-filter",
     "select l_orderkey, l_quantity from lineitem where l_quantity < 10"),
    ("fused-mesh-topn",
     "select l_orderkey from lineitem order by l_extendedprice desc"
     " limit 5"),
    # a computed STRING group key lowered to a dict-code re-map (K1), and
    # a packed-compound multi-column TopN ordering
    ("fused-mesh-computed-key-agg",
     "select substr(l_returnflag, 1, 1), count(*), sum(l_quantity)"
     " from lineitem group by substr(l_returnflag, 1, 1)"),
    ("fused-mesh-compound-topn",
     "select l_orderkey from lineitem"
     " order by l_returnflag desc, l_shipdate, l_orderkey limit 5"),
]

#: the hand-written CUDA kernels (copr/cuda) that replace the JAX
#: package's Pallas tier: each runs on a canonical input, guards the
#: operand-value rule, and is held against its plain version
CUDA_KERNELS = ("cuda-remap-codes", "cuda-unpack-codes")

RULE = "kernel-contract"


# ---------------------------------------------------------------------------
# the op recorder
# ---------------------------------------------------------------------------


class OpTrace:
    """The ops one program run issued: (aten op, output dtypes) in
    order, and the K1/K2 launches the kernel wrappers counted."""

    __slots__ = ("ops", "k1", "k2")

    def __init__(self, ops, k1: int = 0, k2: int = 0):
        self.ops = ops
        self.k1 = k1
        self.k2 = k2

    def stats(self) -> Dict[str, int]:
        return {"ops": len(self.ops),
                "i64_ops": sum(1 for _n, dts in self.ops
                               if "torch.int64" in dts),
                "k1": self.k1, "k2": self.k2}

    def signature(self) -> tuple:
        return tuple(self.ops), self.k1, self.k2

    def __eq__(self, other):
        return isinstance(other, OpTrace) \
            and self.signature() == other.signature()


class _OpRecorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: List[Tuple[str, Tuple[str, ...]]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append((str(func), tuple(
            str(t.dtype) for t in tree_leaves(out)
            if isinstance(t, torch.Tensor))))
        return out


def _launch_counts() -> Tuple[int, int]:
    from ..copr.cuda.remap import remap_codes
    from ..copr.cuda.unpack import unpack_codes

    return remap_codes.launches, unpack_codes.launches


def trace_program(fn, *args, **kwargs):
    """Run `fn(*args, **kwargs)` once under the op recorder; returns
    (its result, OpTrace)."""
    k1, k2 = _launch_counts()
    rec = _OpRecorder()
    with rec:
        out = fn(*args, **kwargs)
    e1, e2 = _launch_counts()
    return out, OpTrace(rec.ops, e1 - k1, e2 - k2)


# ---------------------------------------------------------------------------
# canonical programs
# ---------------------------------------------------------------------------


def _reader_dags(phys):
    """Every cop DAG reachable from a physical plan (readers may hide
    under DeviceJoinReader/DML wrappers)."""
    out = []
    seen = set()

    def walk(p):
        if id(p) in seen or p is None:
            return
        seen.add(id(p))
        dag = getattr(p, "dag", None)
        if dag is not None:
            out.append((p, dag))
        for c in getattr(p, "children", ()) or ():
            walk(c)
        for attr in ("reader", "build_plan", "select_phys"):
            walk(getattr(p, attr, None))

    walk(phys)
    return out


def _kind(an) -> str:
    return "agg" if an.agg is not None else (
        "topn" if an.topn is not None else "filter")


def canonical_inputs(table, an, col_order):
    """TILE-shaped inputs with the exact dtypes `_gather_tile` feeds the
    per-tile program (DATE/STRING as int32 codes, FLOAT as f64, else
    i64), on the current device: (datas, valids, lo, hi, del_mask)."""
    from .. import ops
    from ..copr.torch_engine import TILE
    from ..types import TypeKind

    dev = ops.device()
    datas, valids = [], []
    for ci in col_order:
        k = table.cols[an.scan.columns[ci]].ftype.kind
        dt = torch.int32 if k in (TypeKind.DATE, TypeKind.STRING) else (
            torch.float64 if k == TypeKind.FLOAT else torch.int64)
        datas.append(torch.zeros(TILE, dtype=dt, device=dev))
        valids.append(torch.ones(TILE, dtype=torch.bool, device=dev))
    del_mask = torch.ones(TILE, dtype=torch.bool, device=dev)
    return datas, valids, 0, TILE, del_mask


def _params(an, B: Optional[int] = None):
    """The hoisted predicate parameters on the current device (stacked
    B times when `B` is given), or () when nothing is hoisted."""
    from .. import ops
    from ..serving import hoist_conds

    hoisted = hoist_conds(an)
    if hoisted is None:
        if B is None:
            return ()
        hoisted = (np.zeros(0, dtype=np.int64),
                   np.zeros(0, dtype=np.float64))
    dev = ops.device()
    if B is not None:
        hoisted = tuple(np.stack([h] * B) for h in hoisted)
    return tuple(torch.from_numpy(np.ascontiguousarray(h)).to(dev)
                 for h in hoisted)


def trace_kernel(table, dag) -> OpTrace:
    """Run one per-tile program on canonical inputs; raises on contract
    breaks (bad shapes/dtypes, out-of-range refs, non-compilable
    exprs)."""
    from ..copr.ir import DAG
    from ..copr.torch_engine import _Analyzed, _build_tile_fn
    from ..serving import hoist_conds

    # run the WIRE format: the engine only ever sees DAGs that crossed
    # the distsql codec (which strips planner unique_ids)
    dag = DAG.from_dict(dag.to_dict())
    an = _Analyzed(dag, table)
    kind = _kind(an)
    col_order = an.needed_cols()
    fn = _build_tile_fn(an, kind, col_order,
                        with_params=hoist_conds(an) is not None)
    args = canonical_inputs(table, an, col_order)
    return trace_program(fn, *args, *_params(an))[1]


def trace_batch_kernel(table, dag, B: int = VMAP_BATCH_B,
                       masked: bool = False) -> OpTrace:
    """Run the micro-batcher's batched per-tile program once.

    `masked=True` runs with a partially-false deletion mask, a clipped
    [lo, hi) and shifted parameter values: members differ only in DATA,
    so the op sequence must be identical either way."""
    from ..copr.ir import DAG
    from ..copr.torch_engine import TILE, _Analyzed, _tile_core
    from ..serving import shape_bucket

    dag = DAG.from_dict(dag.to_dict())
    an = _Analyzed(dag, table)
    kind = _kind(an)
    col_order = an.needed_cols()
    b_pad = shape_bucket(B)
    pi, pf = _params(an, b_pad)
    datas, valids, lo, hi, del_mask = canonical_inputs(table, an, col_order)
    if masked:
        del_mask = del_mask.clone()
        del_mask[::7] = False
        lo, hi = 3, TILE - 5
        pi = pi + torch.arange(b_pad, dtype=pi.dtype,
                               device=pi.device).reshape(-1, 1)
        pf = pf * 0.5
    core = _tile_core(an, kind, col_order, with_params=True, batched=True)
    return trace_program(core, datas, valids, lo, hi, del_mask, pi, pf)[1]


def _cuda_kernel(name: str) -> OpTrace:
    """Run one CUDA kernel's wrapper on its canonical input; on the card
    it must equal its plain version exactly, on the CPU (where the
    wrapper takes the plain version) it must meet the kernel's contract
    (numpy reference).  The operand-value rule: another mapping content
    runs the identical op sequence.  Raises AssertionError on any
    break."""
    from .. import ops
    from ..copr.cuda import (remap_codes, remap_codes_plain, unpack_codes,
                             unpack_codes_plain)
    from ..layout.coldtier import pack_codes

    dev = ops.device()
    if name == "cuda-remap-codes":
        codes_np = (np.arange(257, dtype=np.int32) * 7) % 16
        codes = torch.from_numpy(codes_np).to(dev)
        traces = []
        for shift in (0, 5):
            mapping_np = np.arange(16, dtype=np.int32) * 3 + 1 + shift
            mapping = torch.from_numpy(mapping_np).to(dev)
            got, tr = trace_program(remap_codes, codes, mapping, 257)
            traces.append(tr)
            want = (remap_codes_plain(codes, mapping, 257) if
                    dev.type == "cuda" else torch.from_numpy(
                        mapping_np[np.clip(codes_np, 0, 15)]))
            if not torch.equal(got.cpu(), want.cpu()):
                raise AssertionError(
                    "remap_codes disagrees with its plain version")
        if traces[0] != traces[1]:
            raise AssertionError(
                "mapping contents changed the remap kernel's op sequence "
                "— the mapping must stay a runtime operand")
        return traces[0]
    raw_np = (np.arange(512) % 16).astype(np.uint8)
    packed = torch.from_numpy(pack_codes(raw_np, 4)).to(dev)
    got, tr = trace_program(unpack_codes, packed, 4, 512)
    want = (unpack_codes_plain(packed, 4, 512) if dev.type == "cuda"
            else torch.from_numpy(raw_np))
    if not torch.equal(got.cpu(), want.cpu()) \
            or not np.array_equal(got.cpu().numpy(), raw_np):
        raise AssertionError(
            "unpack_codes disagrees with its plain version or with the "
            "pack_codes round trip")
    return tr


# ---------------------------------------------------------------------------
# the census of programs and builds (recompile-bomb guard)
# ---------------------------------------------------------------------------


def _signature_census() -> Tuple[set, int]:
    """(every ProgramCache's (cache, fingerprint) entries, nvcc processes
    started so far)."""
    from ..copr.cache import PROGRAM_CACHES
    from ..copr.cuda.build import nvcc_runs

    entries = set()
    for c in PROGRAM_CACHES:
        with c._mu:
            entries |= {(c.name, k) for k in c._d}
    return entries, nvcc_runs()


def corpus_census(s, queries) -> Dict[str, object]:
    """Run `queries` three times (the third under an active query trace)
    and census the program caches and nvcc builds between the runs:
    {"first": entries the first run added, "rerun": entries the second
    added, "traced": entries the traced run added, "builds": nvcc
    processes the second and third runs started}."""
    from ..trace import finish_trace, start_trace

    e0, _b0 = _signature_census()
    for q in queries:
        s.query(q)
    e1, b1 = _signature_census()
    for q in queries:
        s.query(q)
    e2, b2 = _signature_census()
    tr, token = start_trace("kernelcheck-traced-corpus", 0)
    try:
        for q in queries:
            s.query(q)
    finally:
        finish_trace(tr, token)
    e3, b3 = _signature_census()
    return {"first": e1 - e0, "rerun": e2 - e1, "traced": e3 - e2,
            "builds": b3 - b1}


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _on_device(device: str):
    """Run with every entry point pinned to `device` (one position),
    restoring the caller's pin afterwards."""
    from .. import ops

    prior = (ops._DEVICE, ops._SHARDS)
    ops.use_device(device)
    try:
        yield
    finally:
        ops.use_device(*prior)


def measure_kernels(device: str = "cuda"
                    ) -> Tuple[Dict[str, dict], List[Finding]]:
    """Run the canonical program corpus on `device` ("cuda" or "cpu");
    returns ({program: stats, "__signatures__": {"max": n}}, findings
    for contract breaks, divergences, context capture and recompiles).
    Growth against a baseline is `compare_stats`."""
    from ..copr.torch_eval import DeviceUnsupported
    from ..parser import parse_one
    from .plancheck import _canonical_session

    stats: Dict[str, dict] = {}
    findings: List[Finding] = []

    def emit(kernel: str, msg: str):
        findings.append(Finding(
            rule=RULE, path="tidb_tpu_torch/copr", line=0,
            scope=kernel, token="trace", message=msg))

    def same(name: str, a: OpTrace, b: OpTrace, what: str) -> bool:
        if a == b:
            return True
        emit(name, f"{what} changed the program's op sequence "
                   f"({a.stats()} vs {b.stats()}) — values must stay "
                   "runtime operands, never program shape")
        return False

    def first_dag(sql, run):
        """run(dag) over the query's cop DAGs: the first that has a
        device form (DeviceUnsupported moves to the next)."""
        phys = s._plan(parse_one(sql))
        for _p, dag in _reader_dags(phys):
            try:
                return dag, run(dag)
            except DeviceUnsupported:
                continue
        return None, None

    with _on_device(device):
        s = _canonical_session()
        dom = s.domain
        table = dom.storage.table(
            dom.catalog.info_schema().table("test", "lineitem").id)

        # -- per-tile programs --------------------------------------------
        tile_dags = {}
        for name, sql in CANONICAL_KERNEL_QUERIES:
            try:
                dag, tr = first_dag(sql, lambda d: trace_kernel(table, d))
            except Exception as e:  # noqa: BLE001 — contract break
                emit(name, f"kernel trace failed: {type(e).__name__}: {e}")
                continue
            if tr is None:
                emit(name, "no device-eligible program for the canonical "
                           "query — device coverage regressed")
                continue
            tile_dags[name] = (dag, tr)
            stats[name] = tr.stats()

        # -- MPP exchange / partitioned-join programs ---------------------
        from ..mpp import exchange as mx

        for name in MPP_EXCHANGE_KERNELS:
            mode = "shuffle" if "shuffle" in name else "broadcast"
            try:
                stats[name] = mx.trace_exchange_kernel(mode).stats()
            except Exception as e:  # noqa: BLE001 — contract break
                emit(name, f"exchange program failed: "
                           f"{type(e).__name__}: {e}")

        # -- 3-way join-tree rung ladder ----------------------------------
        name = TREE_JOIN_KERNEL
        try:
            tr = mx.trace_tree_join_kernel(0)
            if same(name, tr, mx.trace_tree_join_kernel(3),
                    "shifted key operands"):
                over, jover, total = mx.run_tree_join_kernel(0)
                want = mx.tree_join_oracle(0)
                if over or jover:
                    emit(name, f"canonical ladder overflowed (partition "
                               f"{over}, emit {jover}) — capacities no "
                               "longer fit the canonical shape")
                elif abs(total - want) > 1e-9 * max(abs(want), 1.0):
                    emit(name, f"executed 3-way ladder disagrees with the "
                               f"numpy oracle: {total} != {want}")
                else:
                    stats[name] = tr.stats()
        except Exception as e:  # noqa: BLE001 — contract break
            emit(name, f"tree join program failed: "
                       f"{type(e).__name__}: {e}")

        # -- MPP grouped-partial + on-device-merge program ----------------
        name = MPP_GROUPED_KERNEL
        try:
            tr = mx.trace_grouped_agg_kernel(budget=5)
            if same(name, tr, mx.trace_grouped_agg_kernel(budget=9),
                    "the group-budget value"):
                stats[name] = tr.stats()
        except Exception as e:  # noqa: BLE001 — contract break
            emit(name, f"grouped agg program failed: "
                       f"{type(e).__name__}: {e}")

        # -- whole-fragment fused mesh programs ---------------------------
        from ..copr.fusion import trace_fused_fragment

        for name, sql in FUSED_FRAGMENT_KERNELS:
            try:
                dag, tr = first_dag(
                    sql, lambda d: trace_fused_fragment(table, d))
                if tr is None:
                    emit(name, "no fused mesh form for the canonical "
                               "fragment — whole-fragment fusion coverage "
                               "regressed")
                    continue
                ok = True
                if name == "fused-mesh-scalar-agg":
                    # the range bounds and the membership epoch are
                    # host-side runtime data: 3 ranges, or a bumped
                    # epoch, run the identical program
                    ok = same(name, tr, trace_fused_fragment(
                        table, dag, n_ranges=3), "the range count")
                    from ..coord import get_plane

                    get_plane().bump("kernelcheck-epoch-guard")
                    ok = same(name, tr, trace_fused_fragment(table, dag),
                              "a membership epoch bump") and ok
                if ok:
                    stats[name] = tr.stats()
            except Exception as e:  # noqa: BLE001 — contract break
                emit(name, f"fused fragment failed: "
                           f"{type(e).__name__}: {e}")

        # -- cold-tier fused program (K2 in the fragment) -----------------
        name = COLD_FRAGMENT_KERNEL
        try:
            sql = dict(CANONICAL_KERNEL_QUERIES)["q6-scalar-agg"]
            dag, tr = first_dag(
                sql, lambda d: trace_fused_fragment(table, d, cold=True))
            if tr is None:
                emit(name, "no cold-packable fused form for the canonical "
                           "fragment — cold-tier decode coverage regressed")
            elif same(name, tr, trace_fused_fragment(
                    table, dag, cold=True, dict_shift=3),
                    "shifted dictionary operands"):
                stats[name] = tr.stats()
        except Exception as e:  # noqa: BLE001 — contract break
            emit(name, f"cold fragment failed: {type(e).__name__}: {e}")

        # -- the CUDA kernels ---------------------------------------------
        for name in CUDA_KERNELS:
            try:
                stats[name] = _cuda_kernel(name).stats()
            except Exception as e:  # noqa: BLE001 — contract break
                emit(name, f"{type(e).__name__}: {e}")

        # -- the micro-batcher's batched program --------------------------
        name = VMAP_BATCH_KERNEL
        try:
            sql = dict(CANONICAL_KERNEL_QUERIES)["q6-scalar-agg"]
            dag, tr = first_dag(sql, lambda d: trace_batch_kernel(table, d))
            if tr is None:
                emit(name, "no device-eligible DAG for the batched program "
                           "— micro-batch coverage regressed")
            elif same(name, tr, trace_batch_kernel(table, dag, masked=True),
                      "the padding mask / bucket-fill values"):
                stats[name] = tr.stats()
        except Exception as e:  # noqa: BLE001 — contract break
            emit(name, f"batched program failed: {type(e).__name__}: {e}")

        # -- context capture: trace spans + lifecycle scope ---------------
        # span hooks and scope checks live OUTSIDE the programs: running
        # them under an active query trace, or a QueryScope with an
        # active deadline, must issue the identical op sequence
        from ..lifecycle import QueryScope, activate_scope, deactivate_scope
        from ..trace import finish_trace, start_trace

        @contextlib.contextmanager
        def active_trace():
            tr, token = start_trace("kernelcheck-instrumented", 0)
            try:
                yield
            finally:
                finish_trace(tr, token)

        @contextlib.contextmanager
        def active_deadline():
            token = activate_scope(QueryScope(timeout_s=3600.0))
            try:
                yield
            finally:
                deactivate_scope(token)

        for name in ("q1-dense-agg", "filter-project"):
            if name not in tile_dags:
                continue
            dag, base = tile_dags[name]
            for suffix, ctx, what in (
                    ("instrumented", active_trace, "an active query trace"),
                    ("scoped", active_deadline, "an active deadline")):
                try:
                    with ctx():
                        tr = trace_kernel(table, dag)
                except Exception as e:  # noqa: BLE001 — contract break
                    emit(f"{name}-{suffix}", f"{suffix} program failed: "
                                             f"{type(e).__name__}: {e}")
                    continue
                same(f"{name}-{suffix}", base, tr, what)

        # -- recompile-bomb guard -----------------------------------------
        # count only entries the corpus itself adds: the caches are
        # process-global, and the bootstrap statements add their own
        census = corpus_census(s, [q for _n, q in CANONICAL_KERNEL_QUERIES])
        if census["rerun"]:
            emit("signature-growth",
                 f"re-running the canonical corpus added "
                 f"{len(census['rerun'])} ProgramCache entr(ies) — a "
                 "recompile bomb (fingerprints must be stable across "
                 "identical queries)")
        if census["traced"]:
            emit("trace-capture",
                 f"running the corpus under an active query trace added "
                 f"{len(census['traced'])} ProgramCache entr(ies) — span "
                 "hooks must stay outside the programs")
        if census["builds"]:
            emit("signature-growth",
                 f"re-running the canonical corpus started "
                 f"{census['builds']} nvcc build(s)")
        stats["__signatures__"] = {"max": len(census["first"])}
    return stats, findings


def compare_stats(stats: Dict[str, dict],
                  baseline_kernels: Dict[str, dict]) -> List[Finding]:
    """Findings for programs missing from the baseline, i64_ops growth
    past it, and a corpus over its `__signatures__` cap."""
    out: List[Finding] = []

    def emit(kernel: str, msg: str):
        out.append(Finding(rule=RULE, path="tidb_tpu_torch/copr", line=0,
                           scope=kernel, token="trace", message=msg))

    for name, st in sorted(stats.items()):
        if name == "__signatures__":
            continue
        base = baseline_kernels.get(name)
        if base is None:
            emit(name, f"program not in baseline (measured {st}); run "
                       "python -m tidb_tpu_torch.lint --update-baseline")
        elif st["i64_ops"] > int(base.get("i64_ops", 0)):
            emit(name, f"int64 op count grew {base.get('i64_ops')} -> "
                       f"{st['i64_ops']}: an int64 op chain was added to "
                       "the program")
    n_sigs = stats.get("__signatures__", {}).get("max")
    base_sigs = baseline_kernels.get("__signatures__", {}).get("max")
    if base_sigs is None:
        emit("signature-growth", "no __signatures__ entry in baseline; run "
                                 "python -m tidb_tpu_torch.lint "
                                 "--update-baseline")
    elif n_sigs is not None and n_sigs > int(base_sigs):
        emit("signature-growth",
             f"canonical corpus now adds {n_sigs} ProgramCache entries "
             f"(baseline {base_sigs}) — new programs on the hot path; "
             "justify and refresh the baseline if intended")
    return out


def lint_kernels(baseline_kernels: Optional[Dict[str, dict]] = None,
                 collect_stats: Optional[Dict[str, dict]] = None,
                 device: str = "cuda") -> List[Finding]:
    """Run the canonical corpus on `device`; returns findings for
    contract breaks, divergences, recompiles and i64_ops growth against
    `baseline_kernels` (default: the checked-in baseline's section for
    `device`).  collect_stats, when a dict, receives the measured stats
    instead of the growth comparison (the --update-baseline path)."""
    from .baseline import kernel_stats, load_baseline

    stats, findings = measure_kernels(device)
    if collect_stats is not None:
        collect_stats.update(stats)
        return findings
    if baseline_kernels is None:
        baseline_kernels = kernel_stats(load_baseline(), device)
    return findings + compare_stats(stats, baseline_kernels)

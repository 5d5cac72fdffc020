"""The port's static analysis (`tidb_tpu_torch.lint`) against the JAX
package's (`tidb_tpu.lint`), on the CPU (`--device cpu` semantics).

- AST passes: each framework-neutral specimen of tests/test_lint.py goes
  as the same source text to `tidb_tpu.lint.<pass>` and to the port's
  pass; the finding keys must be equal once the package prefix is
  mapped (`tidb_tpu_torch/` -> `tidb_tpu/`).  One parametrised test a
  pass, a case a specimen.
- Purity in PyTorch terms: each rule caught, each clean counterpart
  passing.
- The canonical programs of `tidb_tpu_torch.mpp.exchange`: the 3-way
  ladder against the JAX package's numpy `tree_join_oracle`, the
  exchange joins and the grouped merge against numpy on seeded inputs.
- The kernel family: contract failures caught (a shape-broken program,
  int64 growth, an operand-value divergence, a corpus re-run that adds a
  ProgramCache entry), and the whole tree clean against the port's
  baseline; the entry point refuses to run the kernel family on the
  host unless asked.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from tidb_tpu_torch import ops

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ops.use_device("cpu")


def _port(src: str) -> str:
    return src.replace("tidb_tpu", "tidb_tpu_torch")


def _keys(findings, port: bool):
    from tidb_tpu.lint import assign_ordinals

    out = [f.key for f in assign_ordinals(list(findings))]
    if port:
        out = [k.replace("tidb_tpu_torch/", "tidb_tpu/") for k in out]
    return sorted(out)


# ---------------------------------------------------------------------------
# AST passes: the JAX package's framework-neutral specimens
# ---------------------------------------------------------------------------

#: tests/test_lint.py:444-665 — (source, ranks) per concur specimen
CONCUR_SPECIMENS = {
    "unregistered-lock": ("""
        import threading

        class C:
            def __init__(self):
                self._mu = threading.Lock()
    """, None),
    "rank-inverting-nested-with": ("""
        from tidb_tpu.util_concurrency import make_lock

        class C:
            def __init__(self):
                self._a = make_lock("mymod:C._a")
                self._b = make_lock("mymod:C._b")

            def f(self):
                with self._a:
                    with self._b:
                        pass
    """, {"mymod:C._a": 2, "mymod:C._b": 1}),
    "consistent-nested-with": ("""
        from tidb_tpu.util_concurrency import make_lock

        class C:
            def __init__(self):
                self._a = make_lock("mymod:C._a")
                self._b = make_lock("mymod:C._b")

            def f(self):
                with self._a:
                    with self._b:
                        pass
    """, {"mymod:C._a": 1, "mymod:C._b": 2}),
    "sleep-under-lock": ("""
        import time

        from tidb_tpu.util_concurrency import make_lock

        class C:
            def __init__(self):
                self._mu = make_lock("mymod:C._mu")

            def f(self):
                with self._mu:
                    time.sleep(0.1)
    """, {"mymod:C._mu": 1}),
    "guarded-attr-read-bare": ("""
        from tidb_tpu.util_concurrency import make_lock

        class C:
            def __init__(self):
                self._mu = make_lock("mymod:C._mu")
                self.x = 0

            def bump(self):
                with self._mu:
                    self.x += 1

            def peek(self):
                return self.x
    """, {"mymod:C._mu": 1}),
    "cross-object-guard-unheld-store": ("""
        from tidb_tpu.util_concurrency import make_lock

        class _Job:
            _guarded_by_ = "mymod:Plane._mu"

            def __init__(self):
                self.items = []
                self.closed = False

        class Plane:
            def __init__(self):
                self._mu = make_lock("mymod:Plane._mu")
                self._jobs = {}

            def good(self, key):
                with self._mu:
                    j = _Job()
                    j.items.append(key)
                    self._jobs[key] = j

            def bad(self, key):
                j = _Job()
                j.closed = True
                j.items.append(key)
                with self._mu:
                    self._jobs[key] = j
    """, {"mymod:Plane._mu": 1}),
    "cross-object-guard-lockfree-loads": ("""
        import threading

        from tidb_tpu.util_concurrency import make_lock

        class _Job:
            _guarded_by_ = "mymod:Plane._mu"

            def __init__(self):
                self.items = []
                self.done = threading.Event()

        class Plane:
            def __init__(self):
                self._mu = make_lock("mymod:Plane._mu")

            def peek(self, j: "_Job"):
                return len(j.items), j.done.is_set()

            def _push_locked(self, j: "_Job", key):
                j.items.append(key)
    """, {"mymod:Plane._mu": 1}),
    "wait-whose-notifier-needs-held-lock": ("""
        import threading

        from tidb_tpu.util_concurrency import make_lock

        class C:
            def __init__(self):
                self._mu = make_lock("mymod:C._mu")
                self._cv = threading.Condition()

            def consume(self):
                with self._mu:
                    with self._cv:
                        self._cv.wait()

            def produce(self):
                with self._mu:
                    with self._cv:
                        self._cv.notify()
    """, {"mymod:C._mu": 1}),
    "wait-lock-released-first": ("""
        import threading

        from tidb_tpu.util_concurrency import make_lock

        class C:
            def __init__(self):
                self._mu = make_lock("mymod:C._mu")
                self._cv = threading.Condition()

            def consume(self):
                with self._cv:
                    self._cv.wait()

            def produce(self):
                with self._mu:
                    pass
                with self._cv:
                    self._cv.notify()
    """, {"mymod:C._mu": 1}),
}


#: the rule each concur specimen exercises, and whether it fires
CONCUR_RULES = {
    "unregistered-lock": ("lock-rank", True),
    "rank-inverting-nested-with": ("lock-order", True),
    "consistent-nested-with": ("lock-order", False),
    "sleep-under-lock": ("lock-blocking", True),
    "guarded-attr-read-bare": ("lock-guard", True),
    "cross-object-guard-unheld-store": ("lock-guard", True),
    "cross-object-guard-lockfree-loads": ("lock-guard", False),
    "wait-whose-notifier-needs-held-lock": ("lock-wait", True),
    "wait-lock-released-first": ("lock-wait", False),
}


@pytest.mark.parametrize("name", sorted(CONCUR_SPECIMENS))
def test_concur_keys_equal_the_jax_package(name):
    from tidb_tpu.lint.concur import lint_source as jax_lint
    from tidb_tpu_torch.lint.concur import lint_source as port_lint

    src, ranks = CONCUR_SPECIMENS[name]
    src = textwrap.dedent(src)
    want = _keys(jax_lint(src, "tidb_tpu/mymod.py", ranks=ranks), False)
    got = _keys(port_lint(_port(src), "tidb_tpu_torch/mymod.py",
                          ranks=ranks), True)
    assert got == want
    # each specimen's rule fires on the fault and stays quiet on the
    # clean form
    rule, caught = CONCUR_RULES[name]
    assert any(k.startswith(rule + ":") for k in got) == caught, got


#: tests/test_lint.py:386 — the metric-name specimen
METRIC_SPECIMEN = """
    from tidb_tpu.metrics import REGISTRY

    def f(cls):
        REGISTRY.inc("Bad-Name")
        REGISTRY.inc("queries_served")
        REGISTRY.inc("queries_served_total")
        REGISTRY.observe_hist("lat_ms", 1.0)
        REGISTRY.observe_hist("lat", 1.0)
        REGISTRY.set("queue_depth", 3)
        REGISTRY.inc(f"slo_{cls}_breach_total")
        REGISTRY.inc(f"trace_phase_{cls}")
"""


@pytest.mark.parametrize("specimen", ["metric-names"])
def test_metric_name_keys_equal_the_jax_package(specimen):
    from tidb_tpu.lint.metricnames import lint_source as jax_lint
    from tidb_tpu_torch.lint.metricnames import lint_source as port_lint

    src = textwrap.dedent(METRIC_SPECIMEN)
    want = _keys(jax_lint(src, "tidb_tpu/x.py"), False)
    got = _keys(port_lint(_port(src), "tidb_tpu_torch/x.py"), True)
    assert got == want
    assert {k.split(":")[3].split("#")[0] for k in got} == {
        "Bad-Name", "queries_served", "lat"}


#: tests/test_lint.py:46 and :146 — the purity specimens that no device
#: framework shapes: key stability under line drift (the JAX package's
#: `import jax` is the port's `import torch`: each pass's device-value
#: provenance) and the two row-loop forms
ROW_LOOP_CHECKSUM = """
    import zlib

    def _checksum_table(store, dele):
        crc = kvs = nbytes = 0
        n = store.base_rows
        step = 1 << 16
        for lo in range(0, n, step):
            chunk = store.base_chunk(range(store.n_cols), lo,
                                     min(lo + step, n))
            for off, row in enumerate(chunk.to_pylist()):
                if lo + off in dele:
                    continue
                raw = repr(row).encode()
                crc ^= zlib.crc32(raw)
                kvs += 1
                nbytes += len(raw)
        return crc, kvs, nbytes
"""
ROW_LOOP_RANGE = """
    def agg(chunk):
        total = 0
        for i in range(chunk.num_rows):
            total += chunk.col(0).get(i)
        return total
"""
DRIFT = ("import jax\nimport numpy as np\n\ndef f(x):\n"
         "    a = np.asarray(x)\n    b = np.asarray(x)\n    return a, b\n")
DRIFT_SHIFTED = ("import jax\nimport numpy as np\n\n# pushed down two lines"
                 "\n\ndef f(x):\n    a = np.asarray(x)\n"
                 "    b = np.asarray(x)\n    return a, b\n")
PURITY_SPECIMENS = {
    "row-loop-checksum": (ROW_LOOP_CHECKSUM, "executor/seeded.py"),
    "row-loop-range": (ROW_LOOP_RANGE, "executor/seeded2.py"),
    "line-drift": (DRIFT, "copr/x.py"),
    "line-drift-shifted": (DRIFT_SHIFTED, "copr/x.py"),
}


@pytest.mark.parametrize("name", sorted(PURITY_SPECIMENS))
def test_purity_keys_equal_the_jax_package(name):
    from tidb_tpu.lint.purity import lint_source as jax_lint
    from tidb_tpu_torch.lint.purity import lint_source as port_lint

    src, rel = PURITY_SPECIMENS[name]
    src = textwrap.dedent(src)
    want = _keys(jax_lint(src, "tidb_tpu/" + rel), False)
    port_src = src.replace("import jax\n", "import torch\n")
    got = _keys(port_lint(port_src, "tidb_tpu_torch/" + rel), True)
    assert got and got == want


def test_purity_keys_stable_under_line_drift():
    from tidb_tpu_torch.lint.purity import lint_source

    port = [s.replace("import jax\n", "import torch\n")
            for s in (DRIFT, DRIFT_SHIFTED)]
    k1, k2 = (_keys(lint_source(s, "tidb_tpu_torch/copr/x.py"), True)
              for s in port)
    assert k1 == k2 and len(set(k1)) == 2


def _chaos_tree(root: Path, pkg: str, test_name: str):
    (root / pkg / "sub").mkdir(parents=True)
    (root / pkg / "names.py").write_text(
        'SHARED_FAILPOINT = "store/shared_site"\n')
    (root / pkg / "sub" / "mod.py").write_text(textwrap.dedent("""
        from ..names import SHARED_FAILPOINT

        LOCAL_FP = "store/local_site"

        def f(x):
            FAILPOINTS.hit("store/covered_site", a=1)
            FAILPOINTS.hit("store/orphan_site")
            FAILPOINTS.hit(LOCAL_FP)
            FAILPOINTS.hit(SHARED_FAILPOINT)
            FAILPOINTS.hit("x/" + x)
    """))
    (root / "tests").mkdir()
    (root / "tests" / test_name).write_text(
        "# arms store/covered_site and store/shared_site\n")


@pytest.mark.parametrize("specimen", ["chaos-cover-tree"])
def test_chaos_cover_keys_equal_the_jax_package(tmp_path, specimen):
    """tests/test_lint.py:673's tree; the port reads only its own tests
    (tests/test_torch_*.py), so its tree names the test file so."""
    from tidb_tpu.lint.chaoscover import lint_tree as jax_lint
    from tidb_tpu_torch.lint.chaoscover import lint_tree as port_lint

    _chaos_tree(tmp_path / "jax", "tidb_tpu", "test_mod.py")
    _chaos_tree(tmp_path / "port", "tidb_tpu_torch", "test_torch_mod.py")
    want = _keys(jax_lint(str(tmp_path / "jax")), False)
    got = _keys(port_lint(str(tmp_path / "port")), True)
    assert got == want and len(got) == 3


def test_chaos_cover_ignores_the_jax_package_tests(tmp_path):
    """A JAX package test that arms a failpoint does not cover the
    port's site."""
    from tidb_tpu_torch.lint.chaoscover import lint_tree

    _chaos_tree(tmp_path, "tidb_tpu_torch", "test_mod.py")
    tokens = {f.token for f in lint_tree(str(tmp_path))}
    assert {"store/covered_site", "store/shared_site"} <= tokens


def test_pass_families_are_the_jax_package_families():
    from tidb_tpu.lint import PASS_RULES as JAX_RULES
    from tidb_tpu_torch.lint import PASS_RULES

    assert PASS_RULES == JAX_RULES


# ---------------------------------------------------------------------------
# purity in PyTorch terms: each rule caught, each clean counterpart clean
# ---------------------------------------------------------------------------

PURITY_TORCH = {
    "host-sync": ("""
        import numpy as np
        import torch

        def fetch(t):
            n = t.sum().item()
            rows = t.tolist()
            host = t.cpu()
            also = t.to("cpu")
            torch.cuda.synchronize()
            idx = torch.nonzero(t)
            return n, rows, host, also, np.asarray(t), idx
    """, """
        import numpy as np
        import torch

        from .cache import ProgramCache

        _COMPILED = ProgramCache("x")

        def run(fp, args):
            fn = _COMPILED.get(fp)
            out = fn(*args)
            buf = torch.zeros(8)              # made on the host
            return out.cpu().numpy(), buf.numpy(), np.asarray(out)

        def host_only(vals):                  # no torch: host values
            return vals
    """),
    "tracer-coercion": ("""
        import torch

        def _build_tile_fn(an):
            def fn(x):
                return x * float(x.sum())
            return fn
    """, """
        import torch

        def _build_tile_fn(an):
            def fn(x):
                return x * x.sum()
            return fn

        def host(x):
            return float(x.sum())             # not a program body
    """),
    "rng-in-jit": ("""
        import numpy as np
        import torch

        def _build_mesh_core(an):
            def core(x):
                return x + np.random.uniform()
            return core
    """, """
        import numpy as np
        import torch

        def _build_mesh_core(an):
            def core(x, noise):
                return x + noise              # an operand
            return core
    """),
    "time-in-jit": ("""
        import time

        import torch

        def _build_mpp_fn(spec):
            def prog(x):
                t0 = time.perf_counter()
                return x, t0
            return prog
    """, """
        import time

        import torch

        def _build_mpp_fn(spec):
            def prog(x):
                return x
            return prog

        def dispatch(fn, x):
            t0 = time.perf_counter()          # around the program
            return fn(x), time.perf_counter() - t0
    """),
    "static-unhashable": ("""
        import torch

        from .cache import ProgramCache

        _COMPILED = ProgramCache("x")

        def run(cols, fn):
            if _COMPILED.get([1, 2]) is None:
                _COMPILED.put({"cols": cols}, fn)
    """, """
        import torch

        from .cache import ProgramCache

        _COMPILED = ProgramCache("x")

        def run(cols, fn):
            fp = f"cols={cols}"
            if _COMPILED.get(fp) is None:
                _COMPILED.put(fp, fn)
            cache = {}
            cache.get([1, 2][0])              # not a ProgramCache
    """),
}


@pytest.mark.parametrize("rule", sorted(PURITY_TORCH))
def test_purity_rule_caught_and_clean_counterpart_passes(rule):
    from tidb_tpu_torch.lint.purity import lint_source

    bad, good = (textwrap.dedent(s) for s in PURITY_TORCH[rule])
    fs = lint_source(bad, "tidb_tpu_torch/copr/seeded.py")
    assert fs and {f.rule for f in fs} == {rule}, fs
    assert lint_source(good, "tidb_tpu_torch/copr/seeded.py") == []


def test_host_sync_catches_every_read():
    from tidb_tpu_torch.lint.purity import lint_source

    src = textwrap.dedent(PURITY_TORCH["host-sync"][0])
    tokens = sorted(f.token for f in
                    lint_source(src, "tidb_tpu_torch/copr/seeded.py"))
    assert tokens == [".cpu", ".item", ".to(cpu)", ".tolist",
                      "np.asarray", "torch.cuda.synchronize",
                      "torch.nonzero"]


# ---------------------------------------------------------------------------
# the canonical programs of tidb_tpu_torch.mpp.exchange
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shift", [0, 3])
def test_tree_ladder_equals_the_jax_package_oracle(shift):
    """The port's canonical 3-way ladder, executed, against the JAX
    package's numpy oracle (its JAX ladder is not run: 48 s on a CPU)."""
    from tidb_tpu.mpp.exchange import tree_join_oracle
    from tidb_tpu_torch.mpp.exchange import run_tree_join_kernel

    over, jover, total = run_tree_join_kernel(shift)
    want = tree_join_oracle(shift)
    assert (over, jover) == (0, 0)
    assert total == pytest.approx(want, rel=1e-9)


def _t(a):
    return [torch.from_numpy(np.ascontiguousarray(a))]


@pytest.mark.parametrize("mode", ["shuffle", "broadcast"])
def test_canonical_exchange_join_equals_numpy(mode):
    """Seeded keys and masks (40 live rows a side, so the canonical
    capacities hold every row and pair): the matched pairs and the
    payload they carry equal a numpy inner join."""
    from tidb_tpu_torch.mpp.exchange import (_JOIN_KERNEL_SHAPE,
                                             _canonical_join_fn)

    S, cap, n = _JOIN_KERNEL_SHAPE
    rng = np.random.default_rng(11)
    pk = rng.integers(0, 48, n).astype(np.int64)
    bk = rng.integers(0, 48, n).astype(np.int64)
    pm = np.zeros(n, bool)
    pm[rng.choice(n, 40, replace=False)] = True
    bm = np.zeros(n, bool)
    bm[rng.choice(n, 40, replace=False)] = True
    pv = rng.uniform(0, 1, n)
    over, jover, matched, payload = _canonical_join_fn(S, cap, n, mode)(
        _t(pk), _t(pm), _t(bk), _t(bm), _t(pv))
    eq = (pk[:, None] == bk[None, :]) & pm[:, None] & bm[None, :]
    assert int(over) == 0 and int(jover) == 0
    assert int(matched[0].sum()) == int(eq.sum())
    want = float((eq * pv[None, :]).sum())
    assert float(payload[0].sum()) == pytest.approx(want, rel=1e-12)


def test_canonical_grouped_merge_equals_numpy_groupby():
    """Seeded keys (NULL flags included) and measures: the merged groups'
    counts and float sums equal a numpy groupby over the selected rows,
    and the budget slot reports overflow only past the group count."""
    from tidb_tpu_torch.mpp.exchange import _canonical_grouped_fn

    n, cap_g = 256, 32
    rng = np.random.default_rng(12)
    gk = rng.integers(0, 20, n).astype(np.int64)
    gv = rng.random(n) < 0.9
    meas = rng.uniform(-5, 5, n)
    mm = rng.random(n) < 0.8
    fn = _canonical_grouped_fn(1, n, cap_g)
    over_l, out = fn(_t(gk), _t(gv), _t(meas), _t(mm),
                     torch.tensor(64, dtype=torch.int64))
    over_m, n_uniq, (keys, flags), (cnt, (sums, _sc)) = out[0]
    want = {}
    for k, v, x, m in zip(gk, gv, meas, mm):
        if m:
            want.setdefault((int(k) if v else 0, bool(v)), []).append(x)
    k = int(n_uniq[0])
    assert k == len(want) and int(over_l) == 0 and int(over_m[0]) == 0
    got = {(int(keys[i]), bool(flags[i])): (int(cnt[i]), float(sums[i]))
           for i in range(k)}
    assert set(got) == set(want)
    for g, xs in want.items():
        assert got[g][0] == len(xs)
        assert got[g][1] == pytest.approx(float(np.sum(xs)), rel=1e-12,
                                          abs=1e-12)
    over_l, out = fn(_t(gk), _t(gv), _t(meas), _t(mm),
                     torch.tensor(k - 2, dtype=torch.int64))
    assert int(over_l) == 2 and int(out[0][0][0]) == 2


# ---------------------------------------------------------------------------
# the kernel family
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def whole_tree():
    """One `run_all` of every family over tidb_tpu_torch/ on the CPU."""
    from tidb_tpu_torch.lint import run_all

    return run_all(device="cpu")


def test_whole_tree_clean_against_the_port_baseline(whole_tree):
    """`python -m tidb_tpu_torch.lint --device cpu` semantics: no finding
    outside the port's baseline allowlist, and no stale entry."""
    from tidb_tpu_torch.lint import PASS_RULES
    from tidb_tpu_torch.lint.baseline import apply, load_baseline

    findings = whole_tree
    ran = {r for rules in PASS_RULES.values() for r in rules}
    new, stale = apply(findings, load_baseline(), ran_rules=ran)
    assert not new, "\n".join(f.render() for f in new)
    assert not stale, stale


def test_baseline_names_only_the_port():
    from tidb_tpu_torch.lint.baseline import load_baseline

    b = load_baseline()
    assert all(k.split(":")[1].startswith("tidb_tpu_torch/")
               for k in b["allow"])
    assert all(reason.strip() for reason in b["allow"].values())
    assert set(b["kernels"]) == {"cpu", "cuda"}
    # no lock-rank, lock-order or lock-wait finding is allowlisted
    assert not [k for k in b["allow"]
                if k.split(":")[0] in ("lock-rank", "lock-order",
                                       "lock-wait")]


def test_int64_growth_is_caught():
    """The CPU stats of the checked-in baseline against a zeroed one:
    every program with an int64 op grows, and a corpus past its
    ProgramCache cap is a finding."""
    from tidb_tpu_torch.lint.baseline import kernel_stats, load_baseline
    from tidb_tpu_torch.lint.kernelcheck import compare_stats

    stats = kernel_stats(load_baseline(), "cpu")
    zeroed = {n: {"i64_ops": 0} for n in stats if n != "__signatures__"}
    zeroed["__signatures__"] = {"max": 10_000}
    growth = [f for f in compare_stats(stats, zeroed)
              if "int64 op count grew" in f.message]
    assert {f.scope for f in growth} == {
        n for n, st in stats.items()
        if n != "__signatures__" and st["i64_ops"] > 0}
    assert compare_stats(stats, stats) == []
    tight = dict(zeroed, __signatures__={"max": 0})
    assert any("ProgramCache entries" in f.message
               for f in compare_stats(stats, tight))


def test_shape_broken_program_raises():
    from tidb_tpu_torch.copr.ir import SelectionIR
    from tidb_tpu_torch.expr.expression import ColumnExpr
    from tidb_tpu_torch.lint.kernelcheck import _reader_dags, trace_kernel
    from tidb_tpu_torch.lint.plancheck import _canonical_session
    from tidb_tpu_torch.parser import parse_one

    s = _canonical_session()
    dom = s.domain
    table = dom.storage.table(
        dom.catalog.info_schema().table("test", "lineitem").id)
    phys = s._plan(parse_one("select sum(l_quantity) from lineitem"
                             " where l_discount < 0.05"))
    _p, dag = _reader_dags(phys)[0]
    assert trace_kernel(table, dag).stats()["ops"] > 0
    sel = next(ex for ex in dag.executors if isinstance(ex, SelectionIR))

    def break_refs(e):
        if isinstance(e, ColumnExpr):
            e.index = 99  # a ref past every scanned column
        for a in getattr(e, "args", ()):
            break_refs(a)

    for c in sel.conditions:
        break_refs(c)
    with pytest.raises(Exception):
        trace_kernel(table, dag)


def test_value_divergence_and_corpus_recompile_are_caught(monkeypatch):
    """A grouped program whose op sequence moves with the budget value,
    and mesh fingerprints that change on every statement (a re-run of
    the corpus then adds ProgramCache entries): both are findings."""
    from tidb_tpu_torch.copr import parallel
    from tidb_tpu_torch.lint.kernelcheck import measure_kernels
    from tidb_tpu_torch.mpp import exchange

    real = exchange._canonical_grouped_fn

    def baked(S, cap_out, cap_g):
        fn = real(S, cap_out, cap_g)

        def shard_fn(gk, gv, meas, mm, gbudget):
            for _ in range(int(gbudget)):   # the budget shapes the program
                meas = [m + 0.0 for m in meas]
            return fn(gk, gv, meas, mm, gbudget)

        return shard_fn

    calls = iter(range(1 << 30))
    fp = parallel._fingerprint
    monkeypatch.setattr(exchange, "_canonical_grouped_fn", baked)
    monkeypatch.setattr(parallel, "_fingerprint",
                        lambda an, kind: fp(an, kind) + f"|{next(calls)}")
    _stats, findings = measure_kernels("cpu")
    scopes = {f.scope for f in findings}
    assert "mpp-grouped-agg-merge" in scopes
    assert any("group-budget" in f.message for f in findings)
    assert "signature-growth" in scopes and "trace-capture" in scopes


def test_kernel_family_without_a_card_refuses_to_run_on_the_host():
    """No `--device cpu`, no card: exit non-zero, naming the device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "tidb_tpu_torch.lint", "--passes", "kernel"],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert "new finding" not in out.stdout

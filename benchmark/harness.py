"""One run of one cell: set-up, the measured window, the check against
the plain references, the metrics.

Everything a cell is made of is found by name from `BENCHMARK.json` and
the files beside this module: the configuration (tables, generators,
sizes, packed widths, settings), the workload (streams, loop, statement
shapes), each shape (SQL template, samplers, columns read, reference)
and each per-layer metric's reader.  Adding a cell, a shape or a metric
adds files; it edits none here.

The program under test is the PyTorch port, `tidb_tpu_torch`: its
bulk-load entry, its SQL session for DDL, and its MySQL wire server,
which serves every statement of the window.  Nothing here reads the
program's results except over the wire, and the references take only
the generated arrays."""

from __future__ import annotations

import asyncio
import gc
import importlib
import json
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from benchmark import profile_events as pe
from benchmark import traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names no run may load: the JAX stack and the JAX
#: package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "tidb_tpu")
#: statements drawn for each stream; a stream that sends them all in one
#: window starts from its first again
PER_STREAM = 512
#: how long a statement sent in the window may take to answer past the
#: close before it counts as never answered
DRAIN_S = 60.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules(names) -> list:
    """The module names whose top-level package (the part before the
    first dot, whole) is one of FORBIDDEN."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_module(path: Path):
    """The module in `path`, imported as `benchmark.<dir>.<stem>`."""
    rel = path.resolve().relative_to(ROOT).with_suffix("")
    return importlib.import_module(".".join(rel.parts))


@dataclass
class Cell:
    """Everything one cell's files say, found by name."""

    name: str
    config: dict
    workload: dict
    shapes: dict
    end_to_end: list
    per_layer: list
    readers: dict = field(default_factory=dict)


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = traffic.load_json(bench_path)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {bench_path.name}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = traffic.load_json(ROOT / cfg_entry["file"])
    workload = traffic.load_json(HERE / "workloads" / f"{entry['traffic']}.json")
    shapes = {}
    for s in workload["shapes"]:
        spec = traffic.load_json(HERE / "shapes" / f"{s}.json")
        spec["module"] = load_module(HERE / "shapes" / f"{s}.py")
        shapes[s] = spec

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    cell = Cell(name, config, workload, shapes,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])
    for m in cell.end_to_end + cell.per_layer:
        cell.readers[m["name"]] = load_module(HERE / "metrics" / f"{m['name']}.py")
    return cell


def stmt_cost(shape: dict, config: dict, rows: dict) -> tuple:
    """(base-table rows a statement of `shape` reads, the bytes of its
    scanned columns at their packed widths)."""
    tables = {t["name"]: t for t in config["tables"]}
    n, nbytes = 0, 0.0
    for table, cols in shape["reads"].items():
        n += rows[table]
        bits = sum(tables[table]["packed_bits"][c] for c in cols)
        nbytes += rows[table] * bits / 8
    return n, nbytes


class ServerThread:
    """The port's MySQLServer in this process, on an event loop of its
    own thread, listening on a free loopback port."""

    def __init__(self, domain):
        from tidb_tpu_torch.server import MySQLServer

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name="bench-server", daemon=True)
        self.thread.start()
        self.srv = MySQLServer(domain, host="127.0.0.1", port=0)
        asyncio.run_coroutine_threadsafe(self.srv.start(), self.loop).result(60)

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.srv.stop(), self.loop).result(120)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)
        self.loop.close()
        self.srv.pool.shutdown(wait=True)


def build_tables(sess, config: dict, seed: int, scale: float,
                 device: str) -> dict:
    """Generate the configuration's tables from the seed at scale factor
    `scale`, create each, bulk-load it through the port's
    `tpch_data.load_arrays`, split and analyze it as the configuration
    says, then let the port put every column on the card, as it does
    after a user's bulk load (`prefetch_table`, the default of
    `tidb_tpu_prefetch`).  Returns {table: {column: numpy array}}."""
    from tidb_tpu_torch import tpch_data
    from tidb_tpu_torch.copr.parallel import prefetch_table

    gen = load_module(HERE / "generators" / f"{config['generator']}.py")
    t0 = time.perf_counter()
    made = gen.generate(scale, traffic.seed_for(seed, config["seed_salt"]),
                        [t["name"] for t in config["tables"]], device)
    log(f"set-up: tables generated in {time.perf_counter() - t0:.2f} s")
    out = {}
    for t in config["tables"]:
        arrays, dicts = made.pop(t["name"])
        t1 = time.perf_counter()
        sess.execute(t["ddl"])
        tpch_data.load_arrays(sess, t["name"], arrays, dicts)
        t2 = time.perf_counter()
        if t["regions"] > 1:
            sess.execute(f"split table {t['name']} regions {t['regions']}")
        if t["analyze"]:
            sess.execute(f"analyze table {t['name']}")
        log(f"set-up: {t['name']} {len(arrays[0])} rows loaded in "
            f"{t2 - t1:.2f} s, split/analyzed in "
            f"{time.perf_counter() - t2:.2f} s")
        out[t["name"]] = dict(zip(gen.COLUMNS[t["name"]], arrays))
    t0 = time.perf_counter()
    info = sess.domain.catalog.info_schema()
    for t in config["tables"]:
        prefetch_table(sess.domain.storage, info.table("test", t["name"]).id)
    for th in threading.enumerate():
        if th.name == "tidb-tpu-prefetch":
            th.join()
    log(f"set-up: columns resident in {time.perf_counter() - t0:.2f} s")
    return out


async def _explain(host, port, sqls: dict) -> dict:
    """EXPLAIN ANALYZE of one statement of each shape: the route the
    planner took and the dispatch chunks it ran."""
    from benchmark.client import Connection

    conn = await Connection.open(host, port, "test")
    routes = {}
    for shape, sql in sqls.items():
        rows = await conn.query("explain analyze " + sql)
        routes[shape] = [" | ".join(str(v) for v in r if v) for r in rows]
    await conn.close()
    return routes


def log_routes(routes: dict):
    for shape, lines in routes.items():
        for ln in lines:
            log(f"route {shape}: {ln}")


def compare(got: list, want: list, ordered: bool) -> int:
    """Values that differ between two result sets (a missing or extra
    row counts each of its values)."""
    if not ordered:
        got = sorted((tuple(r) for r in got), key=repr)
        want = sorted((tuple(r) for r in want), key=repr)
    bad = 0
    for a, b in zip(got, want):
        bad += sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    longer = got[len(want):] if len(got) > len(want) else want[len(got):]
    return bad + sum(len(r) for r in longer)


@dataclass
class Window:
    """What the metric readers read.  Each statement is a dict: `shape`,
    `t_send`, `t_done` (seconds, host monotonic clock), `ok`,
    `rows_read`, `bytes_least`."""

    seconds: float
    setup_s: float
    #: statements sent in the window and answered (some after its close)
    stmts: list = field(default_factory=list)
    #: statements answered before the window closed
    in_window: list = field(default_factory=list)
    #: the traced run's: device trace, program spans, statement traces,
    #: counter moves, the card's published peaks
    trace: object = None
    spans: list = field(default_factory=list)
    n_traces: int = 0
    counters: dict = field(default_factory=dict)
    peaks: object = None


class GcTimes:
    """The serving process's garbage collections (start, end, generation)
    while a traced window runs: a host pause the device waits through."""

    def __init__(self):
        self.done, self._start = [], None

    def record(self, phase, info):
        now = time.perf_counter_ns()
        if phase == "start":
            self._start = now
        elif self._start is not None:
            self.done.append((self._start, now, info["generation"]))
            self._start = None

    def longest(self, n):
        return sorted(self.done, key=lambda c: c[0] - c[1])[:n]


def card_line(device: str) -> str:
    if device != "cuda":
        return "cpu"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", scale: float = None,
             bench_path: Path = ROOT / "BENCHMARK.json") -> dict:
    """One run of cell `name`; returns the result object.  `scale`
    overrides the configuration's scale factor (tests run cells small on
    the CPU).  Raises ForbiddenImport, and returns nothing, when a
    module of the JAX stack or the JAX package has been loaded by the
    time the result is made."""
    import torch

    from tidb_tpu_torch import ops
    from tidb_tpu_torch.metrics import REGISTRY
    from tidb_tpu_torch.session import Domain
    from tidb_tpu_torch.trace import recorder

    cuda = device == "cuda"
    gc_times = GcTimes()
    cell = load_cell(name, bench_path)
    if cell.workload.get("loop", "closed") != "closed":
        raise ValueError(f"{name}: only closed loops are driven")
    scale = cell.config["scale_factor"] if scale is None else scale
    log(f"card: {card_line(device)}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; cell {name}, seed {seed}, {seconds} s, "
        f"trace {int(trace)}")

    # ---- set-up -------------------------------------------------------
    ops.use_device(device)
    domain = Domain()
    sess = domain.new_session()
    for sql in cell.config.get("settings", []) + cell.workload.get("settings", []):
        sess.execute(sql)
    data = build_tables(sess, cell.config, seed, scale, device)
    rows = {t: len(next(iter(cols.values()))) for t, cols in data.items()}
    server = ServerThread(domain)
    host, port = server.srv.host, server.srv.port
    streams = traffic.streams(cell.workload, cell.shapes, seed, PER_STREAM)
    warm = traffic.streams(cell.workload, cell.shapes, seed,
                           cell.workload["warm_per_shape"] * len(cell.shapes),
                           salt=1)
    one_each = {}
    for st in warm:
        for shape, sql, _p in st:
            one_each.setdefault(shape, sql)

    # ---- the window's client process, its connections warmed up --------
    t0 = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-m", "benchmark.client"],
                             cwd=ROOT, stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, text=True)
    try:
        spec = {"host": host, "port": port, "db": "test", "seconds": seconds,
                "drain_s": DRAIN_S,
                "warm": [[sql for _s, sql, _p in st] for st in warm],
                "streams": [[sql for _s, sql, _p in st] for st in streams]}
        child.stdin.write(json.dumps(spec) + "\n")
        child.stdin.flush()
        if child.stdout.readline().strip() != "ready":
            raise RuntimeError("the client process did not log in")
        log_routes(asyncio.run(_explain(host, port, one_each)))
        log(f"set-up: warm-up {time.perf_counter() - t0:.2f} s")
        gc.collect()  # every window starts from the same collector state
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start

        # ---- the window -------------------------------------------------
        traces, prof = [], None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            recorder.chain_export_hook(traces.append)
        snap0 = REGISTRY.snapshot()
        if prof is not None:
            gc.callbacks.append(gc_times.record)
            prof.__enter__()
            offset = time.time_ns() - time.perf_counter_ns()
        t_go = time.perf_counter_ns()
        child.stdin.write("go\n")
        child.stdin.flush()
        out = json.loads(child.stdout.readline())
        if cuda:
            torch.cuda.synchronize()
        t_end = time.perf_counter_ns()
        if prof is not None:
            prof.__exit__(None, None, None)
            gc.callbacks.remove(gc_times.record)
            recorder.unchain_export_hook(traces.append)
        # the process's peak so far: the reference, which comes after,
        # must not set it
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        snap1 = REGISTRY.snapshot()
        if child.wait(60) != 0:
            raise RuntimeError(f"the client process exited {child.returncode}")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    server.stop()

    # ---- what the window did ------------------------------------------
    index = {sql: (shape, p) for st in streams for shape, sql, p in st}
    recs = []
    for i, k, t_send, t_done, ok in out["stmts"]:
        shape = streams[i][k % len(streams[i])][0]
        n_rows, nbytes = stmt_cost(cell.shapes[shape], cell.config, rows)
        recs.append({"shape": shape, "t_send": t_send, "t_done": t_done,
                     "ok": ok, "rows_read": n_rows, "bytes_least": nbytes})
    answered = [r for r in recs if r["ok"]]
    in_window = [r for r in answered if r["t_done"] <= out["t_close"]]
    unanswered = len(recs) - len(answered)
    for e in out["errors"][:10]:
        log(f"window: {e}")
    log(f"window: {len(recs)} statements sent, {len(in_window)} answered "
        f"inside the window, {unanswered} not answered; distinct statements "
        f"{len(out['answers'])}")

    # ---- the check: every distinct answer against the reference --------
    del sess, domain, server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    read = {}
    for shape in cell.shapes.values():
        for t, cols in shape["reads"].items():
            read.setdefault(t, set()).update(cols)
    ref_tables = {t: {c: torch.from_numpy(data[t][c]).to(device)
                      for c in cols} for t, cols in read.items()}
    mismatched = 0
    for sql, answers in out["answers"].items():
        shape, p = index[sql]
        want = cell.shapes[shape]["module"].reference(ref_tables, p)
        for got in answers:
            bad = compare(got, want, cell.shapes[shape]["ordered"])
            if bad and mismatched < 1:
                log(f"check: {sql}\n  got  {got[:6]}\n  want {want[:6]}")
            mismatched += bad
    del ref_tables
    log(f"check: {len(out['answers'])} distinct statements against the "
        f"reference in {time.perf_counter() - t0:.2f} s")
    checks = {"mismatched_values": {"value": mismatched, "limit": 0},
              "unanswered": {"value": unanswered, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    # ---- metrics --------------------------------------------------------
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    w = Window(seconds=seconds, setup_s=setup_s, stmts=answered,
               in_window=in_window)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(recs),
              "failed": len(recs) - len(answered), "metrics": {}}
    if trace:
        w.counters = {k: snap1.get(k, 0) - snap0.get(k, 0)
                      for k in set(snap0) | set(snap1)}
        w.n_traces = len(traces)
        w.peaks = traffic.load_json(HERE / "peaks.json").get(kind)
        for tr in traces:
            w.spans.extend(pe.flatten(tr.root))
        if cuda:
            t0 = time.perf_counter()
            w.trace = pe.from_kineto(prof.profiler.kineto_results.events(),
                                     offset, t_go, t_end)
            log(f"trace: {len(w.trace.ops)} device operations, "
                f"{len(w.spans)} spans, read "
                f"in {time.perf_counter() - t0:.2f} s")
            for s0, s1 in sorted(pe.idle_gaps(w.trace),
                                 key=lambda g: g[0] - g[1])[:5]:
                log(f"trace: device idle {(s1 - s0) / 1e6:.2f} ms from "
                    f"{(s0 - t_go) / 1e9:.3f} s into the window")
            for s0, s1, gen in gc_times.longest(5):
                log(f"trace: host garbage collection (generation {gen}) "
                    f"{(s1 - s0) / 1e6:.2f} ms from {(s0 - t_go) / 1e9:.3f} s "
                    f"into the window")
            dev["busy_s"] = pe.busy_ns(w.trace) / 1e9
            dev["window_s"] = (t_end - t_go) / 1e9
            result["breakdown"] = {
                "device_ops": [list(x) for x in pe.time_by_name(w.trace)[:10]],
                "idle_gaps": [list(x) for x in pe.label_gaps(
                    pe.idle_gaps(w.trace), w.spans)]}
    for m in cell.per_layer if trace else cell.end_to_end:
        v = cell.readers[m["name"]].read(w)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    result["device"] = dev
    result["checks"] = checks
    found = forbidden_modules(sys.modules)
    if found:
        raise ForbiddenImport(found)
    return result


class ForbiddenImport(RuntimeError):
    """A module of the JAX stack or of the JAX package was loaded."""

    def __init__(self, found):
        super().__init__("modules of the JAX stack or the JAX package were "
                         f"loaded: {', '.join(found[:20])}")
        self.found = found

"""INFORMATION_SCHEMA virtual tables (memtables).

Reference: infoschema/tables.go:2244 (name -> column map, row providers),
infoschema/slow_log.go, util/stmtsummary.  Providers run at execution time
against the domain, so results always reflect the live catalog.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from .types import (
    FieldType,
    ty_float,
    ty_int,
    ty_string,
)

# name -> (columns [(name, ftype)], provider(domain, infoschema) -> rows)
MEMTABLES: Dict[str, Tuple[List[Tuple[str, FieldType]], Callable]] = {}


def _register(name: str, columns):
    def deco(fn):
        MEMTABLES[name] = (columns, fn)
        return fn

    return deco


@_register("schemata", [("catalog_name", ty_string()),
                        ("schema_name", ty_string())])
def _schemata(domain, isc):
    return [("def", n) for n in isc.schema_names()]


@_register("tables", [
    ("table_schema", ty_string()), ("table_name", ty_string()),
    ("table_type", ty_string()), ("table_rows", ty_int()),
    ("data_length", ty_int()), ("tidb_table_id", ty_int()),
])
def _tables(domain, isc):
    rows = []
    for dbn in isc.schema_names():
        for t in isc.tables(dbn):
            if t.is_view:
                rows.append((dbn, t.name, "VIEW", 0, 0, t.id))
                continue
            try:
                n = nbytes = 0
                for pid in t.physical_ids():
                    store = domain.storage.table(pid)
                    n += store.base_rows + len(store.delta)
                    nbytes += store.nbytes()
            except Exception:
                n, nbytes = 0, 0
            rows.append((dbn, t.name, "BASE TABLE", n, nbytes, t.id))
    return rows


@_register("columns", [
    ("table_schema", ty_string()), ("table_name", ty_string()),
    ("column_name", ty_string()), ("ordinal_position", ty_int()),
    ("data_type", ty_string()), ("is_nullable", ty_string()),
    ("column_key", ty_string()),
])
def _columns(domain, isc):
    rows = []
    for dbn in isc.schema_names():
        for t in isc.tables(dbn):
            for c in t.public_columns():
                key = "PRI" if c.primary_key else ""
                rows.append((
                    dbn, t.name, c.name, c.offset + 1,
                    c.ftype.sql_name().lower(),
                    "YES" if c.ftype.nullable else "NO", key,
                ))
    return rows


@_register("statistics", [
    ("table_schema", ty_string()), ("table_name", ty_string()),
    ("index_name", ty_string()), ("non_unique", ty_int()),
    ("seq_in_index", ty_int()), ("column_name", ty_string()),
])
def _statistics(domain, isc):
    rows = []
    for dbn in isc.schema_names():
        for t in isc.tables(dbn):
            for ix in t.indexes:
                for seq, col in enumerate(ix.columns):
                    rows.append((dbn, t.name, ix.name,
                                 0 if ix.unique else 1, seq + 1, col))
    return rows


@_register("processlist", [
    ("id", ty_int()), ("user", ty_string()), ("host", ty_string()),
    ("db", ty_string()), ("command", ty_string()), ("time", ty_float()),
    ("info", ty_string()),
])
def _processlist(domain, isc):
    import time as _time

    rows = []
    now = _time.time()
    for cid, s in domain.sessions.items():
        start = getattr(s, "stmt_start", None)
        user = getattr(s, "user", "root@%")
        if start is not None:
            rows.append((cid, user, "localhost", s.current_db, "Query",
                         now - start, getattr(s, "stmt_sql", "")[:256]))
        else:
            rows.append((cid, user, "localhost", s.current_db, "Sleep",
                         0.0, ""))
    return rows


@_register("slow_query", [
    ("time", ty_string()), ("conn_id", ty_int()),
    ("query_time", ty_float()), ("parse_ms", ty_float()),
    ("plan_ms", ty_float()), ("compile_ms", ty_float()),
    ("compile_hits", ty_int()), ("compile_misses", ty_int()),
    ("transfer_bytes", ty_int()), ("device_ms", ty_float()),
    ("readback_ms", ty_float()), ("readback_bytes", ty_int()),
    ("backoff_ms", ty_float()), ("backfill_ms", ty_float()),
    ("cop_tasks", ty_int()),
    ("engines", ty_string()), ("devices", ty_string()),
    ("rows", ty_int()), ("termination", ty_string()),
    ("query", ty_string()),
])
def _slow_query(domain, isc):
    """Structured slow-query log (infoschema/slow_log.go role) with the
    TPU-native per-phase columns from the trace subsystem: XLA compile
    vs. cache hits, host->device transfer bytes, device execute time,
    packed readback, backoff waits, engine/device attribution, and the
    statement's TERMINATION reason (ok|killed|timeout|mem_quota|
    overload|shutdown|error)."""
    return domain.slow_log.rows()


@_register("statements_summary", [
    ("digest_text", ty_string()), ("exec_count", ty_int()),
    ("sum_latency", ty_float()), ("avg_latency", ty_float()),
    ("max_latency", ty_float()), ("sum_rows", ty_int()),
    ("sum_compile_ms", ty_float()), ("sum_device_ms", ty_float()),
    ("sum_transfer_bytes", ty_int()), ("sum_readback_ms", ty_float()),
    ("sum_backoff_ms", ty_float()), ("terminations", ty_string()),
    ("sample_text", ty_string()),
])
def _statements_summary(domain, isc):
    """Per-digest aggregates (util/stmtsummary/statement_summary.go:59,213):
    literals normalized away, so every execution of a statement shape lands
    in one row; per-phase sums come from the same span trees the slow log
    and EXPLAIN ANALYZE read.  `terminations` counts abnormal statement
    endings per reason (killed/timeout/mem_quota/overload/shutdown)."""
    out = []
    for digest, st in sorted(domain.digest_summary.items()):
        ph = st.get("phases", {})
        terms = ",".join(f"{k}:{v}" for k, v in
                         sorted(st.get("terminations", {}).items()))
        out.append((digest, st["count"], st["sum_latency"],
                    st["sum_latency"] / max(st["count"], 1),
                    st["max_latency"], st["sum_rows"],
                    round(ph.get("compile_ms", 0.0), 3),
                    round(ph.get("device_ms", 0.0), 3),
                    int(ph.get("transfer_bytes", 0)),
                    round(ph.get("readback_ms", 0.0), 3),
                    round(ph.get("backoff_ms", 0.0), 3),
                    terms, st["sample"]))
    return out


@_register("tidb_regions", [
    ("region_id", ty_int()), ("table_id", ty_int()), ("start_key", ty_int()),
    ("end_key", ty_int()), ("epoch", ty_int()), ("leader_store", ty_int()),
])
def _tidb_regions(domain, isc):
    rows = []
    for dbn in isc.schema_names():
        for t in isc.tables(dbn):
            if t.is_view:
                continue
            for r in domain.storage.regions.regions_of(t.id):
                rows.append((r.region_id, t.id, r.start,
                             min(r.end, 1 << 62), r.epoch, r.leader_store))
    return rows


@_register("metrics", [
    ("name", ty_string()), ("value", ty_float()),
])
def _metrics(domain, isc):
    from .metrics import REGISTRY

    return sorted(REGISTRY.snapshot().items())


@_register("views", [
    ("table_schema", ty_string()), ("table_name", ty_string()),
    ("view_definition", ty_string()),
])
def _views(domain, isc):
    rows = []
    for dbn in isc.schema_names():
        for t in isc.tables(dbn):
            if t.is_view:
                sel = t.view_select
                rows.append((dbn, t.name,
                             sel if isinstance(sel, str) else "<ast>"))
    return rows


@_register("partitions", [
    ("table_schema", ty_string()), ("table_name", ty_string()),
    ("partition_name", ty_string()), ("partition_method", ty_string()),
    ("partition_expression", ty_string()),
    ("partition_description", ty_string()), ("table_rows", ty_int()),
])
def _partitions(domain, isc):
    rows = []
    for dbn in isc.schema_names():
        for t in isc.tables(dbn):
            if t.is_view:
                continue
            pi = t.partition_info
            if pi is None:
                rows.append((dbn, t.name, "", "", "", "", 0))
                continue
            for pd in pi.defs:
                try:
                    store = domain.storage.table(pd.id)
                    n = store.base_rows + len(store.delta)
                except Exception:
                    n = 0
                desc = ("MAXVALUE" if pd.less_than is None
                        else str(pd.less_than)) if pi.kind == "range" else ""
                rows.append((dbn, t.name, pd.name, pi.kind.upper(),
                             pi.column, desc, n))
    return rows


@_register("tidb_indexes", [
    ("table_schema", ty_string()), ("table_name", ty_string()),
    ("key_name", ty_string()), ("non_unique", ty_int()),
    ("seq_in_index", ty_int()), ("column_name", ty_string()),
    ("index_id", ty_int()),
])
def _tidb_indexes(domain, isc):
    from .catalog.schema import STATE_PUBLIC

    rows = []
    for dbn in isc.schema_names():
        for t in isc.tables(dbn):
            for ix in t.indexes:
                if ix.state != STATE_PUBLIC:
                    continue  # half-built online-DDL indexes stay hidden
                for seq, col in enumerate(ix.columns):
                    rows.append((dbn, t.name, ix.name,
                                 0 if ix.unique else 1, seq + 1, col, ix.id))
    return rows


@_register("engines", [
    ("engine", ty_string()), ("support", ty_string()),
    ("comment", ty_string()),
])
def _engines(domain, isc):
    return [("tidb-tpu", "DEFAULT",
             "columnar MVCC block store, TPU coprocessor")]


@_register("collations", [
    ("collation_name", ty_string()), ("character_set_name", ty_string()),
    ("is_default", ty_string()),
])
def _collations(domain, isc):
    return [("utf8mb4_bin", "utf8mb4", "Yes"),
            ("utf8mb4_general_ci", "utf8mb4", "")]


@_register("character_sets", [
    ("character_set_name", ty_string()),
    ("default_collate_name", ty_string()), ("maxlen", ty_int()),
])
def _character_sets(domain, isc):
    return [("utf8mb4", "utf8mb4_bin", 4)]


@_register("key_column_usage", [
    ("constraint_name", ty_string()), ("table_schema", ty_string()),
    ("table_name", ty_string()), ("column_name", ty_string()),
    ("ordinal_position", ty_int()),
])
def _key_column_usage(domain, isc):
    from .catalog.schema import STATE_PUBLIC

    rows = []
    for dbn in isc.schema_names():
        for t in isc.tables(dbn):
            for ix in t.indexes:
                if not (ix.primary or ix.unique):
                    continue
                if ix.state != STATE_PUBLIC:
                    continue
                name = "PRIMARY" if ix.primary else ix.name
                for seq, col in enumerate(ix.columns):
                    rows.append((name, dbn, t.name, col, seq + 1))
    return rows


@_register("cluster_info", [
    ("type", ty_string()), ("instance", ty_string()),
    ("status_address", ty_string()), ("version", ty_string()),
])
def _cluster_info(domain, isc):
    return [("tidb-tpu", "in-process", "127.0.0.1:10080",
             "8.0.11-tidb-tpu-0.1.0")]


# ---------------------------------------------------------------------------
# mysql.* system tables (the reference's bootstrap tables, session/
# bootstrap.go; served live from the owning subsystem instead of stored
# rows — the util/sqlexec internal-SQL surface, inverted)
# ---------------------------------------------------------------------------


@_register("mysql.user", [
    ("host", ty_string()), ("user", ty_string()),
    ("authentication_string", ty_string()), ("priv", ty_string()),
])
def _mysql_user(domain, isc):
    rows = []
    for key, u in sorted(domain.priv.users.items()):
        name, host = key.rsplit("@", 1)
        privs = ",".join(sorted(p.upper() for p in u["global"])) or "USAGE"
        rows.append((host, name, u["password"], privs))
    return rows


@_register("mysql.db", [
    ("host", ty_string()), ("db", ty_string()), ("user", ty_string()),
    ("priv", ty_string()),
])
def _mysql_db(domain, isc):
    rows = []
    for key, u in sorted(domain.priv.users.items()):
        name, host = key.rsplit("@", 1)
        for db, privs in sorted(u["dbs"].items()):
            if privs:
                rows.append((host, db, name,
                             ",".join(sorted(p.upper() for p in privs))))
    return rows


@_register("mysql.tables_priv", [
    ("host", ty_string()), ("db", ty_string()), ("user", ty_string()),
    ("table_name", ty_string()), ("table_priv", ty_string()),
])
def _mysql_tables_priv(domain, isc):
    rows = []
    for key, u in sorted(domain.priv.users.items()):
        name, host = key.rsplit("@", 1)
        for (db, tbl), privs in sorted(u["tables"].items()):
            if privs:
                rows.append((host, db, name, tbl,
                             ",".join(sorted(p.upper() for p in privs))))
    return rows


@_register("mysql.bind_info", [
    ("original_sql", ty_string()), ("bind_sql", ty_string()),
    ("status", ty_string()),
])
def _mysql_bind_info(domain, isc):
    rows = []
    for digest, b in sorted(getattr(domain, "bindings", {}).items()):
        rows.append((b["original"], b["hinted"], "using"))
    return rows


@_register("mysql.stats_meta", [
    ("table_id", ty_int()), ("count", ty_int()),
    ("modify_count", ty_int()),
])
def _mysql_stats_meta(domain, isc):
    rows = []
    for tid, st in sorted(domain.stats._cache.items()):
        rows.append((tid, st.row_count, st.modify_count))
    return rows


@_register("mysql.global_variables", [
    ("variable_name", ty_string()), ("variable_value", ty_string()),
])
def _mysql_global_variables(domain, isc):
    return sorted(domain.global_vars.items())


# ---------------------------------------------------------------------------
# cluster/ops deep introspection (executor/cluster_reader.go:42 role, over
# the single in-process node) + profiling (util/profile role)
# ---------------------------------------------------------------------------


@_register("cluster_config", [
    ("type", ty_string()), ("instance", ty_string()),
    ("name", ty_string()), ("value", ty_string()),
])
def _cluster_config(domain, isc):
    import os

    from .session.vars import SYSVAR_DEFAULTS

    rows = []
    merged = {k: v[0] for k, v in SYSVAR_DEFAULTS.items()}
    merged.update(domain.global_vars)
    for name in sorted(merged):
        rows.append(("tidb-tpu", "127.0.0.1", name, str(merged[name])))
    for env in sorted(k for k in os.environ if k.startswith("TIDB_TPU_")):
        rows.append(("env", "127.0.0.1", env, os.environ[env]))
    return rows


@_register("cluster_hardware", [
    ("type", ty_string()), ("instance", ty_string()),
    ("device_type", ty_string()), ("device_name", ty_string()),
    ("name", ty_string()), ("value", ty_string()),
])
def _cluster_hardware(domain, isc):
    import os

    rows = [("tidb-tpu", "127.0.0.1", "cpu", "host", "logical_cores",
             str(os.cpu_count() or 1))]
    from . import ops
    from .errors import DeviceUnavailableError

    try:
        dev = ops.device()
    except DeviceUnavailableError:
        return rows  # no card: host info only
    if dev.type == "cuda":
        import torch

        rows.append(("tidb-tpu", "127.0.0.1", "gpu",
                     torch.cuda.get_device_name(dev), "id",
                     str(dev.index or 0)))
    return rows


@_register("cluster_systeminfo", [
    ("type", ty_string()), ("instance", ty_string()),
    ("name", ty_string()), ("value", ty_string()),
])
def _cluster_systeminfo(domain, isc):
    import os
    import platform

    rows = [
        ("tidb-tpu", "127.0.0.1", "os", platform.platform()),
        ("tidb-tpu", "127.0.0.1", "python", platform.python_version()),
        ("tidb-tpu", "127.0.0.1", "pid", str(os.getpid())),
    ]
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith(("MemTotal", "MemAvailable")):
                    k, v = line.split(":", 1)
                    rows.append(("tidb-tpu", "127.0.0.1", k.lower(),
                                 v.strip()))
    except OSError:
        pass
    return rows


@_register("tidb_tpu_engine", [
    ("component", ty_string()), ("name", ty_string()),
    ("value", ty_string()),
])
def _tidb_tpu_engine(domain, isc):
    """Live device-engine state: the mesh, the sharded column cache, and
    the compiled-program registry — the introspection that drives perf
    debugging (what is resident, at which wire dtype, over which devices)."""
    rows = []
    try:
        from . import ops
        from .copr import parallel as pl
        from .copr import torch_engine as te

        dev = ops.device()
        positions = ops.mesh_devices()
        rows.append(("mesh", "devices", str(len(positions))))
        rows.append(("mesh", "platform", dev.type))
        rows.append(("mesh", "positions", ",".join(
            f"{pid}:{d}" for pid, d in positions)))
        mesh = pl._MESH
        if mesh is not None:
            rows.append(("mesh", "current", ",".join(
                str(pid) for pid in mesh.ids)))
            rows.append(("mesh", "epoch", str(pl.mesh_epoch())))
        rows.append(("mesh", "tile_rows", str(te.TILE)))
        cache = pl.MESH_CACHE._c
        rows.append(("column_cache", "entries", str(len(cache))))
        rows.append(("column_cache", "bytes", str(cache._bytes)))
        rows.append(("column_cache", "capacity_bytes", str(cache.capacity)))
        for key, val in list(cache.items_view.items())[:64]:
            data = val[0]
            rows.append((
                "column_cache",
                f"store={key[0]} ver={key[1]} col={key[2]}",
                f"dtype={data[0].dtype} shards={len(data)} "
                f"shape={list(data[0].shape)} bytes={data.nbytes} "
                f"positions={list(key[3])} "
                f"nulls={'none' if val[1] is None else 'bitmap'}",
            ))
        rows.append(("programs", "mesh_compiled", str(len(pl._COMPILED))))
        rows.append(("programs", "tile_compiled", str(len(te._COMPILED))))
        from .copr.cache import PROGRAM_CACHES

        for c in PROGRAM_CACHES:
            st = c.stats()
            rows.append((
                "programs", f"{c.name}_cache",
                f"size={st['size']}/{st['capacity']} hits={st['hits']} "
                f"misses={st['misses']} evictions={st['evictions']}",
            ))
        tile_cache = te.DEVICE_CACHE._c
        rows.append(("tile_cache", "entries", str(len(tile_cache))))
        rows.append(("tile_cache", "bytes", str(tile_cache._bytes)))
    except Exception as e:  # pragma: no cover - defensive surface
        rows.append(("engine", "error", repr(e)))
    return rows


@_register("tidb_tpu_device_health", [
    ("device_id", ty_int()), ("platform", ty_string()),
    ("state", ty_string()), ("error_count", ty_int()),
    ("consecutive_errors", ty_int()), ("trip_count", ty_int()),
    ("in_current_mesh", ty_int()), ("last_error", ty_string()),
])
def _tidb_tpu_device_health(domain, isc):
    """Per-position circuit-breaker state (the degraded-mesh failover
    subsystem, copr/device_health.py): which mesh positions are
    quarantined, why, and whether the live mesh currently includes them
    — the operator view the reference exposes for sick stores via
    pd/store state."""
    from .copr.device_health import DEVICE_HEALTH

    states = {st.device_id: st for st in DEVICE_HEALTH.snapshot()}
    rows = []
    from .errors import DeviceUnavailableError

    try:
        from . import ops
        from .copr import parallel as pl

        mesh = pl._MESH
        mesh_ids = set(mesh.ids) if mesh is not None else set()
        for did, dev in ops.mesh_devices():
            st = states.pop(did, None)
            rows.append((
                did, "remote" if dev is None else dev.type,
                st.state if st is not None else "healthy",
                st.error_count if st is not None else 0,
                st.consecutive_errors if st is not None else 0,
                st.trip_count if st is not None else 0,
                1 if did in mesh_ids else 0,
                st.last_error if st is not None else "",
            ))
    except DeviceUnavailableError:
        pass  # no card: tracked-state rows only
    for did in sorted(states):
        st = states[did]
        rows.append((did, "unknown", st.state, st.error_count,
                     st.consecutive_errors, st.trip_count, 0, st.last_error))
    return rows


@_register("tidb_tpu_resource_groups", [
    ("name", ty_string()), ("ru_per_sec", ty_int()),
    ("burstable", ty_int()), ("query_limit_ms", ty_int()),
    ("priority", ty_int()),
    ("tokens", ty_float()), ("waiting", ty_int()),
    ("consumed_ru", ty_float()), ("throttled", ty_int()),
    ("users", ty_string()),
])
def _tidb_tpu_resource_groups(domain, isc):
    """The resource-control plane (lifecycle/resgroup.py): one row per
    group with its quota, weighted-fair priority, live token balance,
    parked waiters, lifetime RU (device-ms) and bound users — the
    operator view the reference exposes as
    information_schema.resource_groups."""
    return [
        (g["name"], g["ru_per_sec"], int(g["burstable"]),
         g["query_limit_ms"], g["priority"], g["tokens"], g["waiting"],
         g["consumed_ru"], g["throttled"], ",".join(g["users"]))
        for g in domain.resgroups.snapshot()
    ]


@_register("tidb_tpu_partition_map", [
    ("table_id", ty_int()), ("partition_id", ty_int()),
    ("row_start", ty_int()), ("row_end", ty_int()),
    ("owner_pid", ty_int()), ("epoch", ty_int()),
    ("local", ty_int()), ("store_table_id", ty_int()),
    ("replicas", ty_string()),
])
def _tidb_tpu_partition_map(domain, isc):
    """The sharded data plane's ownership map: one row per
    (sharded table, partition) with its handle range, owning process,
    the membership epoch the map was derived at, the synthetic table id
    of the locally materialized partition store (when held), and the
    ordered replica chain (primary first — the failover ladder's
    rungs).  Empty when the data plane is inactive."""
    from .dataplane import get_dataplane

    dp = get_dataplane(domain.storage)
    if dp is None:
        return []
    pmap = dp.current_map()
    if pmap is None:
        return []
    rows = []
    with dp._mu:
        tables = {tid: (list(st.bounds), dict(st.loaded))
                  for tid, st in dp._tables.items()}
    for tid in sorted(tables):
        bounds, loaded = tables[tid]
        for p, (lo, hi) in enumerate(bounds):
            rows.append((tid, p, lo, hi, pmap.owner(p), pmap.epoch,
                         int(p in loaded), loaded.get(p, -1),
                         ",".join(str(r) for r in pmap.chain(p))))
    return rows


@_register("tidb_tpu_fusion_splits", [
    ("reason", ty_string()), ("splits", ty_int()),
])
def _tidb_tpu_fusion_splits(domain, isc):
    """Fusion-region splits by reason: the measured inventory
    of why fragments still peel a host tail (unsupported-op,
    computed-key, compound-order, head-shape) plus the total — the
    operator view of zero-host-tail progress."""
    from .copr.fusion import SPLIT_REASONS
    from .metrics import REGISTRY

    snap = REGISTRY.snapshot()
    rows = [("total", int(snap.get("fusion_splits_total", 0)))]
    for r in SPLIT_REASONS:
        rows.append((r, int(snap.get(
            "fusion_splits_reason_" + r.replace("-", "_") + "_total",
            0))))
    return rows


@_register("tidb_tpu_column_layout", [
    ("table_id", ty_int()), ("store_uid", ty_int()),
    ("column_name", ty_string()), ("store_offset", ty_int()),
    ("encoding", ty_string()), ("packed_bits", ty_int()),
    ("dict_cap", ty_int()), ("tier", ty_string()),
    ("tile_bucket", ty_string()), ("priority", ty_float()),
    ("layout_version", ty_int()), ("scans", ty_int()),
    ("filters", ty_int()), ("agg_keys", ty_int()),
    ("probe_keys", ty_int()), ("last_selectivity", ty_float()),
])
def _tidb_tpu_column_layout(domain, isc):
    """The layout autotuner's per-column decisions (tidb_tpu/layout):
    chosen encoding (dictionary vs direct), packed code width, residency
    tier, tile bucket and eviction priority, next to the observations
    they derive from — the operator view of 'why is this column cold'."""
    try:
        from .layout import LAYOUT

        decisions = LAYOUT.decisions_snapshot()
    except Exception:
        return []
    rows = []
    for d in decisions:
        rows.append((
            d["table_id"], d["store_uid"], d["column"], d["store_ci"],
            d["encoding"], d["bits"], d["dict_cap"], d["tier"],
            d["tile_bucket"], float(d["priority"]), d["version"],
            d["scans"], d["filters"], d["agg_keys"], d["probe_keys"],
            float(d["last_selectivity"])
            if d["last_selectivity"] is not None else -1.0,
        ))
    return rows


@_register("tidb_tpu_profile", [
    ("window_start", ty_string()), ("stack", ty_string()),
    ("count", ty_int()), ("self_ms", ty_float()),
])
def _tidb_tpu_profile(domain, isc):
    """Continuous-profiling stacks: the rotating flame
    windows the profiler folds every finished QueryTrace into — one row
    per (window, span path), weight = accumulated self time.  The same
    data /flame renders as folded-stacks text."""
    from .trace import PROFILER

    return PROFILER.rows()


@_register("tidb_tpu_fleet_metrics", [
    ("host", ty_string()), ("name", ty_string()),
    ("kind", ty_string()), ("value", ty_float()),
])
def _tidb_tpu_fleet_metrics(domain, isc):
    """Fleet-merged metrics: workers piggyback registry
    snapshots on coord span batches; counters sum across hosts
    (host='fleet'), gauges stay per-host, histogram quantiles merge
    bucket-wise.  LocalPlane degenerates to a single-member fleet."""
    from .coord import get_plane
    from .metrics import merge_fleet

    try:
        merged = merge_fleet(get_plane().fleet_metrics())
    except Exception:
        return []
    rows = []
    for name in sorted(merged["counters"]):
        rows.append(("fleet", name, "counter",
                     float(merged["counters"][name])))
    for name in sorted(merged["gauges"]):
        for host in sorted(merged["gauges"][name]):
            rows.append((host, name, "gauge",
                         float(merged["gauges"][name][host])))
    for name in sorted(merged["hists"]):
        h = merged["hists"][name]
        for k in ("p50", "p95", "p99"):
            rows.append(("fleet", name, k, float(h[k])))
        rows.append(("fleet", name, "count", float(h["count"])))
    return rows


@_register("tidb_profile", [
    ("function", ty_string()), ("calls", ty_int()),
    ("total_time_ms", ty_float()), ("cum_time_ms", ty_float()),
])
def _tidb_profile(domain, isc):
    """cProfile aggregate since `SET tidb_profiling = 1` (util/profile's
    flamegraph table role, rendered flat: hottest cumulative first)."""
    prof = getattr(domain, "profiler", None)
    if prof is None:
        return []
    # cProfile's enable/disable hooks are PER-THREAD: toggling them from
    # this reader thread would leak a live profiling hook onto the server
    # pool thread serving this query.  getstats() on a running collector
    # is safe (it snapshots timer state without touching hooks).
    try:
        stats = prof.getstats()
    except Exception:
        return []
    rows = []
    for entry in stats:
        code = entry.code
        name = (code if isinstance(code, str)
                else f"{code.co_filename.rsplit('/', 1)[-1]}:"
                     f"{code.co_firstlineno}:{code.co_name}")
        rows.append((name, int(entry.callcount),
                     entry.inlinetime * 1000.0, entry.totaltime * 1000.0))
    rows.sort(key=lambda r: -r[3])
    return rows[:200]


@_register("cluster_log", [
    ("time", ty_string()), ("type", ty_string()),
    ("instance", ty_string()), ("level", ty_string()),
    ("message", ty_string()),
])
def _cluster_log(domain, isc):
    """Recent in-process log records (executor/cluster_reader.go's
    CLUSTER_LOG memtable over the single node)."""
    import datetime as _dt

    rows = []
    for created, level, name, msg in list(getattr(domain, "log_ring", ())):
        ts = _dt.datetime.fromtimestamp(created).strftime(
            "%Y-%m-%d %H:%M:%S")
        rows.append((ts, "tidb-tpu", "127.0.0.1", level,
                     f"[{name}] {msg}"))
    return rows

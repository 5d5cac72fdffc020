"""HTTP status/metrics endpoint.

Reference: server/http_status.go:74-115 — the tidb-server status port
(default 10080) serving /metrics (Prometheus), /status (JSON build/
connection info), and the /schema inspector.  Stdlib http.server in a
daemon thread; no new dependencies.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..metrics import REGISTRY
from ..util_concurrency import witness_stats

VERSION = "8.0.11-tidb-tpu-0.1.0"


def _fusion_section(snap: dict) -> dict:
    """Per-reason fusion-split breakdown: the measured
    inventory of why fragments still split to host tails."""
    try:
        from ..copr.fusion import SPLIT_REASONS

        return {
            "splits_total": snap.get("fusion_splits_total", 0),
            "by_reason": {
                r: snap.get(
                    "fusion_splits_reason_"
                    + r.replace("-", "_") + "_total", 0)
                for r in SPLIT_REASONS
            },
        }
    except Exception as e:  # pragma: no cover - defensive
        return {"error": repr(e)}


def _layout_section() -> dict:
    """The /status layout payload (never lets a tuner hiccup 500 the
    status port)."""
    try:
        from ..layout import status_section

        return status_section()
    except Exception as e:  # pragma: no cover - defensive
        return {"error": repr(e)}


def _profile_section() -> dict:
    """Continuous-profiling summary: rotating flame windows
    with the top self-time stacks; the full folded text is /flame."""
    try:
        from ..trace import PROFILER

        return PROFILER.status_section()
    except Exception as e:  # pragma: no cover - defensive
        return {"error": repr(e)}


def _resgroups_section(domain) -> dict:
    """Resource-control plane: per-group token balance,
    parked waiters, lifetime RU (device-ms) and throttle raises, plus
    the fleet RU counters and throttle-wait quantiles."""
    try:
        from ..metrics import REGISTRY

        out = {"groups": domain.resgroups.snapshot(),
               "ru_consumed": REGISTRY.snapshot().get(
                   "resgroup_ru_consumed_total", 0.0)}
        hs = REGISTRY.hist_stats("resgroup_throttle_wait_ms")
        if hs is not None:
            out["throttle_wait_ms"] = hs
        return out
    except Exception as e:  # pragma: no cover - defensive
        return {"error": repr(e)}


def _mesh_positions() -> list:
    """One entry a mesh position: id, device, in the current mesh."""
    from .. import ops
    from ..copr import parallel as pl
    from ..errors import DeviceUnavailableError

    try:
        positions = ops.mesh_devices()
    except DeviceUnavailableError:
        return []
    mesh = pl._MESH
    held = set(mesh.ids) if mesh is not None else set()
    return [{"position": pid,
             "device": "remote" if d is None else str(d),
             "in_current_mesh": pid in held} for pid, d in positions]


def _dataplane_section(domain) -> dict:
    """Sharded data plane: the host's partition map (epoch,
    owners, members), per-table shard state, and the exchange/re-shard
    counters that the 2-host bench receipt reads."""
    try:
        from ..dataplane import get_dataplane
        from ..metrics import REGISTRY

        dp = get_dataplane(domain.storage)
        snap = REGISTRY.snapshot()
        out = {"active": dp is not None}
        if dp is not None:
            out.update(dp.snapshot())
        out["metrics"] = {
            name: snap.get(name, 0)
            for name in (
                "dataplane_queries_total",
                "dataplane_local_fragments_total",
                "dataplane_remote_fragments_total",
                "dataplane_exchange_bytes_total",
                "dataplane_partitions_scanned_total",
                "dataplane_partitions_loaded_total",
                "dataplane_partitions_moved_total",
                "dataplane_reshards_total",
                "dataplane_epoch_retries_total",
                "dataplane_bypass_total",
                "dataplane_peer_lost_total",
                "dataplane_errors_total",
                # replication & failover
                "dataplane_replica_promotions_total",
                "dataplane_cold_reloads_total",
                "dataplane_replica_fills_total",
                "dataplane_replica_fill_errors_total",
                "dataplane_replica_reads_total",
                "dataplane_failovers_total",
                "dataplane_failover_bypass_total",
                "dataplane_hedged_fragments_total",
                "dataplane_hedge_wins_total",
                "dataplane_hedge_wasted_bytes_total",
                "dataplane_rpc_wasted_bytes_total",
                "dataplane_served_bytes_total",
                "dataplane_dedup_hits_total",
                "dataplane_conn_dials_total",
                "dataplane_conn_reuse_total",
                "dataplane_conn_evictions_total",
            )
        }
        return out
    except Exception as e:  # pragma: no cover - defensive
        return {"error": repr(e)}


def _slo_section(domain) -> dict:
    """Per-statement-class SLO state: threshold, error-budget
    burn counters and latency quantiles from the log2 histograms.  An
    ``auto`` class additionally reports the rolling-window
    baseline its derived threshold comes from."""
    try:
        from ..metrics import REGISTRY, STMT_CLASSES
        from ..session.vars import SessionVars
        from ..trace.slo import SLO_AUTO, is_auto, resolve_threshold_ms

        # the SAME read Session._observe_slo acts on (global scope with
        # SYSVAR_DEFAULTS fallback) — the reported threshold must never
        # desync from the enforced one
        gvars = SessionVars(domain.global_vars)
        snap = REGISTRY.snapshot()
        out = {}
        for cls in STMT_CLASSES:
            raw = gvars.get_global_str(f"tidb_tpu_slo_{cls}_ms", "0")
            thr = resolve_threshold_ms(raw, cls)
            ok = snap.get(f"slo_{cls}_ok_total", 0)
            breach = snap.get(f"slo_{cls}_breach_total", 0)
            total = ok + breach
            sec = {"threshold_ms": thr, "ok": ok, "breach": breach,
                   "burn": round(breach / total, 6) if total else 0.0}
            if is_auto(raw):
                sec["mode"] = "auto"
                sec["auto"] = SLO_AUTO.snapshot(cls)
            hs = REGISTRY.hist_stats(f"stmt_latency_{cls}_ms")
            if hs is not None:
                sec.update({"count": hs["count"], "p50_ms": hs["p50"],
                            "p95_ms": hs["p95"], "p99_ms": hs["p99"]})
            out[cls] = sec
        return out
    except Exception as e:  # pragma: no cover - defensive
        return {"error": repr(e)}


def _memory_section() -> dict:
    """Device-memory telemetry: bytes/capacity/high-water for
    every named ByteCapCache (mesh columns, cold tier, per-tile cache)."""
    try:
        from ..copr.cache import memory_stats

        return {"caches": memory_stats()}
    except Exception as e:  # pragma: no cover - defensive
        return {"error": repr(e)}


def _fleet_section() -> dict:
    """Fleet-merged metrics: counters summed across hosts,
    histograms merged bucket-wise, gauges kept per-host.  LocalPlane
    degenerates to a single-member fleet."""
    try:
        from ..coord import get_plane
        from ..metrics import merge_fleet

        plane = get_plane()
        # refresh=False: the /status memory section just ran
        # memory_stats(), the cache gauges are already current
        merged = merge_fleet(plane.fleet_metrics(refresh=False))
        merged["kind"] = plane.kind
        return merged
    except Exception as e:  # pragma: no cover - defensive
        return {"error": repr(e)}


class StatusServer:
    def __init__(self, domain, host: str = "127.0.0.1", port: int = 10080):
        self.domain = domain
        self.host = host
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self):
        domain = self.domain

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0].rstrip("/") or "/"
                if path == "/metrics":
                    # refresh pull-time gauges (device-cache bytes /
                    # watermarks) so scrapes see live values
                    try:
                        from ..copr.cache import memory_stats

                        memory_stats()
                    except Exception:
                        pass
                    lines = REGISTRY.prometheus_lines()
                    body = ("\n".join(lines) + "\n").encode()
                    self._send(200, body, "text/plain; version=0.0.4")
                    return
                if path == "/flame":
                    # standard folded-stacks text (flamegraph.pl /
                    # speedscope / inferno consumable) over the
                    # profiler's retained windows
                    try:
                        from ..trace import PROFILER

                        body = PROFILER.folded().encode()
                    except Exception as e:
                        body = f"# profiler unavailable: {e!r}\n".encode()
                    self._send(200, body, "text/plain")
                    return
                if path in ("/status", "/"):
                    from ..coord import get_plane
                    from ..copr.cache import PROGRAM_CACHES
                    from ..copr.device_health import DEVICE_HEALTH
                    from ..metrics import COORD_STATUS_METRICS
                    from ..trace import TRACE_RING

                    running = sum(
                        1 for s in domain.sessions.values()
                        if getattr(s, "stmt_start", None) is not None)
                    recent = []
                    for tr in list(TRACE_RING)[-8:]:
                        try:
                            tot = tr.phase_totals()
                            recent.append({
                                "sql": tr.sql[:128],
                                "conn_id": tr.conn_id,
                                "duration_ms": round(tr.duration_ms(), 3),
                                "compile_ms": round(tot["compile_ms"], 3),
                                "transfer_bytes": tot["transfer_bytes"],
                                "device_ms": round(tot["device_ms"], 3),
                                "readback_ms": round(tot["readback_ms"], 3),
                                "backoff_ms": round(tot["backoff_ms"], 3),
                                "backfill_ms": round(
                                    tot.get("backfill_ms", 0.0), 3),
                                "wire_bytes": tot["wire_bytes"],
                                "engines": tot["engines"],
                            })
                        except Exception:
                            continue  # a live trace mutating mid-walk
                    plane = get_plane()
                    view = plane.view()
                    snap = REGISTRY.snapshot()
                    body = json.dumps({
                        "version": VERSION,
                        "git_hash": "",
                        "ddl_schema_version":
                            domain.catalog.schema_version,
                        "connections": len(domain.sessions),
                        "running_statements": running,
                        "gc_safe_point":
                            domain.maintenance.last_safepoint,
                        # circuit-breaker summary (PR-2 follow-up (d)):
                        # operators watching the status port see a sick
                        # chip without querying information_schema
                        "tripped_devices":
                            list(DEVICE_HEALTH.tripped_ids()),
                        # N most recent finished query traces with their
                        # per-phase totals (the trace subsystem's ring)
                        "recent_traces": recent,
                        # LRU-bounded compiled-program caches (tile/mesh/
                        # MPP/micro-batch): with shape buckets on, hit
                        # rate tracks query SHAPE CLASSES, not literals
                        "compiled_programs": {
                            c.name: c.stats() for c in PROGRAM_CACHES
                        },
                        # coordination plane: membership epoch
                        # + per-process healthy device sets, and the
                        # failover / span-forwarding / handoff counters
                        "coord": {
                            "kind": plane.kind,
                            "epoch": view.epoch,
                            "formed": view.formed,
                            "members": {
                                str(p): list(ids) for p, ids
                                in sorted(view.members.items())
                            },
                            "metrics": {
                                name: snap.get(name, 0)
                                for name in COORD_STATUS_METRICS
                            },
                        },
                        # adaptive data layout: per-column
                        # encoding/tier decisions, hot/cold tier byte
                        # gauges and the cold-tier traffic counters
                        "layout": _layout_section(),
                        # zero-host-tail compilation: region
                        # splits by reason — regressions in fusion
                        # coverage are visible per cause at a glance
                        "fusion": _fusion_section(snap),
                        # continuous profiling: rotating
                        # flame windows, top self-time stacks (full
                        # folded text on /flame)
                        "profile": _profile_section(),
                        # per-statement-class SLOs: thresholds, error-
                        # budget burn, p50/p95/p99 from log2 histograms
                        "slo": _slo_section(domain),
                        # device-memory telemetry: per-cache bytes,
                        # capacity and high-water marks
                        "memory": _memory_section(),
                        # fleet-merged metrics: counters summed across
                        # hosts, histograms bucket-merged, gauges
                        # per-host (LocalPlane = single-member fleet)
                        "fleet": _fleet_section(),
                        # lock-order witness: guarded
                        # acquisitions, max held depth, violations
                        # (all zero with TIDB_TPU_LOCKCHECK unset)
                        "lockcheck": witness_stats(),
                        # resource groups: token balances,
                        # waiters, lifetime RU and throttle counts
                        "resgroups": _resgroups_section(domain),
                        # sharded data plane: partition map,
                        # shard state, exchange/re-shard counters
                        "dataplane": _dataplane_section(domain),
                    }).encode()
                    self._send(200, body, "application/json")
                    return
                if path == "/device-health":
                    # full breaker state, mirroring information_schema.
                    # TIDB_TPU_DEVICE_HEALTH (region_cache.go's store
                    # health surfaced on http_status.go's /regions model)
                    from ..copr.device_health import DEVICE_HEALTH

                    body = json.dumps({
                        "devices": [{
                            "device_id": st.device_id,
                            "state": st.state,
                            "error_count": st.error_count,
                            "consecutive_errors": st.consecutive_errors,
                            "trip_count": st.trip_count,
                            "last_error": st.last_error,
                        } for st in DEVICE_HEALTH.snapshot()],
                        "tripped":
                            list(DEVICE_HEALTH.tripped_ids()),
                        # every mesh position, its device and whether
                        # the live mesh holds it
                        "positions": _mesh_positions(),
                    }).encode()
                    self._send(200, body, "application/json")
                    return
                if path == "/schema":
                    isc = domain.catalog.info_schema()
                    out = {}
                    for db in isc.schema_names():
                        out[db] = [
                            {"name": t.name, "id": t.id,
                             "is_view": t.is_view,
                             "partitions": [p.name for p in
                                            t.partition_info.defs]
                             if t.partition_info else None}
                            for t in isc.tables(db)
                        ]
                    self._send(200, json.dumps(out).encode(),
                               "application/json")
                    return
                self._send(404, b"not found\n", "text/plain")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="tidb-tpu-status",
            daemon=True)
        self._thread.start()
        return self.host, self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

"""Session: parse -> plan -> execute loop with txn lifecycle.

Reference: session/session.go — Execute (:1065) / execute (:1078) parse+
compile+run loop, lazy txn state machine (txn.go:41-141), commit with
optimistic retry (:444,:635), and executor/adapter.go ExecStmt.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

import numpy as np

from ..catalog import ColumnInfo, IndexInfo, TableInfo
from ..catalog.schema import STATE_PUBLIC
from ..errors import (
    ExecutorError,
    KVError,
    PlanError,
    SchemaChangedError,
    TiDBTPUError,
    TxnConflictError,
    UnknownDatabaseError,
)
from ..executor import ExecContext, collect_all
from ..parser import ast, parse
from ..planner import (
    PhysicalContext,
    explain_text,
    finish_plan,
    plan_statement,
)
from ..planner.build import PlanBuilder
from ..planner.rules import optimize_logical
from ..types import (
    FieldType,
    TypeKind,
    ty_bit,
    ty_date,
    ty_datetime,
    ty_decimal,
    ty_enum,
    ty_float,
    ty_int,
    ty_json,
    ty_set,
    ty_string,
    ty_time,
    ty_uint,
)
from ..types.values import (
    format_date,
    format_datetime,
    format_decimal,
    format_time,
)
from .domain import Domain
from .vars import SYSVAR_DEFAULTS, SessionVars


@dataclass
class ResultSet:
    headers: List[str] = field(default_factory=list)
    rows: List[tuple] = field(default_factory=list)
    affected_rows: int = 0
    last_insert_id: int = 0
    warnings: List[str] = field(default_factory=list)
    is_query: bool = False
    ftypes: Optional[List[FieldType]] = None  # column types for the wire

    def scalar(self):
        return self.rows[0][0] if self.rows else None


_TYPE_MAP = {
    "bigint": lambda p, s: ty_int(),
    "int": lambda p, s: ty_int(),
    "integer": lambda p, s: ty_int(),
    "smallint": lambda p, s: ty_int(),
    "tinyint": lambda p, s: ty_int(),
    "bool": lambda p, s: ty_int(),
    "boolean": lambda p, s: ty_int(),
    "bigint unsigned": lambda p, s: ty_uint(),
    "double": lambda p, s: ty_float(),
    "float": lambda p, s: ty_float(),
    "real": lambda p, s: ty_float(),
    "decimal": lambda p, s: ty_decimal(p or 10, s),
    "numeric": lambda p, s: ty_decimal(p or 10, s),
    "varchar": lambda p, s: ty_string(),
    "char": lambda p, s: ty_string(),
    "text": lambda p, s: ty_string(),
    "blob": lambda p, s: ty_string(),
    "string": lambda p, s: ty_string(),
    "date": lambda p, s: ty_date(),
    "datetime": lambda p, s: ty_datetime(),
    "timestamp": lambda p, s: ty_datetime(),
    "time": lambda p, s: ty_time(),
    "bit": lambda p, s: ty_bit(p or 1),
    "json": lambda p, s: ty_json(),
}


class Session:
    def __init__(self, domain: Domain, conn_id: int = 0):
        self.domain = domain
        self.conn_id = conn_id
        self.vars = SessionVars(domain.global_vars)
        self.current_db = "test"
        # authenticated identity; in-process sessions are trusted as root,
        # the wire server overwrites this after the auth handshake
        self.user = "root@%"
        self.active_roles: List[str] = []  # SET ROLE state (MySQL roles)
        self._snapshot_ts = None  # SET tidb_snapshot historical-read TSO
        self._snapshot_pin = None  # storage pin token holding GC/compaction
        self._txn = None  # explicit txn (BEGIN..COMMIT)
        self._in_txn = False
        self._killed = False
        self._warnings: List[str] = []
        self._prepared: dict = {}  # name -> sql
        self.last_exec_ctx: Optional[ExecContext] = None
        self.last_plan = None
        self.last_trace = None  # finished QueryTrace of the last execute()
        # lifecycle: the in-flight statement's QueryScope (deadline +
        # cancel event) — KILL, the expensive-query watchdog and server
        # drain all cancel through it; and the last statement's
        # termination reason (ok|killed|timeout|mem_quota|overload|
        # shutdown|error) for the slow log / summary / metrics
        self._scope = None
        self.last_termination = "ok"
        self._pending_wire_read = None  # server-set COM_QUERY payload size
        self._pending_admission_wait_ns = 0  # server-set queue wait
        from collections import OrderedDict

        self._plan_cache: "OrderedDict" = OrderedDict()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def execute(self, sql: str, params: Optional[list] = None) -> List[ResultSet]:
        from . import bindinfo

        if bindinfo.is_binding_stmt(sql):
            return [bindinfo.handle(self, sql)]
        from ..lifecycle import (
            QueryScope,
            activate_scope,
            classify_termination,
            deactivate_scope,
            scope_active,
        )
        from ..trace import finish_trace, span, start_trace, tracing_active

        # one lifecycle scope per top-level execute(): the statement's
        # deadline (max_execution_time) + cancel event, observed at every
        # blocking host-side seam.  Nested executes (EXECUTE prepared,
        # TRACE targets, subplans) inherit the outer statement's scope.
        sc = sc_token = None
        if not scope_active():
            timeout_ms = self.vars.get_int("max_execution_time")
            sc = QueryScope(timeout_ms / 1000.0 if timeout_ms > 0 else None)
            # per-statement resource group: resolved ONCE at
            # scope creation (sysvar wins, then the user's ALTER USER
            # binding, then default); the group OBJECT rides the scope
            # so chunked dispatchers and fan-out workers never need a
            # domain lookup
            sc.resgroup = self.domain.resgroups.resolve(
                self.user, self.vars.get("tidb_tpu_resource_group") or "")
        # one trace per top-level execute() call: slow-log-enabled
        # sessions trace every statement; nested executes record into the
        # outer trace
        tr = token = None
        if not tracing_active() and self.vars.get_bool("tidb_enable_slow_log"):
            tr, token = start_trace(sql, self.conn_id)
            wr = getattr(self, "_pending_wire_read", None)
            if wr:
                # (bytes, socket-wait ns) from the wire layer; the wait
                # becomes an asyncio-level wire.read span so admission
                # wait and network wait are distinguishable in traces
                nb, wait_ns = wr if isinstance(wr, tuple) else (wr, 0)
                tr.root.set(wire_read_bytes=nb)
                if wait_ns:
                    tr.add_span("wire.read", wait_ns, bytes=nb)
                self._pending_wire_read = None
            aw = getattr(self, "_pending_admission_wait_ns", 0)
            if aw:
                tr.add_span("admission.wait", aw)
                self._pending_admission_wait_ns = 0
        exc: Optional[BaseException] = None
        # activation happens IMMEDIATELY before the try whose finally
        # deactivates: an exception in the setup above must not leak the
        # scope contextvar onto this pooled executor thread (a poisoned
        # worker would kill every later statement scheduled on it)
        if sc is not None:
            sc_token = activate_scope(sc)
            self._scope = sc  # KILL / watchdog / drain cancel through this
        try:
            out = []
            with span("parse"):
                stmts = parse(sql)
            if len(stmts) == 1:
                # plan-cache key: single-statement texts cache their plan
                stmts[0]._sql_text = sql
            for stmt in stmts:
                t0 = time.time()
                self.stmt_start, self.stmt_sql = t0, sql  # watchdog
                try:
                    rs = self._execute_stmt(stmt, params)
                finally:
                    self.stmt_start = None
                dur = time.time() - t0
                self.domain.record_stmt(sql, dur, len(rs.rows))
                out.append(rs)
            return out
        except BaseException as e:
            exc = e
            raise
        finally:
            term = None
            if sc is not None:
                term = classify_termination(exc, sc)
                self.last_termination = term
                deactivate_scope(sc_token)
                if term not in ("ok", "error"):
                    from ..metrics import REGISTRY

                    REGISTRY.inc(f"stmt_terminated_{term}_total")
                self.domain.record_termination(sql, term)
            if tr is not None:
                if term is not None:
                    tr.root.set(termination=term)
                self.last_trace = tr
                totals = finish_trace(tr, token)
                self._maybe_slow_log(tr, totals)
                self._observe_slo(sql, tr)

    def query(self, sql: str, params: Optional[list] = None) -> List[tuple]:
        """Convenience: rows of the last result set."""
        return self.execute(sql, params)[-1].rows

    def _maybe_slow_log(self, tr, totals):
        """Account a finished trace: phase aggregates always fold into
        the statement summary; the slow log gets an entry when the
        statement crossed tidb_slow_log_threshold ms (0 logs all)."""
        try:
            dur_ms = tr.duration_ms()
            threshold = self.vars.get_int("tidb_slow_log_threshold", 300)
            self.domain.record_trace(tr, totals, dur_ms,
                                     slow=dur_ms >= threshold)
        except Exception:
            # the slow log is advisory and must never fail the
            # statement — but silent breakage would disable the whole
            # accounting pipeline invisibly, so count it
            from ..metrics import REGISTRY

            REGISTRY.inc("trace_accounting_errors_total")

    def _observe_slo(self, sql: str, tr):
        """Per-statement-class end-to-end latency histogram + SLO
        error-budget burn counters: the class threshold rides
        `tidb_tpu_slo_<class>_ms` sysvars (0 disables burn accounting;
        the histogram always records).  The value ``auto`` derives the threshold from the rolling-window p99
        (trace.slo) instead of a fixed constant."""
        try:
            from ..metrics import REGISTRY
            from ..trace import stmt_class
            from ..trace.slo import SLO_AUTO, resolve_threshold_ms

            cls = stmt_class(sql)
            dur_ms = tr.duration_ms()
            REGISTRY.observe_hist(f"stmt_latency_{cls}_ms", dur_ms)
            # GLOBAL scope only: the burn counters are fleet-wide and
            # must agree with the threshold /status reports.  Resolve
            # BEFORE feeding the windows: a statement is judged against
            # the baseline of statements that preceded it — an outlier
            # must not dilate its own threshold
            thr = resolve_threshold_ms(
                self.vars.get_global_str(f"tidb_tpu_slo_{cls}_ms", "0"),
                cls)
            # fixed-threshold classes feed the rolling windows too, so
            # flipping a class to 'auto' acts on an already-warm baseline
            SLO_AUTO.observe(cls, dur_ms)
            if thr > 0:
                if dur_ms > thr:
                    REGISTRY.inc(f"slo_{cls}_breach_total")
                else:
                    REGISTRY.inc(f"slo_{cls}_ok_total")
        except Exception:
            from ..metrics import REGISTRY

            REGISTRY.inc("trace_accounting_errors_total")

    def kill(self, query_only: bool = True):
        """KILL QUERY (default): cancel the in-flight statement only.
        KILL CONNECTION (query_only=False): poison the session."""
        if not query_only:
            self._killed = True
        self.cancel_query("killed")

    def cancel_query(self, reason: str):
        """Cancel the in-flight statement's scope (KILL, the watchdog's
        max_execution_time enforcement, server drain).  The statement
        unwinds at its next host-side seam — backoff sleeps, fan-out
        tasks, tile/mesh chunk loops, MPP rungs, 2PC prewrite batches
        and DDL backfill batches all observe the same event."""
        sc = self._scope
        if sc is not None:
            sc.cancel(reason)
        if self.last_exec_ctx is not None:
            self.last_exec_ctx.killed = True

    # ------------------------------------------------------------------
    # txn lifecycle (lazy txn, session/txn.go:41-141)
    # ------------------------------------------------------------------
    def _begin_txn(self):
        if self._txn is None:
            txn = self.domain.storage.begin()
            cat = self.domain.catalog
            start_ver = cat.schema_version

            def schema_check():
                touched = {tid for (tid, _h) in txn.buffer.keys()}
                if any(cat.table_versions.get(tid, 0) > start_ver
                       for tid in touched):
                    raise SchemaChangedError()

            txn.schema_check = schema_check
            try:
                # MySQL clients tune row-lock waits per session; clamp to
                # MySQL's documented range [1, 1073741824] so a bogus SET
                # (get_int -> 0) can't turn every wait into an instant
                # timeout
                txn.lock_wait_timeout_s = float(min(max(
                    self.vars.get_int("innodb_lock_wait_timeout"), 1),
                    1 << 30))
            except Exception:
                pass
            self._txn = txn
        return self._txn

    def _autocommit(self) -> bool:
        return self.vars.get_bool("autocommit") and not self._in_txn

    def commit(self):
        if self._txn is not None:
            txn, self._txn = self._txn, None
            self._in_txn = False
            touched = {tid for (tid, _h) in txn.buffer.keys()}
            # the commit-time schema check runs inside txn.commit() after
            # prewrite (txn.schema_check, wired in _begin_txn)
            txn.commit()
            if touched:
                for tid in touched:
                    self.domain.storage.maybe_compact(tid)
                self.domain.maybe_auto_analyze(touched)
        else:
            self._in_txn = False

    def rollback(self):
        if self._txn is not None:
            txn, self._txn = self._txn, None
            self._in_txn = False
            txn.rollback()
        else:
            self._in_txn = False

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _execute_stmt(self, stmt: ast.Stmt, params=None) -> ResultSet:
        self._warnings = []
        s = stmt
        from . import priv as _priv

        _priv.check_stmt(self, s)  # optimize.go:128-131 choke point
        if self._snapshot_ts is not None:
            self._snapshot_write_guard(s)
        if isinstance(s, (ast.SelectStmt, ast.UnionStmt, ast.InsertStmt,
                          ast.UpdateStmt, ast.DeleteStmt,
                          ast.LoadDataStmt)):
            self._check_table_locks(s)
        elif isinstance(s, (ast.DropTableStmt, ast.TruncateTableStmt,
                            ast.AlterTableStmt, ast.RenameTableStmt,
                            ast.CreateIndexStmt, ast.DropIndexStmt)):
            tns = (s.tables if isinstance(s, ast.DropTableStmt)
                   else [s.old] if isinstance(s, ast.RenameTableStmt)
                   else [s.table])
            for tn in tns:
                self._check_ddl_table_lock(tn.db, tn.name)
        from ..errors import DeadlockError

        try:
            return self._dispatch_stmt(s, params)
        except DeadlockError:
            # the victim's whole transaction rolls back so the surviving
            # waiter proceeds immediately (MySQL/TiDB deadlock handling)
            self.rollback()
            raise

    def _dispatch_stmt(self, s, params=None) -> ResultSet:
        if isinstance(s, (ast.SelectStmt, ast.UnionStmt)):
            return self._run_query(s, params)
        if isinstance(s, (ast.InsertStmt, ast.UpdateStmt, ast.DeleteStmt,
                          ast.LoadDataStmt)):
            return self._run_dml(s, params)
        if isinstance(s, ast.ExplainStmt):
            return self._run_explain(s)
        if isinstance(s, ast.TraceStmt):
            return self._run_trace(s)
        if isinstance(s, ast.BeginStmt):
            self._in_txn = True
            self._begin_txn()
            return ResultSet()
        if isinstance(s, ast.CommitStmt):
            self.commit()
            return ResultSet()
        if isinstance(s, ast.RollbackStmt):
            self.rollback()
            return ResultSet()
        if isinstance(s, ast.UseStmt):
            if not self.domain.catalog.info_schema().has_schema(s.db):
                raise UnknownDatabaseError(s.db)
            self.current_db = s.db
            return ResultSet()
        if isinstance(s, ast.SetStmt):
            return self._run_set(s)
        if isinstance(s, ast.ShowStmt):
            return self._run_show(s)
        if isinstance(s, ast.DescTableStmt):
            return self._desc_table(s.table)
        if isinstance(s, ast.PrepareStmt):
            self._prepared[s.name] = s.sql
            return ResultSet()
        if isinstance(s, ast.ExecuteStmt):
            sqltext = self._prepared.get(s.name)
            if sqltext is None:
                raise PlanError(f"unknown prepared statement {s.name!r}")
            vals = [self.vars.user_vars.get(n) for n in s.using]
            rss = self.execute(sqltext, vals)
            return rss[-1]
        if isinstance(s, ast.DeallocateStmt):
            self._prepared.pop(s.name, None)
            return ResultSet()
        if isinstance(s, ast.KillStmt):
            self.domain.kill(s.conn_id, s.query_only)
            return ResultSet()
        if isinstance(s, ast.AnalyzeTableStmt):
            return self._run_analyze(s)
        if isinstance(s, ast.SplitRegionStmt):
            return self._run_split(s)
        if isinstance(s, ast.AdminStmt):
            return self._run_admin(s)
        if isinstance(s, (ast.GrantStmt, ast.RevokeStmt, ast.CreateUserStmt,
                          ast.DropUserStmt, ast.SetPasswordStmt,
                          ast.FlushStmt, ast.CreateRoleStmt,
                          ast.DropRoleStmt, ast.GrantRoleStmt,
                          ast.RevokeRoleStmt, ast.SetRoleStmt,
                          ast.SetDefaultRoleStmt)):
            from . import priv

            return priv.handle(self, s)
        if isinstance(s, ast.ResourceGroupStmt):
            return self._run_resource_group(s)
        if isinstance(s, ast.AlterUserResourceGroupStmt):
            try:
                self.domain.resgroups.bind_user(s.user, s.group)
            except KeyError:
                raise ExecutorError(
                    f"unknown resource group {s.group!r}")
            self.domain.resgroups.publish()  # bindings replicate too
            return ResultSet()
        if isinstance(s, ast.LockTablesStmt):
            return self._run_lock_tables(s)
        if isinstance(s, ast.UnlockTablesStmt):
            self._release_table_locks()
            return ResultSet()
        # ---- DDL ------------------------------------------------------
        return self._run_ddl(s)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    def _pctx(self, hints=None) -> PhysicalContext:
        dirty = frozenset(
            tid for (tid, _h) in (self._txn.buffer.keys() if self._txn else ())
        )
        prefer_merge = self.vars.get_bool("tidb_opt_prefer_merge_join")
        enable_ij = self.vars.get_bool("tidb_opt_enable_index_join")
        variant = (self.vars.get("tidb_index_join_variant") or "lookup").lower()
        allow_mpp = self.vars.get_bool("tidb_allow_mpp")
        if hints:
            # per-statement optimizer hints (binding USING /*+ ... */)
            if "merge_join" in hints:
                prefer_merge, enable_ij = True, False
            if "hash_join" in hints:
                # HASH_JOIN pins the root algorithm: no index/mpp reroute
                prefer_merge, enable_ij, allow_mpp = False, False, False
            if "inl_join" in hints or "index_join" in hints:
                enable_ij, prefer_merge = True, False
            if "inl_hash_join" in hints:
                enable_ij, prefer_merge, variant = True, False, "hash"
            if "no_index_join" in hints:
                enable_ij = False
        return PhysicalContext(
            storage=self.domain.storage,
            dirty_tables=dirty,
            pushdown_blacklist=frozenset(),
            enable_pushdown=self.vars.get_bool("tidb_enable_pushdown"),
            stats=self.domain.stats,
            prefer_merge_join=prefer_merge,
            enable_index_join=enable_ij,
            index_join_variant=variant,
            check_plan=self.vars.get_bool("tidb_check_plan"),
            allow_mpp=allow_mpp,
            enforce_mpp=self.vars.get_bool("tidb_enforce_mpp"),
            mpp_threshold=self.vars.get_int(
                "tidb_broadcast_join_threshold_count", 10240),
        )

    def _infoschema(self):
        """Schema for planning/execution: historical when tidb_snapshot is
        pinned (GetSnapshotInfoSchema), else current."""
        if self._snapshot_ts is not None:
            from ..store.oracle import extract_physical

            return self.domain.catalog.info_schema_at(
                extract_physical(self._snapshot_ts))
        return self.domain.catalog.info_schema()

    def _exec_ctx(self, current_read: bool = False) -> ExecContext:
        txn = self._txn if self._in_txn or self._txn is not None else None
        snap = self._snapshot_ts
        if txn is None and snap is not None:
            read_ts = snap  # historical read (tidb_snapshot)
        else:
            read_ts = self.domain.storage.current_ts() if txn is None else 0
        ctx = ExecContext(
            self.domain.storage,
            infoschema=self._infoschema(),
            sess_vars=self.vars,
            txn=txn,
            read_ts=read_ts,
        )
        ctx.current_read = current_read
        ctx.historical = snap is not None  # stats feedback skips stale reads
        ctx.killed = self._killed
        ctx.domain = self.domain  # memtable providers read live state
        self.last_exec_ctx = ctx
        return ctx

    def _exec_subplan(self, logical) -> List[tuple]:
        phys = finish_plan(logical, self._pctx())
        ctx = self._exec_ctx()
        chunks = collect_all(phys.build(ctx))
        rows: List[tuple] = []
        for c in chunks:
            rows.extend(c.to_pylist())
        return rows

    def _plan(self, stmt, params=None):
        from ..trace import span
        from . import bindinfo

        with span("plan") as sp:
            stmt, hints = bindinfo.apply_binding(self, stmt)
            key = self._plan_cache_key(stmt, params)
            if key is not None:
                hit = self._plan_cache.get(key)
                if hit is not None:
                    from ..metrics import REGISTRY

                    REGISTRY.inc("plan_cache_hits_total")
                    self._plan_cache.move_to_end(key)
                    sp.set(plan_cache="hit")
                    return hit
            phys = plan_statement(
                stmt, self._infoschema(), self.current_db,
                self._pctx(hints), exec_subplan=self._exec_subplan,
                param_values=params,
            )
            if key is not None:
                from ..metrics import REGISTRY

                REGISTRY.inc("plan_cache_misses_total")
                self._plan_cache[key] = phys
                cap = max(self.vars.get_int("tidb_plan_cache_size", 128), 1)
                while len(self._plan_cache) > cap:
                    self._plan_cache.popitem(last=False)
                sp.set(plan_cache="miss")
            return phys

    def _plan_cache_key(self, stmt, params):
        """Cache key for repeated statements (planner/core/cache.go analog:
        keyed on text + schema version + PER-TABLE data versions + planner
        vars) — DML against unrelated tables leaves cached plans valid.
        None disables caching: txn writes change pushdown eligibility, and
        parameterized plans bake constant ranges."""
        if params is not None or self._txn is not None \
                or self._snapshot_ts is not None:
            return None  # historical reads: never cache
        if not isinstance(stmt, (ast.SelectStmt, ast.UnionStmt)):
            return None
        sql = getattr(stmt, "_sql_text", None)
        if sql is None:
            return None
        from .priv import _walk_tables

        refs: list = []
        _walk_tables(stmt, refs)
        isc = self.domain.catalog.info_schema()
        # shape-bucketed per-table version (serving): key plans on the
        # table's ROW-COUNT BUCKET + base version instead of the raw
        # committed-write counter — steady-state DML that stays within a
        # table's pow2 size class keeps its cached plans valid (plans
        # read data at execution time; only stats/schema/bindings shifts,
        # all keyed separately, change what the planner would pick)
        use_buckets = self.vars.get_bool("tidb_tpu_shape_buckets")
        from ..serving import shape_bucket

        vers = []
        seen = set()
        for tn in refs:
            db = (tn.db or self.current_db).lower()
            name = tn.name.lower()
            if (db, name) in seen:
                continue
            seen.add((db, name))
            if db in ("information_schema", "performance_schema"):
                return None  # memtables: live state, never cache
            if not isc.has_table(db, name):
                return None
            t = isc.table(db, name)
            if t.is_view:
                # views hide their base tables from the AST walk: fall
                # back to the global version (always-correct, coarser)
                vers.append(("__global__",
                             self.domain.storage.data_version()))
                continue
            for pid in (t.physical_ids() + [t.id]
                        if t.partition_info else [t.id]):
                st = self.domain.stats.get(pid)
                stats_ver = (st.version, st.build_time) if st else None
                if pid == t.id and t.partition_info:
                    vers.append((pid, 0, stats_ver))
                    continue
                try:
                    store = self.domain.storage.table(pid)
                except KVError:
                    return None
                if use_buckets:
                    vers.append((pid, store.base_version,
                                 shape_bucket(store.base_rows
                                              + len(store.delta) + 1),
                                 stats_ver))
                else:
                    vers.append((pid, store.mutations, stats_ver))
        return (
            sql, self.current_db,
            self.domain.catalog.schema_version,
            tuple(vers),
            # learned-selectivity generation: feedback that materially
            # moved an estimate must re-plan cached statements
            self.domain.stats.feedback.epoch,
            # layout-decision generation (tidb_tpu/layout): a re-tuned
            # column layout shifts scan cost (cold decode) and program
            # shapes, so cached plans must not outlive the decision
            _layout_epoch(),
            getattr(self.domain, "bindings_version", 0),
            getattr(self, "_bindings_version", 0),
            self.vars.get_bool("tidb_enable_pushdown"),
            self.vars.get_bool("tidb_opt_prefer_merge_join"),
            self.vars.get_bool("tidb_opt_enable_index_join"),
            self.vars.get("tidb_index_join_variant"),
            self.vars.get_bool("tidb_allow_mpp"),
            self.vars.get_bool("tidb_enforce_mpp"),
            self.vars.get_int("tidb_broadcast_join_threshold_count",
                              10240),
        )

    def _run_query(self, stmt, params=None) -> ResultSet:
        for_update = getattr(stmt, "for_update", False)
        if for_update:
            self._select_for_update_lock(stmt, params)
        phys = self._plan(stmt, params)
        self.last_plan = phys
        sql = getattr(stmt, "_sql_text", None)
        if sql is not None:
            from . import bindinfo

            bindinfo.maybe_capture(self, sql, stmt, phys)
        ctx = self._exec_ctx(current_read=for_update)
        exe = phys.build(ctx)
        chunks = collect_all(exe)
        headers = phys.schema.headers() if len(phys.schema) else []
        rows: List[tuple] = []
        fts = phys.schema.ftypes()
        for c in chunks:
            for r in c.to_pylist():
                rows.append(_format_row(r, fts))
        return ResultSet(headers=headers, rows=rows, is_query=True,
                         warnings=self._warnings + list(ctx.warnings),
                         ftypes=fts)

    def _select_for_update_lock(self, stmt, params=None):
        """SELECT ... FOR UPDATE: pessimistically lock the matching rows
        before the read runs (executor/adapter.go:338-372 SelectLockExec
        path).  Scope: single-table FROM (the reference locks each table's
        handles; joins fall back to snapshot reads with a warning)."""
        if not isinstance(stmt, ast.SelectStmt) or stmt.from_clause is None:
            return
        if not isinstance(stmt.from_clause, ast.TableName):
            self._warnings.append(
                "FOR UPDATE on multi-table queries reads at snapshot "
                "(row locks not taken)")
            return
        t = self.domain.catalog.info_schema().table(
            stmt.from_clause.db or self.current_db, stmt.from_clause.name)
        if t.is_view:
            return
        if self._autocommit():
            # autocommit FOR UPDATE: locks would release at statement end
            # anyway (MySQL semantics) — read at snapshot, take none
            return
        # reuse the DELETE condition builder: conditions over full-row
        # offsets, then the handle scan locates matching (pid, handle)s.
        # Shapes the row-locator cannot express (subqueries in WHERE, ...)
        # degrade to a snapshot read with a warning rather than erroring.
        fake = ast.DeleteStmt(stmt.from_clause, stmt.where)
        pb = PlanBuilder(self.domain.catalog.info_schema(), self.current_db,
                         param_values=params)
        try:
            plan = pb.build_delete(fake)
        except TiDBTPUError as e:
            self._warnings.append(
                f"FOR UPDATE reads at snapshot (row locks not taken: {e})")
            return
        from ..planner.physical import _dml_readers

        txn = self._begin_txn()
        # FOR UPDATE is a current read: take the lock horizon at statement
        # start so rows committed after txn start are seen and locked
        txn.for_update_ts = max(txn.for_update_ts,
                                self.domain.storage.current_ts())
        ctx = self._exec_ctx(current_read=True)
        keys = []
        for pid, reader in _dml_readers(ctx, plan.table, plan.conditions,
                                        -1):
            reader.open()
            try:
                while True:
                    c = reader.next()
                    if c is None:
                        break
                    for h in c.col(0).data:
                        keys.append((pid, int(h)))
            finally:
                reader.close()
        if keys:
            txn.lock_keys(*keys)

    def _run_dml(self, stmt, params=None) -> ResultSet:
        retries = max(self.vars.get_int("tidb_retry_limit", 10), 0)
        attempt = 0
        while True:
            attempt += 1
            auto = self._autocommit() and self._txn is None
            txn = self._begin_txn()
            ctx = self._exec_ctx(current_read=True)
            try:
                phys = self._plan(stmt, params)
                self.last_plan = phys
                collect_all(phys.build(ctx))
                if auto:
                    self.commit()  # compaction/auto-analyze hooks run there
                return ResultSet(affected_rows=ctx.affected_rows,
                                 last_insert_id=ctx.last_insert_id,
                                 warnings=list(ctx.warnings))
            except TxnConflictError:
                # optimistic retry (session.go:635) — autocommit only
                self.rollback()
                if not auto or attempt > retries or \
                        self.vars.get_bool("tidb_disable_txn_auto_retry"):
                    raise
            except Exception:
                if auto:
                    self.rollback()
                raise

    def _run_explain(self, s: ast.ExplainStmt) -> ResultSet:
        if isinstance(s.target, (ast.SelectStmt, ast.UnionStmt,
                                 ast.InsertStmt, ast.UpdateStmt,
                                 ast.DeleteStmt)):
            outer = getattr(s, "_sql_text", None)
            if outer is not None:
                # bindings match on the inner statement's digest
                s.target._sql_text = outer
            phys = self._plan(s.target)
        else:
            raise PlanError("EXPLAIN supports SELECT/DML only")
        if s.analyze:
            ctx = self._exec_ctx()
            auto = self._autocommit() and self._txn is None and isinstance(
                s.target, (ast.InsertStmt, ast.UpdateStmt, ast.DeleteStmt)
            )
            if auto:
                ctx.txn = self._begin_txn()
            collect_all(phys.build(ctx))
            if auto:
                self.commit()
            rows = []
            op_samples = []
            for nm, est, task, info in phys.explain_tree():
                st = ctx.stats.get(_plan_id_of(nm))
                extra = ""
                if st:
                    extra = (f"rows:{st.rows} loops:{st.loops} "
                             f"time:{st.time_ns/1e6:.2f}ms")
                    if st.engine:
                        extra += f" engine:{st.engine}"
                    op_id = nm.lstrip(" ").lstrip("└─")
                    depth = (len(nm) - len(nm.lstrip(" "))) // 2
                    op_samples.append((depth, op_id, st.time_ns))
                rows.append((nm, est, task, info, extra))
            # operator sampling: EXPLAIN ANALYZE runs feed
            # their per-operator self-times into the continuous
            # profiler, so flame frames carry plan operator ids
            from ..trace.profiler import PROFILER

            PROFILER.fold_explain(op_samples)
            # per-statement HBM high-water attribution: the
            # dispatch sites stamp resident device bytes on the execute
            # spans; surface the peak on the root operator's line
            from ..trace import current_trace

            ltr = current_trace()
            if ltr is not None and rows:
                tot = ltr.phase_totals()
                peak = tot.get("hbm_peak_bytes", 0)
                if peak:
                    nm, est, task, info, extra = rows[0]
                    extra = (extra + " " if extra else "") \
                        + f"hbm_peak:{peak}"
                    rows[0] = (nm, est, task, info, extra)
                # chunked-dispatch visibility: how many
                # device launches the statement's fragments split into
                nchunks = tot.get("chunks", 0)
                if nchunks:
                    nm, est, task, info, extra = rows[0]
                    extra = (extra + " " if extra else "") \
                        + f"chunks: {nchunks}"
                    rows[0] = (nm, est, task, info, extra)
            return ResultSet(
                headers=["id", "estRows", "task", "info", "execution info"],
                rows=rows, is_query=True)
        rows = list(phys.explain_tree())
        return ResultSet(headers=["id", "estRows", "task", "info"], rows=rows,
                         is_query=True)

    def _run_trace(self, s: ast.TraceStmt) -> ResultSet:
        """TRACE [FORMAT='row'|'json'] <stmt> (executor/trace.go): run the
        target under the span recorder and return its span tree.  When the
        session already traces (slow log enabled) the target's spans land
        in the active trace; otherwise TRACE forces one of its own."""
        import json as _json

        from ..trace import current_trace, finish_trace, start_trace

        tr = current_trace()
        owned = False
        if tr is None:
            tr, token = start_trace(getattr(self, "stmt_sql", "") or "trace",
                                    self.conn_id)
            owned = True
        try:
            self._execute_stmt(s.target)
        finally:
            if owned:
                finish_trace(tr, token)
        self.last_trace = tr
        fmt = getattr(s, "fmt", "row")
        if fmt == "json":
            return ResultSet(
                headers=["operation"],
                rows=[(_json.dumps(tr.to_dict(), sort_keys=True),)],
                is_query=True)
        return ResultSet(headers=["operation", "startTS", "duration"],
                         rows=tr.rows(), is_query=True)

    # ------------------------------------------------------------------
    # SET / SHOW / DESC
    # ------------------------------------------------------------------
    def _run_set(self, s: ast.SetStmt) -> ResultSet:
        from ..planner.expr_build import ExprBuilder
        from ..planner.columns import Schema

        eb = ExprBuilder(Schema([]), None, None, [], None)
        for name, is_global, vexpr in s.assignments:
            if isinstance(vexpr, ast.Default):
                value = SYSVAR_DEFAULTS.get(name.lower(), ("",))[0]
            else:
                from ..planner.build import _eval_const

                value = _eval_const(eb.build(vexpr))
            if name.lower() == "tidb_snapshot":
                self._set_snapshot(value)
                continue
            if name.lower() == "tidb_profiling":
                self._set_profiling(value)
                continue
            if not is_global and not self.vars.known(name) \
                    and name.lower() not in SYSVAR_DEFAULTS:
                # unknown non-global names are user variables (@x); the
                # lexer strips the @ marker
                self.vars.user_vars[name] = value
            elif is_global:
                self.vars.set_global(name, value)
            else:
                self.vars.set_session(name, value)
            from .. import serving

            if name.lower() in serving._SYSVARS:
                # serving knobs configure a process-wide resource (the
                # batcher / bucket policy), mirroring max_connections
                serving.refresh_from_vars(self.vars)
            if name.lower() == "tidb_tpu_dispatch_chunk_ms":
                # the dispatchers read a process knob (like the serving
                # sysvars): GLOBAL or SESSION set both retarget it —
                # chunking guards a shared device, not a session
                from ..copr.chunking import set_dispatch_chunk_ms

                try:
                    set_dispatch_chunk_ms(float(value))
                except (TypeError, ValueError):
                    pass
        return ResultSet()

    def _snapshot_write_guard(self, s):
        """TiDB rejects EVERY write statement under tidb_snapshot — DML,
        DDL, and EXPLAIN ANALYZE of DML (which executes)."""
        wr = (ast.InsertStmt, ast.UpdateStmt, ast.DeleteStmt,
              ast.LoadDataStmt, ast.CreateTableStmt, ast.DropTableStmt,
              ast.TruncateTableStmt, ast.AlterTableStmt,
              ast.RenameTableStmt, ast.CreateIndexStmt, ast.DropIndexStmt,
              ast.CreateDatabaseStmt, ast.DropDatabaseStmt,
              ast.CreateViewStmt, ast.AnalyzeTableStmt,
              ast.RecoverTableStmt, ast.DropStatsStmt,
              ast.RepairTableStmt)
        target = s.target if isinstance(s, (ast.ExplainStmt,
                                            ast.TraceStmt)) else s
        analyze = getattr(s, "analyze", True)  # plain EXPLAIN is read-only
        if isinstance(target, wr) and (target is s or analyze):
            raise ExecutorError(
                "can not execute write statement when 'tidb_snapshot' "
                "is set")

    def _set_snapshot(self, value):
        """SET tidb_snapshot: pin autocommit reads to a historical TSO
        (session.go setSnapshotTS / GetSnapshotInfoSchema role).  Accepts a
        raw TSO, a unix-seconds number, or 'YYYY-MM-DD HH:MM:SS'; bounded
        below by the GC safepoint.  Empty string clears it.

        Bounds beyond GC: column-layout DDL (ADD/DROP/MODIFY COLUMN)
        rebuilds the store eagerly (catalog._rebuild_storage), so data time
        travel does not cross such a DDL — reads older than the rebuild
        raise 'snapshot is older than the compaction horizon'.  While a
        snapshot is pinned, GC and background compaction hold their floor
        at the pinned TSO (storage.pin_read), so DML-only history
        time-travels exactly."""
        from ..store.oracle import compose_ts

        if value in ("", None, 0):
            self._snapshot_ts = None
            self._unpin_snapshot()
            self.vars.set_session("tidb_snapshot", "")
            return
        if self._txn is not None or self._in_txn:
            raise PlanError(
                "can not set tidb_snapshot during a transaction")
        try:
            if isinstance(value, str):
                from ..types.values import parse_datetime

                ts = compose_ts(parse_datetime(value) // 1000, 0)
            else:
                v = int(value)
                # heuristic matching TiDB: big values are TSOs, small
                # ones unix seconds
                ts = v if v > (1 << 40) else compose_ts(v * 1000, 0)
        except (ValueError, TypeError) as e:
            raise PlanError(f"invalid tidb_snapshot value {value!r}: {e}")
        floor = self.domain.maintenance.last_safepoint
        if floor and ts < floor:
            raise PlanError(
                "snapshot is older than GC safe point")
        self._snapshot_ts = ts
        # hold GC + compaction at this TSO for the life of the pin:
        # without it background compaction advances base_ts and the
        # historical read silently turns empty (ADVICE r4 #1)
        self._unpin_snapshot()
        self._snapshot_pin = self.domain.storage.pin_read(ts)
        self.vars.set_session("tidb_snapshot", str(ts))

    def _set_profiling(self, value):
        """SET tidb_profiling = 1|0: toggle the domain cProfile collector
        surfaced through information_schema.tidb_profile (util/profile's
        pprof table role; covers the session thread's planner/executor
        work — distsql worker threads run outside the collector)."""
        on = str(value).strip().lower() in ("1", "true", "on")
        dom = self.domain
        if on and getattr(dom, "profiler", None) is None:
            import cProfile

            dom.profiler = cProfile.Profile()
            dom.profiler.enable()
        elif not on and getattr(dom, "profiler", None) is not None:
            dom.profiler.disable()
            dom.profiler = None
        # the collector is domain-wide: mirror its ACTUAL state where
        # operators look (SHOW VARIABLES / cluster_config)
        dom.global_vars["tidb_profiling"] = "1" if on else "0"
        self.vars.set_session("tidb_profiling", "1" if on else "0")

    def _unpin_snapshot(self):
        if self._snapshot_pin is not None:
            self.domain.storage.unpin_read(self._snapshot_pin)
            self._snapshot_pin = None

    def close(self):
        """Connection teardown: release snapshot pins and roll back any
        open transaction so GC/compaction are not held forever."""
        self._unpin_snapshot()
        try:
            if self._txn is not None:
                self.rollback()
        except Exception:
            pass

    def _run_show(self, s: ast.ShowStmt) -> ResultSet:
        import fnmatch

        kind = s.kind
        isc = self._infoschema()  # snapshot-aware (tidb_snapshot)

        def like_filter(names):
            if s.like:
                pat = s.like.replace("%", "*").replace("_", "?")
                return [n for n in names if fnmatch.fnmatch(n.lower(),
                                                            pat.lower())]
            return names

        if kind == "databases":
            names = like_filter(isc.schema_names())
            return ResultSet(["Database"], [(n,) for n in names],
                             is_query=True)
        if kind == "tables":
            db = s.db or self.current_db
            names = like_filter([t.name for t in isc.tables(db)])
            return ResultSet([f"Tables_in_{db}"], [(n,) for n in names],
                             is_query=True)
        if kind in ("columns", "full_columns"):
            return self._desc_table(ast.TableName(s.target, s.db))
        if kind == "create_table":
            db = s.db or self.current_db
            t = isc.table(db, s.target)
            return ResultSet(["Table", "Create Table"],
                             [(t.name, _show_create(t))], is_query=True)
        if kind == "index":
            db = s.db or self.current_db
            t = isc.table(db, s.target)
            rows = []
            for ix in t.indexes:
                for seq, col in enumerate(ix.columns):
                    rows.append((t.name, 0 if ix.unique else 1, ix.name,
                                 seq + 1, col))
            return ResultSet(
                ["Table", "Non_unique", "Key_name", "Seq_in_index",
                 "Column_name"], rows, is_query=True)
        if kind == "grants":
            user = s.target or self.user
            rows = [(g,) for g in self.domain.priv.show_grants(user)]
            from .priv import _norm_user

            return ResultSet([f"Grants for {_norm_user(user)}"], rows,
                             is_query=True)
        if kind == "variables":
            allv = self.vars.all_vars()
            names = like_filter(sorted(allv))
            return ResultSet(["Variable_name", "Value"],
                             [(n, allv[n]) for n in names], is_query=True)
        if kind == "warnings":
            return ResultSet(["Level", "Code", "Message"],
                             [("Warning", 0, w) for w in self._warnings],
                             is_query=True)
        if kind == "processlist":
            # single source of truth: the information_schema provider
            from ..infoschema_tables import MEMTABLES

            cols, provider = MEMTABLES["processlist"]
            rows = provider(self.domain, isc)
            return ResultSet([c[0].title() for c in cols], rows,
                             is_query=True)
        if kind in ("stats_meta", "stats_histograms", "stats_buckets"):
            return self._show_stats(kind)
        if kind == "stats_healthy":
            # health = 100 * (1 - modified/count) (handle.go Healthy):
            # modified counts MVCC versions committed AFTER the stats were
            # built (deletes/updates mutate chains in place, so chain
            # lengths alone can't tell old rows from new modifications)
            from ..store.oracle import extract_physical

            rows = []
            for dbn in isc.schema_names():
                for t in isc.tables(dbn):
                    if t.is_view:
                        continue
                    st = self.domain.stats.get(t.id)
                    if st is None:
                        continue
                    build_ms = int((st.build_time or 0) * 1000)
                    modified = 0
                    for pid in t.physical_ids():
                        try:
                            store = self.domain.storage.table(pid)
                        except KVError:
                            continue
                        for chain in store.delta.values():
                            for v in chain:
                                if extract_physical(
                                        v.commit_ts) > build_ms:
                                    modified += 1
                    health = max(0, 100 - int(
                        100 * modified / max(st.row_count, 1)))
                    rows.append((dbn, t.name, "", health))
            return ResultSet(
                ["Db_name", "Table_name", "Partition_name", "Healthy"],
                rows, is_query=True)
        if kind == "analyze_status":
            db_of = {}
            for dbn in isc.schema_names():
                for t in isc.tables(dbn):
                    db_of[t.id] = dbn
            rows = []
            for tid, st in sorted(
                    self.domain.stats.cache_snapshot().items()):
                owner = isc.table_by_id(tid)
                if owner is None:
                    continue
                rows.append((
                    db_of.get(owner.id, ""), owner.name,
                    "" if tid == owner.id else f"pid {tid}",
                    "analyze columns", st.row_count,
                    time.strftime("%Y-%m-%d %H:%M:%S",
                                  time.localtime(st.build_time or 0)),
                    "finished"))
            return ResultSet(
                ["Table_schema", "Table_name", "Partition", "Job_info",
                 "Processed_rows", "Start_time", "State"], rows,
                is_query=True)
        if kind == "regions":
            db = s.db or self.current_db
            t = isc.table(db, s.target)
            rows = []
            for pid in t.physical_ids():
                for r in self.domain.storage.regions.regions_of(pid):
                    rows.append((r.region_id, t.name, r.start,
                                 "inf" if r.end >= (1 << 62) else r.end,
                                 r.epoch, r.leader_store))
            return ResultSet(
                ["Region_id", "Table", "Start", "End", "Epoch", "Leader"],
                rows, is_query=True)
        if kind == "stats":
            rows = []
            for db in isc.schema_names():
                for t in isc.tables(db):
                    if t.is_view:
                        continue
                    base = delta = nbytes = 0
                    for pid in t.physical_ids():
                        store = self.domain.storage.table(pid)
                        base += store.base_rows
                        delta += len(store.delta)
                        nbytes += store.nbytes()
                    rows.append((db, t.name, base, delta, nbytes))
            return ResultSet(
                ["Db_name", "Table_name", "Base_rows", "Delta_rows", "Bytes"],
                rows, is_query=True)
        raise PlanError(f"SHOW {kind} not supported")

    def _show_stats(self, kind: str) -> ResultSet:
        """SHOW STATS_META / STATS_HISTOGRAMS / STATS_BUCKETS over the
        stats cache (statistics/handle + executor/show_stats.go)."""
        import time as _time

        isc = self.domain.catalog.info_schema()
        stats = self.domain.stats
        meta_rows, hist_rows, bucket_rows = [], [], []
        for dbn in isc.schema_names():
            for t in isc.tables(dbn):
                if t.is_view:
                    continue
                targets = [("", t.id)]
                if t.partition_info is not None:
                    targets += [(p.name, p.id)
                                for p in t.partition_info.defs]
                for part_name, tid in targets:
                    st = stats.get(tid)
                    if st is None:
                        continue
                    mtime = _time.strftime(
                        "%Y-%m-%d %H:%M:%S",
                        _time.localtime(st.build_time or 0))
                    meta_rows.append((dbn, t.name, part_name, mtime,
                                      st.modify_count, st.row_count))
                    for ci, cs in sorted(st.columns.items()):
                        if ci >= len(t.columns):
                            continue
                        cname = t.columns[ci].name
                        hist_rows.append((
                            dbn, t.name, part_name, cname, 0,
                            mtime, cs.ndv, cs.null_count,
                            len(cs.hist.buckets)))
                        for bi, b in enumerate(cs.hist.buckets):
                            bucket_rows.append((
                                dbn, t.name, part_name, cname, bi,
                                b.count, b.repeat, b.lower, b.upper))
        if kind == "stats_meta":
            return ResultSet(
                ["Db_name", "Table_name", "Partition_name", "Update_time",
                 "Modify_count", "Row_count"], meta_rows, is_query=True)
        if kind == "stats_histograms":
            return ResultSet(
                ["Db_name", "Table_name", "Partition_name", "Column_name",
                 "Is_index", "Update_time", "Distinct_count", "Null_count",
                 "Buckets"], hist_rows, is_query=True)
        return ResultSet(
            ["Db_name", "Table_name", "Partition_name", "Column_name",
             "Bucket_id", "Count", "Repeats", "Lower_Bound", "Upper_Bound"],
            bucket_rows, is_query=True)

    def _desc_table(self, tn: ast.TableName) -> ResultSet:
        t = self.domain.catalog.info_schema().table(
            tn.db or self.current_db, tn.name
        )
        rows = []
        for c in t.public_columns():
            key = ""
            if c.primary_key:
                key = "PRI"
            elif any(ix.unique and ix.columns == [c.name] for ix in t.indexes):
                key = "UNI"
            elif any(c.name in ix.columns for ix in t.indexes):
                key = "MUL"
            rows.append((
                c.name, c.ftype.sql_name().lower(),
                "YES" if c.ftype.nullable else "NO", key,
                c.default if c.has_default else None,
                "auto_increment" if c.auto_increment else "",
            ))
        return ResultSet(["Field", "Type", "Null", "Key", "Default", "Extra"],
                         rows, is_query=True)

    # ------------------------------------------------------------------
    # ANALYZE / ADMIN / SPLIT
    # ------------------------------------------------------------------
    def _run_analyze(self, s: ast.AnalyzeTableStmt) -> ResultSet:
        for tn in s.tables:
            t = self.domain.catalog.info_schema().table(
                tn.db or self.current_db, tn.name
            )
            for pid in t.physical_ids():
                store = self.domain.storage.table(pid)
                for ci in range(store.n_cols):
                    store.column_stats(ci)  # warm min/max (device engine)
            self.domain.stats.analyze(t)
        return ResultSet()

    def _run_split(self, s: ast.SplitRegionStmt) -> ResultSet:
        t = self.domain.catalog.info_schema().table(
            s.table.db or self.current_db, s.table.name
        )
        n = 0
        for pid in t.physical_ids():
            store = self.domain.storage.table(pid)
            self.domain.storage.regions.split_even(
                pid, s.num, max(store.base_rows, store.next_handle)
            )
            n += len(self.domain.storage.regions.regions_of(pid))
        return ResultSet(["TOTAL_SPLIT_REGION"], [(n,)], is_query=True)

    def _run_admin(self, s: ast.AdminStmt) -> ResultSet:
        if s.kind in ("show_ddl", "show_ddl_jobs"):
            rows = [
                (j.id, j.typ, j.db, j.table, j.state, j.schema_version,
                 ",".join(j.states_walked))
                for j in reversed(self.domain.catalog.jobs[-20:])
            ]
            return ResultSet(
                ["Job_id", "Type", "Db", "Table", "State", "Schema_ver",
                 "States"], rows, is_query=True)
        if s.kind == "check_table":
            for tn in s.tables:
                t = self.domain.catalog.info_schema().table(
                    tn.db or self.current_db, tn.name
                )
                self._admin_check_table(t)
            return ResultSet()
        if s.kind in ("recover_index", "cleanup_index"):
            tn = s.tables[0]
            t = self.domain.catalog.info_schema().table(
                tn.db or self.current_db, tn.name)
            return self._admin_repair_index(t, s.index, s.kind)
        if s.kind == "checksum_table":
            rows = []
            for tn in s.tables:
                db = tn.db or self.current_db
                t = self.domain.catalog.info_schema().table(db, tn.name)
                rows.append((db, tn.name) + self._checksum_table(t))
            return ResultSet(
                ["Db_name", "Table_name", "Checksum_crc64_xor",
                 "Total_kvs", "Total_bytes"], rows, is_query=True)
        if s.kind == "show_next_row_id":
            tn = s.tables[0]
            db = tn.db or self.current_db
            t = self.domain.catalog.info_schema().table(db, tn.name)
            nid = max(self.domain.storage.table(pid).next_handle
                      for pid in t.physical_ids())
            return ResultSet(
                ["DB_NAME", "TABLE_NAME", "COLUMN_NAME", "NEXT_GLOBAL_ROW_ID"],
                [(db, tn.name, "_tidb_rowid", max(nid, t.auto_inc_id))],
                is_query=True)
        raise PlanError(f"ADMIN {s.kind} not supported")

    def _checksum_table(self, t: TableInfo):
        """(crc64_xor, total_kvs, total_bytes) over the VISIBLE rows of
        every physical store (the reference's checksum cop request,
        kv/kv.go:206-211, computed in-process).

        Columnar and streaming: a running crc per column over its visible
        bytes plus validity, fed 64K rows at a time so memory stays
        bounded at bench scale; the committed delta overlay rides along
        as a per-column tail.  Per-store, the (index, data crc, validity
        crc) records are themselves crc'd — crc32 is linear over GF(2),
        so XOR-combining per-column crcs (seeded or not) cancels under
        equal-length column swaps; hashing the record stream binds each
        crc to its column ordinal non-linearly.  Object values are
        length-prefixed (a bare separator would make ['a\\x1f','b'] and
        ['a','\\x1fb'] collide).  No per-row Python loop — the old repr()
        row walk took minutes at bench scale (round-5 ADVICE) and is the
        purity lint's canonical row-loop specimen (tests/test_lint.py)."""
        import struct
        import zlib

        from ..chunk.column import Column

        def col_bytes(col):
            if col.data.dtype == object:
                enc = [str(x).encode() for x in col.data]
                return b"".join(len(s).to_bytes(4, "little") + s
                                for s in enc)
            return np.ascontiguousarray(col.data).tobytes()

        ts = self.domain.storage.current_ts()
        crc = 0
        kvs = 0
        nbytes = 0
        step = 1 << 16
        for pid in t.physical_ids():
            store = self.domain.storage.table(pid)
            deleted, inserted = store.delta_overlay(ts, 0, 1 << 62)
            n = store.base_rows
            if not n and not inserted:
                continue
            keep = np.ones(n, dtype=np.bool_)
            if deleted:
                keep[np.fromiter(deleted, dtype=np.int64,
                                 count=len(deleted))] = False
            ncols = store.n_cols
            col_crcs = [0] * ncols
            val_crcs = [0] * ncols
            store_kvs = 0
            for lo in range(0, n, step):
                hi = min(lo + step, n)
                chunk = store.base_chunk(range(ncols), lo, hi)
                kslice = keep[lo:hi]
                vis = chunk if kslice.all() else chunk.filter(kslice)
                store_kvs += vis.num_rows
                for ci in range(ncols):
                    col = vis.col(ci)
                    raw = col_bytes(col)
                    col_crcs[ci] = zlib.crc32(raw, col_crcs[ci])
                    val_crcs[ci] = zlib.crc32(col.validity().tobytes(),
                                              val_crcs[ci])
                    nbytes += len(raw)
            if inserted:
                rows = [inserted[h] for h in sorted(inserted)]
                store_kvs += len(rows)
                ftypes = store.ftypes()
                for ci in range(ncols):
                    tail = Column.from_values(
                        ftypes[ci], [r[ci] for r in rows])
                    raw = col_bytes(tail)
                    col_crcs[ci] = zlib.crc32(raw, col_crcs[ci])
                    val_crcs[ci] = zlib.crc32(tail.validity().tobytes(),
                                              val_crcs[ci])
                    nbytes += len(raw)
            # XOR across stores keeps the reference's partition/row-order
            # invariance; within a store the record crc is positional.  A
            # store whose VISIBLE row count is zero must contribute 0 (not
            # the crc of all-zero column records), or the checksum of
            # identical visible content would change with compaction state
            # (base rows all deleted vs. physically compacted away).
            kvs += store_kvs
            if store_kvs:
                crc ^= zlib.crc32(b"".join(
                    struct.pack("<III", ci, col_crcs[ci], val_crcs[ci])
                    for ci in range(ncols)))
        return crc, kvs, nbytes

    def _admin_repair_index(self, t: TableInfo, index_name: str,
                            kind: str) -> ResultSet:
        """ADMIN RECOVER INDEX / CLEANUP INDEX (util/admin.go:281-312):
        indexes here are DERIVED sorted artifacts, so both repairs
        re-derive the artifact from the base rows — RECOVER reports how
        many entries the rebuilt index carries (ADDED_COUNT/SCAN_COUNT),
        CLEANUP how many bogus entries the rebuild discarded."""
        ix = next((x for x in t.indexes
                   if x.name.lower() == index_name.lower()), None)
        if ix is None:
            raise PlanError(f"index {index_name!r} does not exist on "
                            f"{t.name}")
        added = scanned = removed = 0
        for pid in t.physical_ids():
            store = self.domain.storage.table(pid)
            offs = tuple(t.col_offsets(ix.columns))
            old = store.indexes.peek(offs)
            old_n = len(old.handles) if old is not None else None
            store.indexes.invalidate(offs)
            rebuilt = store.indexes.get(store, offs)  # re-derive from rows
            added += len(rebuilt.handles)
            scanned += store.base_rows
            if old_n is not None and old_n > len(rebuilt.handles):
                removed += old_n - len(rebuilt.handles)
        if kind == "recover_index":
            return ResultSet(["ADDED_COUNT", "SCAN_COUNT"],
                             [(added, scanned)], is_query=True)
        return ResultSet(["REMOVED_COUNT"], [(removed,)], is_query=True)

    def _admin_check_table(self, t: TableInfo):
        """ADMIN CHECK TABLE (executor/admin.go CheckTable role), adapted
        to derived indexes.  Two real checks per physical store:

        1. Every EXISTING sorted-index artifact (cached or backfilled)
           must agree with the CURRENT base rows — row counts match and a
           sampled handle-gather returns the index's key values.  Freshly
           derivable indexes are skipped: rebuilding one here and comparing
           it against its own source would be tautological.
        2. Unique constraints verify over the FULL visible table — base
           minus deletions plus committed delta — via the catalog's
           unique scanner (the same code the online-DDL recheck trusts).
        """
        from ..errors import ExecutorError

        cat = self.domain.catalog
        for pid in t.physical_ids():
            store = self.domain.storage.table(pid)
            for ix in t.indexes:
                if ix.state != STATE_PUBLIC:
                    continue
                offs = tuple(t.col_offsets(ix.columns))
                idx = store.indexes.peek(offs)
                if idx is not None and idx.base_version ==                         store.base_version:
                    self._check_index_artifact(t, store, ix, offs, idx)
                if ix.unique:
                    try:
                        cat._check_unique(t, list(ix.columns), ix.name,
                                          store_id=pid)
                    except KVError as e:
                        raise ExecutorError(
                            f"admin check table {t.name}: {e}")

    def _check_index_artifact(self, t, store, ix, offs, idx):
        """Sampled artifact-vs-base verification using sparse gathers."""
        from ..errors import ExecutorError

        n = store.base_rows
        expect = n
        if n:
            # non-NULL count per index columns from validity only
            chunk = store.base_chunk(list(offs), 0, n,
                                     decode_strings=False)
            valid = np.ones(n, dtype=np.bool_)
            for i in range(len(offs)):
                valid &= chunk.col(i).validity()
            expect = int(valid.sum())
        else:
            expect = 0
        if len(idx.handles) != expect:
            raise ExecutorError(
                f"admin check table {t.name}: index {ix.name!r} covers "
                f"{len(idx.handles)} rows, table has {expect} indexable "
                f"rows")
        hs = idx.handles
        if not len(hs):
            return
        if len(hs) > 65536:
            pick = np.linspace(0, len(hs) - 1, 4096, dtype=np.int64)
        else:
            pick = np.arange(len(hs), dtype=np.int64)
        got = store.gather_chunk(list(offs), hs[pick],
                                 decode_strings=False)
        for j in range(len(offs)):
            if not np.array_equal(np.asarray(idx.cols[j])[pick],
                                  got.col(j).data):
                raise ExecutorError(
                    f"admin check table {t.name}: index {ix.name!r} "
                    f"column {ix.columns[j]!r} disagrees with table data")

    # ------------------------------------------------------------------
    # DDL
    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    # LOCK TABLES (server-level table locks; MySQL semantics: a session
    # holding any table locks may only touch locked tables, writes need a
    # WRITE lock, foreign WRITE locks exclude everyone else)
    # ------------------------------------------------------------------
    _LOCK_EXEMPT_DBS = ("information_schema", "performance_schema",
                        "mysql")  # MySQL exempts these from LOCK TABLES

    def _run_resource_group(self, s) -> ResultSet:
        """CREATE/ALTER/DROP RESOURCE GROUP against the domain's
        resource-control plane (lifecycle/resgroup.py)."""
        reg = self.domain.resgroups
        try:
            if s.kind == "create":
                reg.create(s.name, ru_per_sec=s.ru_per_sec or 0,
                           burstable=bool(s.burstable),
                           query_limit_ms=s.query_limit_ms or 0,
                           priority=s.priority or 1,
                           if_not_exists=s.if_not_exists)
            elif s.kind == "alter":
                reg.alter(s.name, ru_per_sec=s.ru_per_sec,
                          burstable=s.burstable,
                          query_limit_ms=s.query_limit_ms,
                          priority=s.priority)
            else:
                reg.drop(s.name, if_exists=s.if_exists)
        except KeyError:
            raise ExecutorError(f"unknown resource group {s.name!r}")
        except ValueError as e:
            raise ExecutorError(str(e))
        # fleet replication: a registry attached to the
        # coord plane pushes the new definition set into the shared
        # store so every member's next resolve() adopts it
        reg.publish()
        return ResultSet()

    def _run_lock_tables(self, s) -> ResultSet:
        isc = self.domain.catalog.info_schema()
        wanted = []
        for tn, mode in s.items:
            db = (tn.db or self.current_db).lower()
            isc.table(db, tn.name)  # must exist
            wanted.append(((db, tn.name.lower()), mode))
        with self.domain._mu:
            locks = self.domain.table_locks
            for key, mode in wanted:
                h = locks.get(key)
                if h is None:
                    continue
                others = h["owners"] - {self.conn_id}
                if others and (mode == "write" or h["mode"] == "write"):
                    raise ExecutorError(
                        f"Table '{key[1]}' is locked by another session")
            # LOCK TABLES implicitly releases this session's prior locks
            self._release_table_locks_locked()
            for key, mode in wanted:
                h = locks.get(key)
                if h is None or not h["owners"]:
                    locks[key] = {"mode": mode, "owners": {self.conn_id}}
                else:  # shared read lock gains another owner
                    h["owners"].add(self.conn_id)
        return ResultSet()

    def _release_table_locks(self):
        with self.domain._mu:
            self._release_table_locks_locked()

    def _release_table_locks_locked(self):
        locks = self.domain.table_locks
        for key in list(locks):
            locks[key]["owners"].discard(self.conn_id)
            if not locks[key]["owners"]:
                del locks[key]

    def _check_table_locks(self, stmt):
        """MySQL LOCK TABLES enforcement at dispatch time."""
        if not self.domain.table_locks:
            return
        from .priv import _walk_tables

        refs: list = []
        _walk_tables(stmt, refs)
        if not refs:
            return
        writing = isinstance(stmt, (ast.InsertStmt, ast.UpdateStmt,
                                    ast.DeleteStmt, ast.LoadDataStmt))
        target = getattr(stmt, "table", None) if writing else None
        with self.domain._mu:
            locks = self.domain.table_locks
            mine = any(self.conn_id in v["owners"] for v in locks.values())
            for tn in refs:
                db = (tn.db or self.current_db).lower()
                if db in self._LOCK_EXEMPT_DBS:
                    continue
                key = (db, tn.name.lower())
                h = locks.get(key)
                if h is None:
                    if mine:
                        raise ExecutorError(
                            f"Table '{tn.name}' was not locked with "
                            f"LOCK TABLES")
                    continue
                if self.conn_id in h["owners"]:
                    if writing and tn is target and h["mode"] != "write":
                        raise ExecutorError(
                            f"Table '{tn.name}' was locked with a READ "
                            f"lock and can't be updated")
                    continue
                if h["mode"] == "write" or (writing and tn is target):
                    raise ExecutorError(
                        f"Table '{tn.name}' is locked by another session")

    def _check_ddl_table_lock(self, db: str, name: str):
        """DDL on a table another session holds locked is refused (MySQL:
        even a foreign READ lock blocks DROP/ALTER)."""
        key = ((db or self.current_db).lower(), name.lower())
        with self.domain._mu:
            h = self.domain.table_locks.get(key)
            if h is not None and h["owners"] - {self.conn_id}:
                raise ExecutorError(
                    f"Table '{name}' is locked by another session")

    def _run_ddl(self, s: ast.Stmt) -> ResultSet:
        cat = self.domain.catalog
        if isinstance(s, ast.CreateDatabaseStmt):
            cat.create_database(s.name, s.if_not_exists)
            return ResultSet()
        if isinstance(s, ast.DropDatabaseStmt):
            cat.drop_database(s.name, s.if_exists)
            if self.current_db.lower() == s.name.lower():
                self.current_db = ""
            return ResultSet()
        if isinstance(s, ast.CreateTableStmt):
            info = self._table_info_from_ast(s)
            cat.create_table(s.table.db or self.current_db, info,
                             s.if_not_exists)
            return ResultSet()
        if isinstance(s, ast.DropTableStmt):
            for tn in s.tables:
                cat.drop_table(tn.db or self.current_db, tn.name,
                               s.if_exists, view_only=s.is_view)
            return ResultSet()
        if isinstance(s, ast.TruncateTableStmt):
            cat.truncate_table(s.table.db or self.current_db, s.table.name)
            return ResultSet()
        if isinstance(s, ast.RecoverTableStmt):
            cat.recover_table(s.table.db or self.current_db, s.table.name)
            return ResultSet()
        if isinstance(s, ast.DropStatsStmt):
            t = cat.info_schema().table(s.table.db or self.current_db,
                                        s.table.name)
            for pid in t.physical_ids() + [t.id]:
                self.domain.stats.drop(pid)
            return ResultSet()
        if isinstance(s, ast.RepairTableStmt):
            # re-derive every index artifact from the row data, then run
            # the full integrity check (util/admin.go RepairTable role
            # over derived indexes)
            t = cat.info_schema().table(s.table.db or self.current_db,
                                        s.table.name)
            for ix in t.indexes:
                self._admin_repair_index(t, ix.name, "recover_index")
            self._admin_check_table(t)
            return ResultSet()
        if isinstance(s, ast.RenameTableStmt):
            cat.rename_table(s.old.db or self.current_db, s.old.name,
                             s.new.name)
            return ResultSet()
        if isinstance(s, ast.CreateIndexStmt):
            cat.create_index(s.table.db or self.current_db, s.table.name,
                             s.index_name, s.columns, s.unique)
            return ResultSet()
        if isinstance(s, ast.DropIndexStmt):
            cat.drop_index(s.table.db or self.current_db, s.table.name,
                           s.index_name)
            return ResultSet()
        if isinstance(s, ast.CreateViewStmt):
            db = s.name.db or self.current_db
            if s.or_replace and cat.info_schema().has_table(db, s.name.name):
                cat.drop_table(db, s.name.name, view_only=True)
            info = TableInfo(0, s.name.name, [], is_view=True)
            info.view_select = s.query  # parsed AST (see build_from)
            cat.create_table(db, info)
            return ResultSet()
        if isinstance(s, ast.AlterTableStmt):
            return self._run_alter(s)
        raise PlanError(f"statement {type(s).__name__} not supported")

    def _run_alter(self, s: ast.AlterTableStmt) -> ResultSet:
        cat = self.domain.catalog
        db = s.table.db or self.current_db
        if s.action == "add_column":
            cat.add_column(db, s.table.name, self._column_info(s.column))
            return ResultSet()
        if s.action == "drop_column":
            cat.drop_column(db, s.table.name, s.name)
            return ResultSet()
        if s.action == "modify_column":
            cat.modify_column(db, s.table.name, self._column_info(s.column))
            return ResultSet()
        if s.action == "add_index":
            ix = s.index
            cat.create_index(db, s.table.name, ix.name, ix.columns,
                             ix.unique, ix.primary)
            return ResultSet()
        if s.action == "drop_index":
            cat.drop_index(db, s.table.name, s.name)
            return ResultSet()
        if s.action == "rename":
            cat.rename_table(db, s.table.name, s.name)
            return ResultSet()
        if s.action in ("add_partition", "drop_partition",
                        "truncate_partition", "coalesce_partition"):
            return self._run_partition_ddl(cat, db, s)
        if s.action == "change_column":
            cat.change_column(db, s.table.name, s.name,
                              self._column_info(s.column))
            return ResultSet()
        if s.action == "rename_index":
            cat.rename_index(db, s.table.name, s.names[0], s.names[1])
            return ResultSet()
        if s.action == "auto_increment":
            cat.rebase_auto_increment(db, s.table.name, s.number)
            return ResultSet()
        if s.action == "comment":
            cat.set_table_comment(db, s.table.name, s.name)
            return ResultSet()
        if s.action == "add_fk":
            fk = s.fk
            cat.add_foreign_key(
                db, s.table.name, fk.name, fk.columns,
                fk.ref_table.db or db, fk.ref_table.name, fk.ref_columns)
            return ResultSet()
        if s.action == "drop_fk":
            cat.drop_foreign_key(db, s.table.name, s.name)
            return ResultSet()
        raise PlanError(f"ALTER {s.action} not supported")

    def _run_partition_ddl(self, cat, db: str, s: ast.AlterTableStmt):
        """ALTER TABLE ... ADD/DROP/TRUNCATE/COALESCE PARTITION with
        per-partition stats invalidation (ddl_api.go:2187-2316 analog)."""
        name = s.table.name
        before = {pd.id for pd in
                  (cat.info_schema().table(db, name).partition_info.defs
                   if cat.info_schema().table(db, name).partition_info
                   else [])}
        if s.action == "add_partition":
            cat.add_partition(db, name,
                              [(d.name, d.less_than) for d in s.part_defs],
                              add_buckets=s.number)
        elif s.action == "drop_partition":
            cat.drop_partition(db, name, s.names)
        elif s.action == "truncate_partition":
            cat.truncate_partition(db, name, s.names)
        else:
            cat.coalesce_partition(db, name, s.number)
        # stats: removed/replaced partitions invalidate via the catalog's
        # drop hook; the logical merged row count is stale either way, so
        # drop it and let auto-analyze / the next ANALYZE rebuild
        t = cat.info_schema().table(db, name)
        after = {pd.id for pd in t.partition_info.defs}
        if after != before:
            self.domain.stats.drop(t.id)
        return ResultSet()

    def _column_info(self, cd: ast.ColumnDef) -> ColumnInfo:
        tn = cd.type_name.lower()
        if tn == "enum":
            if not cd.elems:
                raise PlanError("ENUM requires at least one member")
            ft = ty_enum(cd.elems)
        elif tn == "set":
            if len(cd.elems) > 64:
                raise PlanError("SET supports at most 64 members")
            ft = ty_set(cd.elems)
        else:
            mk = _TYPE_MAP.get(tn)
            if mk is None:
                raise PlanError(f"unknown column type {cd.type_name!r}")
            ft = mk(cd.precision, cd.scale)
        from ..types import MAX_DECIMAL_PRECISION

        if ft.kind == TypeKind.DECIMAL and (
                ft.precision > MAX_DECIMAL_PRECISION
                or ft.scale > 30 or ft.scale > ft.precision):
            raise PlanError(
                f"invalid DECIMAL({ft.precision},{ft.scale})")
        if cd.not_null or cd.primary_key:
            ft = ft.not_null()
        default = None
        has_default = False
        if cd.default is not None:
            from ..planner.build import _eval_const
            from ..planner.columns import Schema
            from ..planner.expr_build import ExprBuilder

            eb = ExprBuilder(Schema([]), None, None, [], None)
            default = _eval_const(eb.build(cd.default))
            has_default = True
        return ColumnInfo(cd.name, ft, 0, default, has_default,
                          cd.auto_increment, cd.primary_key)

    def _table_info_from_ast(self, s: ast.CreateTableStmt) -> TableInfo:
        cols = [self._column_info(c) for c in s.columns]
        info = TableInfo(0, s.table.name, cols)
        idx_id = 1
        for c in cols:
            if c.primary_key:
                info.indexes.append(
                    IndexInfo(idx_id, "PRIMARY", [c.name], True, True)
                )
                idx_id += 1
            # UNIQUE column constraint
        for i, cd in enumerate(s.columns):
            if cd.unique and not cd.primary_key:
                info.indexes.append(
                    IndexInfo(idx_id, f"uniq_{cd.name}", [cd.name], True)
                )
                idx_id += 1
        for ix in s.indexes:
            info.indexes.append(
                IndexInfo(idx_id, ix.name or f"idx_{idx_id}",
                          ix.columns, ix.unique, ix.primary)
            )
            idx_id += 1
        if s.partition_by is not None:
            info.partition_info = self._partition_info(s.partition_by, info)
        seen_fk = set()
        for fk in s.foreign_keys:
            # same validation as ALTER ... ADD FOREIGN KEY
            # (catalog.add_foreign_key): referenced table + columns must
            # exist, names unique, column counts equal
            ref_db = (fk.ref_table.db or self.current_db).lower()
            for c in fk.columns:
                if info.find_column(c) is None:
                    raise PlanError(f"FK column {c!r} does not exist")
            rt = self.domain.catalog.info_schema().table(
                ref_db, fk.ref_table.name)
            for c in fk.ref_columns:
                if rt.find_column(c) is None:
                    raise PlanError(
                        f"FK referenced column {c!r} does not exist in "
                        f"{fk.ref_table.name}")
            if len(fk.columns) != len(fk.ref_columns):
                raise PlanError("FK column count mismatch")
            if fk.name.lower() in seen_fk:
                raise PlanError(f"duplicate foreign key name {fk.name!r}")
            seen_fk.add(fk.name.lower())
            info.foreign_keys.append({
                "name": fk.name, "columns": list(fk.columns),
                "ref_db": ref_db,
                "ref_table": fk.ref_table.name.lower(),
                "ref_columns": list(fk.ref_columns),
            })
        return info

    def _partition_info(self, pb, info: TableInfo):
        """Validate + build PartitionInfo (ddl_api.go buildTablePartitionInfo
        + checkPartitionKeysConstraint analogs)."""
        from ..catalog.schema import PartitionDef, PartitionInfo

        col = info.find_column(pb.column)
        if col is None:
            raise PlanError(f"unknown partition column {pb.column!r}")
        if col.ftype.kind not in (TypeKind.INT, TypeKind.UINT, TypeKind.BOOL,
                                  TypeKind.DATE, TypeKind.DATETIME):
            raise PlanError(
                f"partition column {pb.column!r} must be integer-valued")
        # MySQL 1503: every unique key must use the partitioning column,
        # so uniqueness stays partition-local (no cross-shard checks)
        for ix in info.indexes:
            if (ix.unique or ix.primary) and \
                    pb.column.lower() not in [c.lower() for c in ix.columns]:
                raise PlanError(
                    f"a {'PRIMARY KEY' if ix.primary else 'UNIQUE INDEX'} "
                    f"must include all columns in the table's partitioning "
                    f"function")
        if pb.kind == "hash":
            defs = [PartitionDef(0, f"p{i}") for i in range(pb.num)]
            return PartitionInfo("hash", col.name, defs)
        # RANGE: bounds must be strictly increasing; MAXVALUE only last
        defs, prev = [], None
        seen = set()
        for i, pd in enumerate(pb.defs):
            if pd.name.lower() in seen:
                raise PlanError(f"duplicate partition name {pd.name!r}")
            seen.add(pd.name.lower())
            if pd.less_than is None:
                if i != len(pb.defs) - 1:
                    raise PlanError(
                        "MAXVALUE can only be used in the last partition")
            else:
                if prev is not None and pd.less_than <= prev:
                    raise PlanError(
                        "VALUES LESS THAN must be strictly increasing")
                prev = pd.less_than
            defs.append(PartitionDef(0, pd.name, pd.less_than))
        return PartitionInfo("range", col.name, defs)


# ---------------------------------------------------------------------------


def _format_row(row: tuple, fts: List[FieldType]) -> tuple:
    out = []
    for v, ft in zip(row, fts):
        if v is None:
            out.append(None)
        elif ft.kind == TypeKind.DECIMAL:
            iv = int(v)
            if abs(iv) <= (1 << 53):
                # exactly float-representable: keep the numeric result shape
                out.append(iv / (10 ** ft.scale) if ft.scale else iv)
            else:
                # past 2^53 a float silently drops digits — exact string
                out.append(format_decimal(iv, ft.scale))
        elif ft.kind == TypeKind.DATE:
            out.append(format_date(v))
        elif ft.kind == TypeKind.DATETIME:
            out.append(format_datetime(v))
        elif ft.kind == TypeKind.TIME:
            out.append(format_time(int(v)))
        elif ft.kind == TypeKind.ENUM:
            i = int(v)
            out.append(ft.elems[i - 1] if 1 <= i <= len(ft.elems) else "")
        elif ft.kind == TypeKind.SET:
            i = int(v)
            out.append(",".join(e for j, e in enumerate(ft.elems)
                                if i >> j & 1))
        elif ft.kind == TypeKind.JSON:
            out.append(str(v))
        elif isinstance(v, np.generic):
            out.append(v.item())
        else:
            out.append(v)
    return tuple(out)


def run_over_spans(sess, phys, spans) -> Tuple[List[tuple], List[str]]:
    """Run a planned statement (`phys`, e.g. `sess.last_plan`) with its
    one table reader over the disjoint handle `spans` [lo, hi), and
    return its rows and the engines its readers report.

    No SQL predicate makes a multi-range request on an unpartitioned
    table (the planner derives ranges from partitions only), so this is
    how a request with more ranges than the fused program's range slots
    is driven.  `collect_all` and the row format come from the
    module of `sess`'s own class, so a session of a package laid out as
    this one is runs it as well."""
    mod = sys.modules[type(sess).__module__]
    stack, readers = [phys], []
    while stack:
        p = stack.pop()
        if type(p).__name__ == "PhysTableReader":
            readers.append(p)
        stack.extend(p.children)
    (reader,) = readers
    saved = reader.ranges
    tid = reader.dag.scan.table_id
    reader.ranges = [replace(saved[0], table_id=tid, start=lo, end=hi)
                     for lo, hi in spans]
    try:
        ctx = sess._exec_ctx()
        chunks = mod.collect_all(phys.build(ctx))
    finally:
        reader.ranges = saved
    fts = phys.schema.ftypes()
    rows = [mod._format_row(r, fts) for c in chunks for r in c.to_pylist()]
    return rows, [st.engine for st in ctx.stats.values()
                  if getattr(st, "engine", None)]


def _plan_id_of(name: str) -> int:
    try:
        return int(name.rsplit("_", 1)[1])
    except (IndexError, ValueError):
        return -1


def _show_create(t: TableInfo) -> str:
    lines = []
    for c in t.public_columns():
        s = f"  `{c.name}` {c.ftype.sql_name().lower()}"
        if not c.ftype.nullable:
            s += " NOT NULL"
        if c.has_default:
            s += f" DEFAULT {c.default!r}"
        if c.auto_increment:
            s += " AUTO_INCREMENT"
        lines.append(s)
    for ix in t.indexes:
        if ix.primary:
            lines.append(f"  PRIMARY KEY (`{'`,`'.join(ix.columns)}`)")
        elif ix.unique:
            lines.append(
                f"  UNIQUE KEY `{ix.name}` (`{'`,`'.join(ix.columns)}`)"
            )
        else:
            lines.append(f"  KEY `{ix.name}` (`{'`,`'.join(ix.columns)}`)")
    for fk in t.foreign_keys:
        lines.append(
            f"  CONSTRAINT `{fk['name']}` FOREIGN KEY "
            f"(`{'`,`'.join(fk['columns'])}`) REFERENCES "
            f"`{fk['ref_table']}` (`{'`,`'.join(fk['ref_columns'])}`)")
    body = ",\n".join(lines)
    out = f"CREATE TABLE `{t.name}` (\n{body}\n)"
    pi = t.partition_info
    if pi is not None:
        if pi.kind == "hash":
            out += (f"\nPARTITION BY HASH (`{pi.column}`) "
                    f"PARTITIONS {len(pi.defs)}")
        else:
            parts = ", ".join(
                f"PARTITION `{p.name}` VALUES LESS THAN "
                + ("MAXVALUE" if p.less_than is None else f"({p.less_than})")
                for p in pi.defs)
            out += f"\nPARTITION BY RANGE (`{pi.column}`) ({parts})"
    return out


def _layout_epoch() -> int:
    """Layout-decision generation for plan-cache keys (import kept out of
    the module prologue: sessions exist in jax-free embedders)."""
    try:
        from ..layout import layout_epoch

        return layout_epoch()
    except Exception:
        return 0

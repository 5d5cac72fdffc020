"""MySQL-wire server: asyncio listener bridging connections to sessions.

Reference: server/server.go (Server, connection loop), server/conn.go:800
(clientConn.dispatch), conn_stmt.go (prepared-statement commands).  SQL
execution itself runs in a thread pool (sessions are synchronous; numpy/torch
release the GIL), so one slow query doesn't stall other connections —
the goroutine-per-conn model mapped onto asyncio + executor threads.

Admission control & graceful drain (server.go onConn/kickIdleConnection +
tidb-server SIGTERM handling):

- a hard connection cap: past `max_connections` the client gets a fast
  ERR 1040 instead of a handshake (MySQL's Too many connections);
- a bounded executor queue: statements past the worker pool's capacity
  wait in a bounded admission queue with a queue deadline; past the bound
  (or the deadline) the statement is REJECTED with a MySQL error instead
  of queueing unboundedly — overload sheds load at the front door;
- graceful drain: shutdown()/SIGTERM stops the listener, lets in-flight
  statements run to their own deadlines within the drain budget, then
  cancels survivors through their QueryScope (reason 'shutdown') and
  closes connections cleanly.
"""

from __future__ import annotations

import asyncio
import os
import struct
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

from ..errors import TiDBTPUError
from ..metrics import REGISTRY
from ..session import Domain, ResultSet
from . import protocol as P
from .packet import PacketReader, PacketWriter, read_lenenc_int

COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_CLOSE = 0x19
COM_STMT_RESET = 0x1A


class MySQLServer:
    def __init__(self, domain: Optional[Domain] = None, host: str = "127.0.0.1",
                 port: int = 4000, workers: int = 8,
                 max_connections: int = 512,
                 max_queued: Optional[int] = None,
                 queue_deadline_s: float = 10.0):
        self.domain = domain or Domain()
        self.host = host
        self.port = port
        self.workers = workers
        self.pool = ThreadPoolExecutor(max_workers=workers)
        self._server: Optional[asyncio.AbstractServer] = None
        # ---- admission bounds (server.go Server.rwlock + clients map) --
        self.max_connections = max_connections
        # waiters allowed behind the busy worker pool; past this the
        # statement fast-rejects instead of queueing unboundedly
        self.max_queued = workers * 4 if max_queued is None else max_queued
        self.queue_deadline_s = queue_deadline_s
        self._admission: Optional[asyncio.Semaphore] = None  # loop-bound
        self._queued = 0
        self._nconns = 0
        self._draining = False
        # live connections: asyncio task -> (session, writer); drain
        # cancels scopes and closes writers through this registry
        self._conns: Dict[object, tuple] = {}
        # periodic eager session checkpointing (lifecycle follow-up (d)):
        # started with the server when tidb_tpu_handoff_checkpoint_s > 0
        self._checkpoint_task: Optional[asyncio.Task] = None
        # True while the plane holds a checkpoint THIS server parked: an
        # empty collection then CLEARS the parked bundle instead of
        # leaving a stale one for the next restart to resurrect
        self._checkpointed = False

    async def start(self):
        self._admission = asyncio.Semaphore(self.workers)
        self._draining = False
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        addr = self._server.sockets[0].getsockname()
        self.port = addr[1]
        # rolling-restart handoff (coord plane): adopt any session state
        # a draining predecessor parked — prepared statements + session
        # sysvars replay into fresh sessions at THIS process's epoch
        try:
            from ..coord import get_plane
            from ..lifecycle import replay_session_states

            states = get_plane().take_handoff()
            if states:
                replay_session_states(self.domain, states)
        except Exception:
            REGISTRY.inc("coord_handoff_failed_total")
        # periodic eager checkpointing: a HARD-killed process (no drain)
        # loses at most one interval's worth of prepared-session churn,
        # because the plane already holds a recent handoff bundle the
        # replacement replays.  The sysvar is re-read every tick, so
        # SET GLOBAL tidb_tpu_handoff_checkpoint_s enables/disables the
        # policy on a live server.
        self._checkpoint_task = asyncio.create_task(
            self._checkpoint_loop())
        return addr

    def _checkpoint_interval_s(self) -> float:
        from ..session.vars import SessionVars

        return float(SessionVars(self.domain.global_vars).get_int(
            "tidb_tpu_handoff_checkpoint_s", 0))

    async def _checkpoint_loop(self):
        from ..coord import get_plane
        from ..lifecycle import collect_session_states

        while not self._draining:
            iv = self._checkpoint_interval_s()
            await asyncio.sleep(iv if iv > 0 else 1.0)
            if iv <= 0 or self._draining:
                continue
            try:
                states = collect_session_states(self.domain)
                if states:
                    get_plane().handoff_put(states)
                    self._checkpointed = True
                    REGISTRY.inc("coord_handoff_checkpoint_total")
                elif self._checkpointed:
                    # every prepared session is gone: clear the parked
                    # bundle, or a later restart would replay ghost
                    # sessions no client owns
                    get_plane().take_handoff()
                    self._checkpointed = False
            except asyncio.CancelledError:
                raise
            except Exception:
                # a dead coordinator must never take the server down;
                # the drain-time handoff still gets its own attempt
                REGISTRY.inc("coord_handoff_failed_total")

    async def stop(self):
        """Immediate stop: drain with a zero budget (in-flight statements
        are cancelled right away with reason 'shutdown')."""
        await self.shutdown(drain_s=0.0)

    async def shutdown(self, drain_s: float = 15.0):
        """Graceful drain (tidb-server SIGTERM: gracefulShutdown):
        1. stop accepting — the listener closes, new connects fail fast;
        2. in-flight statements keep running up to `drain_s` (each still
           bounded by its own max_execution_time deadline);
        3. survivors are cancelled through their QueryScope with reason
           'shutdown' (ERR 1053 to the client at the next host seam);
        4. connections close, the listener's wait_closed() returns and
           the worker pool shuts down.

        Step 1 only closes the listener: since Python 3.12.1
        `asyncio.Server.wait_closed()` also waits for every open
        connection, so it is awaited after step 4 has closed them."""
        self._draining = True
        if self._checkpoint_task is not None:
            self._checkpoint_task.cancel()
            self._checkpoint_task = None
        listener, self._server = self._server, None
        if listener is not None:
            listener.close()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + max(drain_s, 0.0)
        while loop.time() < deadline:
            busy = [s for _t, (s, _w) in list(self._conns.items())
                    if getattr(s, "stmt_start", None) is not None]
            if not busy:
                break
            await asyncio.sleep(0.02)
        # cancel survivors: the scope wakes backoff sleeps, fan-out
        # workers and SLEEP()s; the statement errors at its next seam.
        # The sweep REPEATS while waiting for statements to unwind — a
        # statement that raced past the draining checks into execution
        # is cancelled on the next pass instead of surviving the drain.
        cancelled = 0
        unwind_deadline = loop.time() + 5.0
        while True:
            busy = [s for _t, (s, _w) in list(self._conns.items())
                    if getattr(s, "stmt_start", None) is not None]
            for sess in busy:
                sc = getattr(sess, "_scope", None)
                if sc is None or not sc.cancelled():
                    cancelled += 1
                sess.cancel_query("shutdown")
            if not busy or loop.time() >= unwind_deadline:
                break
            await asyncio.sleep(0.02)
        if cancelled:
            REGISTRY.inc("server_drain_cancelled_total", cancelled)
            await asyncio.sleep(0.05)  # flush the ERR 1053 writes
        # session-state handoff (rolling restart, coord plane): park
        # every prepared session on the coordinator BEFORE connections
        # close, so the replacement process replays them when it rejoins
        # at a new epoch.  A failed put (chaos site coord/handoff, dead
        # coordinator) must never block the drain — the sessions are
        # lost, counted, and the shutdown completes.
        try:
            from ..coord import get_plane
            from ..lifecycle import collect_session_states

            states = collect_session_states(self.domain)
            if states:
                get_plane().handoff_put(states)
            elif self._checkpointed:
                # a periodic checkpoint parked sessions that have since
                # gone away: drain-time truth is "nothing to hand off"
                get_plane().take_handoff()
            self._checkpointed = False
        except Exception:
            REGISTRY.inc("coord_handoff_failed_total")
        try:
            # graceful departure is independent of handoff success: the
            # epoch must bump NOW (not at lease expiry) so survivors
            # rebuild immediately even when the handoff was lost
            from ..coord import get_plane

            get_plane().leave()
        except Exception:
            REGISTRY.inc("coord_rpc_errors_total")
        # unblock connection loops parked in pr.recv() and wait for the
        # handlers to unwind (they run their own session cleanup)
        for _t, (_s, writer) in list(self._conns.items()):
            try:
                writer.close()
            except Exception:
                pass
        tasks = list(self._conns)
        if tasks:
            await asyncio.wait(tasks, timeout=5.0)
        if listener is not None:
            # bounded like the handler wait: a connection whose handler
            # did not unwind must not hold the drain open
            try:
                await asyncio.wait_for(listener.wait_closed(), timeout=5.0)
            except asyncio.TimeoutError:
                pass
        self.pool.shutdown(wait=False)

    # ------------------------------------------------------------------
    async def _handle(self, reader, writer):
        pw0 = PacketWriter(writer)
        if self._draining:
            # reject-at-accept during drain (a connect can race the
            # listener close): MySQL's shutdown-in-progress error
            await pw0.send(P.err_packet(
                1053, "Server shutdown in progress", "08S01"))
            writer.close()
            return
        if self._nconns >= self.max_connections:
            # hard cap (MySQL max_connections): ERR instead of handshake,
            # so overload costs the client one round trip, not a stall
            REGISTRY.inc("server_connections_rejected_total")
            await pw0.send(P.err_packet(
                1040, "Too many connections", "08004"))
            writer.close()
            return
        self._nconns += 1
        task = asyncio.current_task()
        sess = None
        try:
            sess = self.domain.new_session()
            self._conns[task] = (sess, writer)
            pr, pw = PacketReader(reader), pw0
            loop = asyncio.get_running_loop()
            prepared: Dict[int, str] = {}
            next_stmt_id = [1]
            salt = os.urandom(20)
            await pw.send(P.handshake_v10(sess.conn_id, salt))
            resp = await pr.recv()
            hs = P.parse_handshake_response(resp)
            pw.seq = pr.seq
            # mysql_native_password verification against the grant tables
            # (server/conn.go openSessionAndDoAuth analog); the client's
            # address picks the most specific user@host account
            peer = writer.get_extra_info("peername")
            client_host = peer[0] if peer else "localhost"
            account = self.domain.priv.auth(hs["user"], hs["auth"], salt,
                                            host=client_host)
            if account is None:
                await pw.send(P.err_packet(
                    1045,
                    f"Access denied for user '{hs['user']}'"
                    f"@'{client_host}'",
                    "28000"))
                return
            sess.user = account
            # default roles activate at login (MySQL activate_all_roles
            # off: only the DEFAULT set)
            sess.active_roles = sorted(
                self.domain.priv.default_roles(account))
            if hs["db"]:
                try:
                    sess.execute(f"use {hs['db']}")
                except TiDBTPUError:
                    pass
            await pw.send(P.ok_packet())

            while True:
                pr.seq = 0
                # socket wait measured at the asyncio level: it becomes
                # the statement's wire.read span, so traces distinguish
                # network/client wait from admission-queue wait
                t_recv = _time.perf_counter_ns()
                data = await pr.recv()
                recv_wait_ns = _time.perf_counter_ns() - t_recv
                if not data:
                    break
                pw.seq = pr.seq
                cmd, payload = data[0], data[1:]
                if cmd == COM_QUIT:
                    break
                if cmd == COM_PING:
                    await pw.send(P.ok_packet())
                    continue
                if cmd == COM_INIT_DB:
                    await self._run_sql(
                        sess, f"use {payload.decode()}", pw, loop,
                        recv_wait_ns=recv_wait_ns,
                    )
                    continue
                if cmd == COM_QUERY:
                    sql = payload.decode("utf8", "replace")
                    await self._run_sql(sess, sql, pw, loop,
                                        recv_wait_ns=recv_wait_ns)
                    continue
                if cmd == COM_FIELD_LIST:
                    await pw.send(P.eof_packet())
                    continue
                if cmd == COM_STMT_PREPARE:
                    sql = payload.decode("utf8", "replace")
                    sid = next_stmt_id[0]
                    next_stmt_id[0] += 1
                    n_params = _count_params(sql)
                    prepared[sid] = {"sql": sql, "n": n_params,
                                     "types": None}
                    out = (b"\x00" + struct.pack("<I", sid)
                           + struct.pack("<H", 0)          # columns
                           + struct.pack("<H", n_params)
                           + b"\x00" + struct.pack("<H", 0))
                    await pw.send(out)
                    for _ in range(n_params):
                        await pw.send(P.column_def("?", None))
                    if n_params:
                        await pw.send(P.eof_packet())
                    continue
                if cmd == COM_STMT_EXECUTE:
                    sid = struct.unpack_from("<I", payload, 0)[0]
                    st = prepared.get(sid)
                    if st is None:
                        await pw.send(P.err_packet(1243, "unknown stmt"))
                        continue
                    params, st["types"] = _parse_exec_params(
                        payload, st["n"], st["types"]
                    )
                    await self._run_sql(sess, st["sql"], pw, loop,
                                        params=params, binary=True,
                                        recv_wait_ns=recv_wait_ns)
                    continue
                if cmd in (COM_STMT_CLOSE, COM_STMT_RESET):
                    sid = struct.unpack_from("<I", payload, 0)[0]
                    prepared.pop(sid, None)
                    if cmd == COM_STMT_RESET:
                        await pw.send(P.ok_packet())
                    continue
                await pw.send(P.err_packet(1047, f"unknown command {cmd}"))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            self._conns.pop(task, None)
            self._nconns -= 1
            if sess is not None:
                sess.close()  # unpin snapshots + rollback
                sess._release_table_locks()  # MySQL frees on disconnect
                self.domain.sessions.pop(sess.conn_id, None)
            writer.close()

    async def _run_sql(self, sess, sql: str, pw: PacketWriter, loop,
                       params=None, binary: bool = False,
                       recv_wait_ns: int = 0):
        # ---- bounded admission (the overload front door) --------------
        # the worker pool admits `workers` statements; up to max_queued
        # more wait (bounded by queue_deadline_s); anything past that is
        # REJECTED NOW — under overload the queue must not grow without
        # bound, and a fast error beats a stuck client
        if self._draining:
            # statements arriving after drain started are refused (the
            # survivor-cancel sweep must not race freshly admitted work)
            await self._reject_shutdown(pw, sql)
            return
        sem = self._admission
        wait_ns = 0
        if sem is not None:
            if sem.locked() and self._queued >= self.max_queued:
                await self._reject_overload(pw, sql, "admission queue full")
                return
            t0 = _time.perf_counter_ns()
            self._queued += 1
            # live queue-depth gauge: the serving layer's ADAPTIVE
            # micro-batch window reads this to widen under pressure
            # (queued statements = batching opportunity) and shrink
            # back when the queue drains
            REGISTRY.set("admission_queue_depth", float(self._queued))
            try:
                await asyncio.wait_for(sem.acquire(),
                                       timeout=self.queue_deadline_s)
            except asyncio.TimeoutError:
                await self._reject_overload(
                    pw, sql, "admission queue deadline exceeded "
                             f"({self.queue_deadline_s:.1f}s)")
                return
            finally:
                self._queued -= 1
                REGISTRY.set("admission_queue_depth", float(self._queued))
            wait_ns = _time.perf_counter_ns() - t0
            REGISTRY.observe("admission_wait_ms", wait_ns / 1e6)
        try:
            if self._draining:
                # drain began while this statement waited in the queue
                await self._reject_shutdown(pw, sql)
                return
            await self._run_sql_admitted(sess, sql, pw, loop, params,
                                         binary, recv_wait_ns, wait_ns)
        finally:
            if sem is not None:
                sem.release()

    async def _reject_overload(self, pw: PacketWriter, sql: str, what: str):
        """Fast overload rejection: one source of truth for the error
        (ServerOverloadedError), the metrics and the termination record."""
        from ..errors import ServerOverloadedError

        err = ServerOverloadedError(what)
        REGISTRY.inc("admission_rejected_total")
        REGISTRY.inc("stmt_terminated_overload_total")
        self.domain.record_termination(sql, "overload")
        await pw.send(P.err_packet(err.code, str(err), "08004"))

    async def _reject_shutdown(self, pw: PacketWriter, sql: str):
        """Refuse a statement arriving mid-drain: same metric + summary
        accounting as every other termination reason."""
        from ..errors import ServerShutdownError

        err = ServerShutdownError()
        REGISTRY.inc("stmt_terminated_shutdown_total")
        self.domain.record_termination(sql, "shutdown")
        await pw.send(P.err_packet(err.code, str(err), "08S01"))

    async def _run_sql_admitted(self, sess, sql: str, pw: PacketWriter,
                                loop, params, binary: bool,
                                recv_wait_ns: int, admission_wait_ns: int):
        # wire.read attribution: the statement's trace root records how
        # many bytes the COM_QUERY/COM_STMT_EXECUTE payload carried and
        # how long the server waited on the socket for it (an asyncio-
        # level wire.read span, distinct from admission-queue wait)
        sess._pending_wire_read = (
            len(sql.encode("utf8", "replace")), recv_wait_ns)
        sess._pending_admission_wait_ns = admission_wait_ns
        try:
            rss = await loop.run_in_executor(
                self.pool, lambda: sess.execute(sql, params)
            )
        except TiDBTPUError as e:
            # typed errors carry their MySQL code (errors.py hierarchy)
            await pw.send(P.err_packet(getattr(e, "code", 1105), str(e)))
            return
        except Exception as e:  # pragma: no cover - defensive
            await pw.send(P.err_packet(1105, f"internal error: {e}"))
            return
        rs = rss[-1] if rss else ResultSet()
        if not rs.is_query:
            await pw.send(P.ok_packet(rs.affected_rows, rs.last_insert_id,
                                      warnings=len(rs.warnings)))
            return
        t0 = _time.perf_counter_ns()
        nbytes = 0
        fts = rs.ftypes
        await pw.send(bytes([len(rs.headers)]))
        for i, h in enumerate(rs.headers):
            await pw.send(P.column_def(
                h, fts[i] if fts and i < len(fts) else None
            ))
        await pw.send(P.eof_packet())
        encode = (lambda r: P.binary_row(r, fts)) if binary else P.text_row
        for row in rs.rows:
            pkt = encode(row)
            nbytes += len(pkt)
            await pw.send(pkt)
        await pw.send(P.eof_packet())
        tr = getattr(sess, "last_trace", None)
        if tr is not None and tr.finished and tr.sql == sql:
            # result encode+write time, appended onto the finished trace
            # (the statement ended before its rows hit the socket)
            tr.add_span("wire.write", _time.perf_counter_ns() - t0,
                        bytes=nbytes, rows=len(rs.rows))


def _count_params(sql: str) -> int:
    """Placeholder count via the real parser (a raw '?' scan miscounts
    question marks inside string literals); falls back to the scan only
    when the statement does not parse at PREPARE time."""
    try:
        from ..parser.parser import Parser

        p = Parser(sql)
        p.parse_statements()
        return p.n_params
    except Exception:
        return sql.count("?")


def _parse_exec_params(payload: bytes, n_params: int, cached_types):
    """COM_STMT_EXECUTE payload -> (values, types).  Types arrive only on
    the first execute (new_params_bound_flag=1); later executes reuse the
    cached ones per protocol."""
    if n_params == 0:
        return [], cached_types
    pos = 4 + 1 + 4  # stmt_id, flags, iteration count (cmd byte stripped)
    null_bytes = (n_params + 7) // 8
    null_bitmap = payload[pos:pos + null_bytes]
    pos += null_bytes
    new_bound = payload[pos]
    pos += 1
    types = []
    if new_bound:
        for _ in range(n_params):
            types.append((payload[pos], payload[pos + 1]))
            pos += 2
    elif cached_types:
        types = cached_types
    values = []
    for i in range(n_params):
        if null_bitmap[i // 8] & (1 << (i % 8)):
            values.append(None)
            continue
        t = types[i][0] if types else 0xFD
        if t in (0x01,):  # tiny
            values.append(struct.unpack_from("<b", payload, pos)[0])
            pos += 1
        elif t in (0x02,):  # short
            values.append(struct.unpack_from("<h", payload, pos)[0])
            pos += 2
        elif t in (0x03,):  # long
            values.append(struct.unpack_from("<i", payload, pos)[0])
            pos += 4
        elif t in (0x08,):  # longlong
            values.append(struct.unpack_from("<q", payload, pos)[0])
            pos += 8
        elif t in (0x04,):  # float
            values.append(struct.unpack_from("<f", payload, pos)[0])
            pos += 4
        elif t in (0x05,):  # double
            values.append(struct.unpack_from("<d", payload, pos)[0])
            pos += 8
        else:  # string-ish
            n, pos = read_lenenc_int(payload, pos)
            values.append(payload[pos:pos + n].decode("utf8", "replace"))
            pos += n
    return values, types


def serve_forever(host: str = "127.0.0.1", port: int = 4000,
                  domain: Optional[Domain] = None,
                  drain_s: float = 15.0):
    """Blocking entry point (tidb-server/main.go analog).

    Shutdown-aware: SIGTERM/SIGINT resolve a future instead of the old
    `while True: sleep(3600)` loop (which ignored both and could only be
    SIGKILLed).  On signal the server drains gracefully — stops
    accepting, lets in-flight statements finish within `drain_s`, cancels
    survivors with termination reason 'shutdown' — and this function
    RETURNS."""

    async def main():
        srv = MySQLServer(domain, host, port)
        await srv.start()
        print(f"tidb-tpu listening on {srv.host}:{srv.port}")
        loop = asyncio.get_running_loop()
        stop = loop.create_future()

        def request_stop(*_a):
            if not stop.done():
                stop.set_result(None)

        import signal

        for signum in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(signum, request_stop)
            except (NotImplementedError, RuntimeError):
                # platforms/loops without signal-handler support fall
                # back to the interpreter-level handler
                signal.signal(signum,
                              lambda *_a: loop.call_soon_threadsafe(
                                  request_stop))
        await stop
        print("tidb-tpu draining...")
        await srv.shutdown(drain_s=drain_s)
        print("tidb-tpu stopped")

    asyncio.run(main())

"""Cross-host fragment execution: the data plane's exchange transport.

One verb: `exec` — run this DAG over these partition ranges at this
snapshot, AT this partition-map epoch.  The epoch rides every request
and the owner re-checks it against its own broadcast before running, so
a fragment addressed under a stale map comes back as a typed epoch
error (never partial rows from a host that no longer owns the range) —
the wire-level twin of `RegionManager.check_epoch`.

Transport is length-framed pickle over TCP.  Pickle is acceptable here
for the same reason it is in `jax`'s own host-transfer layer: both ends
are the SAME trusted binary inside one fleet (the coord plane already
speaks newline-JSON on an adjacent port); chunks are numpy columns +
FieldType dataclasses, which pickle round-trips losslessly without
inventing a columnar wire format.

Chaos hardening:

- Every request carries a per-fragment DEADLINE derived from the query
  scope; the client waits in short slices and re-checks cancellation,
  so `KILL` during a stalled peer returns within the scope's bounded
  wait instead of a 30 s socket-timeout tail.
- Connections are POOLED per peer (`PeerPool`): dial once, reuse with
  a health-checked reconnect, close on member-leave so a dead peer
  cannot hold fds.
- Requests are IDEMPOTENT via a dedup key: the owner caches recent
  fragment results, so a retry (or the losing half of a hedged pair
  that landed on the same server) never double-executes side effects.
- `dataplane/peer_stall` and `dataplane/peer_error` are the server-side
  chaos sites the seeded sweep arms.

Byte metering: the server meters both directions of everything it
serves into `dataplane_served_bytes_total`; the CLIENT meters only the
exchange the query actually consumed into
`dataplane_exchange_bytes_total` (the bench receipt's headline number),
so failover retries and hedge losers land in
`dataplane_rpc_wasted_bytes_total` instead of double-counting the
per-query exchange.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..metrics import REGISTRY
from ..store.fault import FAILPOINTS
from ..util_concurrency import make_lock


class FragmentIneligible(Exception):
    """A partition fragment the card's whole-table program declines
    (the mesh's reject reason): the statement bypasses the data plane
    instead of running the fragment on the host engine."""


def run_on_card(storage, sub) -> list:
    """One partition fragment on this member's card: the mesh program
    over the partition store (`copr.parallel.try_run_mesh`, K1 / K2
    where the fragment needs them), never the host engine.  Raises
    FragmentIneligible when the program declines."""
    from ..copr.parallel import try_run_mesh

    out = try_run_mesh(storage, sub)
    if out is None:
        REGISTRY.inc("dataplane_fragments_declined_total")
        raise FragmentIneligible(
            getattr(sub, "mesh_reject_reason", None) or "ineligible")
    chunks = [c for c in out if c.num_rows]
    REGISTRY.inc("dataplane_card_fragments_total")
    return chunks

_HDR = struct.Struct(">Q")
#: frame cap (1 GiB): a corrupt header must not look like an allocation
_MAX_FRAME = 1 << 30

#: per-fragment deadline cap (seconds) when the scope carries no
#: deadline of its own; the scope's remaining time clamps it down
_FRAG_TIMEOUT_ENV = "TIDB_TPU_DATAPLANE_FRAG_TIMEOUT_S"
DEFAULT_FRAG_TIMEOUT_S = 10.0

#: socket-wait slice: the cancellation poll period (bounds how long a
#: KILL waits behind a stalled peer read)
_POLL_S = 0.2

#: pooled connections older than this re-verify with a ping before
#: reuse (a dead peer's half-open socket must fail fast, not mid-scan)
_HEALTH_AGE_S = 15.0

#: owner-side dedup cache entries (fragment results kept for retries)
_DEDUP_CAP = 64


def default_frag_timeout_s() -> float:
    try:
        return max(float(os.environ.get(_FRAG_TIMEOUT_ENV,
                                        DEFAULT_FRAG_TIMEOUT_S)), 0.05)
    except ValueError:
        return DEFAULT_FRAG_TIMEOUT_S


class DataplaneRPCError(RuntimeError):
    """Remote fragment failed for a non-epoch reason (the caller's
    failover ladder decides whether to retry, hop to the next replica,
    or run locally)."""


class PeerDeadlineExceeded(DataplaneRPCError):
    """The per-fragment deadline elapsed waiting on a peer — the
    failover ladder treats it exactly like a connection error."""


class PeerWaitCancelled(DataplaneRPCError):
    """The caller's cancel hook fired mid-wait (statement KILL, or the
    losing half of a hedged pair being called off)."""


def _send_obj(sock: socket.socket, obj) -> int:
    buf = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_HDR.pack(len(buf)) + buf)
    return len(buf)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        got = sock.recv(n - len(out))
        if not got:
            raise ConnectionError("dataplane peer closed mid-frame")
        out.extend(got)
    return bytes(out)


def _recv_obj(sock: socket.socket):
    (n,) = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if n > _MAX_FRAME:
        raise ConnectionError(f"dataplane frame too large: {n}")
    buf = _recv_exact(sock, n)
    return pickle.loads(buf), n


def _recv_exact_sliced(sock: socket.socket, n: int, deadline: float,
                       cancel: Optional[Callable[[], bool]]) -> bytes:
    """Receive exactly n bytes, waiting in `_POLL_S` slices so the
    overall deadline AND the caller's cancel hook are honored with
    bounded latency (no flat socket-timeout tail)."""
    out = bytearray()
    while len(out) < n:
        if cancel is not None and cancel():
            raise PeerWaitCancelled("fragment wait cancelled")
        if time.monotonic() >= deadline:
            raise PeerDeadlineExceeded(
                "fragment deadline exceeded waiting on peer")
        try:
            got = sock.recv(n - len(out))
        except socket.timeout:
            continue
        if not got:
            raise ConnectionError("dataplane peer closed mid-frame")
        out.extend(got)
    return bytes(out)


class DataplaneServer:
    """Owner-side fragment executor: one listener thread + one thread
    per connection (connections are long-lived — clients pool one per
    peer and multiplex fragments over it sequentially).

    Fragment requests carrying a `frag` dedup key are idempotent: the
    result of a recent execution is cached and replayed, so a client
    retry after a timeout (or the second half of a hedged pair landing
    here) never re-executes the fragment's side effects."""

    def __init__(self, storage, dataplane, host: str = "127.0.0.1",
                 port: int = 0):
        self.storage = storage
        self.dataplane = dataplane
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(16)
        # a blocked accept() is not reliably woken by close() on Linux;
        # poll with a short timeout so close() always reclaims the thread
        self._lsock.settimeout(0.25)
        self.addr = "%s:%d" % self._lsock.getsockname()
        self._stop = threading.Event()
        self._threads = []
        self._conns = []
        # dedup key -> ("inflight", Event) | ("done", resp)
        self._dedup_mu = make_lock(
            "dataplane.rpc:DataplaneServer._dedup_mu")
        self._dedup: Dict[str, tuple] = {}
        self._dedup_order: List[str] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="dataplane-rpc-accept",
            daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _peer = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            conn.settimeout(None)
            self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="dataplane-rpc-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket):
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while not self._stop.is_set():
                try:
                    req, n_in = _recv_obj(conn)
                except (ConnectionError, OSError, EOFError):
                    return
                REGISTRY.inc("dataplane_served_bytes_total", n_in)
                resp = self._dispatch(req)
                try:
                    n_out = _send_obj(conn, resp)
                except OSError:
                    return
                REGISTRY.inc("dataplane_served_bytes_total", n_out)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # ------------------------------------------------------------------
    # idempotent dispatch (dedup-keyed)
    # ------------------------------------------------------------------
    def _dispatch(self, req: dict) -> dict:
        if req.get("cmd") == "ping":
            return {"ok": 1}
        key = req.get("frag")
        if not key:
            return self._handle(req)
        with self._dedup_mu:
            ent = self._dedup.get(key)
            if ent is None:
                self._dedup[key] = ("inflight", threading.Event())
                self._dedup_order.append(key)
                while len(self._dedup_order) > _DEDUP_CAP:
                    old = self._dedup_order.pop(0)
                    if old != key:
                        self._dedup.pop(old, None)
        if ent is not None:
            state, val = ent
            if state == "done":
                REGISTRY.inc("dataplane_dedup_hits_total")
                return val
            # a twin of this fragment is executing right now: wait for
            # its result instead of double-executing (slices keep the
            # server responsive to close())
            while not self._stop.is_set():
                if val.wait(_POLL_S):
                    break
            with self._dedup_mu:
                ent = self._dedup.get(key)
            if ent is not None and ent[0] == "done":
                REGISTRY.inc("dataplane_dedup_hits_total")
                return ent[1]
            return {"err": "exec", "msg": "twin fragment never finished"}
        resp = self._handle(req)
        with self._dedup_mu:
            prev = self._dedup.get(key)
            self._dedup[key] = ("done", resp)
        if prev is not None and prev[0] == "inflight":
            prev[1].set()
        return resp

    def _handle(self, req: dict) -> dict:
        from ..store.kv import CopRequest, KeyRange

        try:
            if req.get("cmd") != "exec":
                return {"err": "bad_cmd"}
            # the chaos sites: a stalled peer (the action sleeps) and a
            # flaky peer (the action raises -> a transient exec error
            # the client's failover ladder must absorb)
            FAILPOINTS.hit("dataplane/peer_stall", frag=req.get("frag"))
            FAILPOINTS.hit("dataplane/peer_error", frag=req.get("frag"))
            # epoch gate FIRST: a fragment addressed under a stale map
            # must come back typed-retriable, not as partial rows
            self.dataplane.sync()
            view = self.dataplane.plane.view()
            built_at = int(req.get("epoch", -1))
            if built_at != view.epoch:
                return {"err": "epoch", "built_at": built_at,
                        "current": view.epoch}
            ranges = [KeyRange(int(t), int(s), int(e))
                      for t, s, e in req["ranges"]]
            sub = CopRequest(
                dag=req["dag"], ranges=ranges, ts=int(req["ts"]),
                concurrency=1, keep_order=True,
                engine=req.get("engine", "tpu"), aux=req.get("aux"))
            chunks = run_on_card(self.storage, sub)
            REGISTRY.inc("dataplane_remote_fragments_total")
            return {"chunks": chunks,
                    "rows": sum(c.num_rows for c in chunks)}
        except FragmentIneligible as e:
            return {"err": "ineligible", "msg": str(e)}
        except Exception as e:  # noqa: BLE001 - wire boundary
            REGISTRY.inc("dataplane_rpc_errors_total")
            return {"err": "exec", "msg": f"{type(e).__name__}: {e}"}

    def close(self):
        self._stop.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=2.0)
        for t in self._threads:
            t.join(timeout=2.0)


class PeerClient:
    """Caller-side connection to one owner.  Fragments are sent
    sequentially per connection (fan-out parallelism and hedging come
    from using separate pooled connections, not pipelining within
    one)."""

    def __init__(self, addr: str, timeout_s: float = 5.0):
        host, port = addr.rsplit(":", 1)
        self.addr = addr
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(_POLL_S)
        self.last_used = time.monotonic()
        self.broken = False

    def call(self, req: dict, deadline_s: float,
             cancel: Optional[Callable[[], bool]] = None
             ) -> Tuple[dict, int]:
        """One request/response round trip under a deadline; returns
        (response, bytes moved).  Any failure marks the connection
        broken — a half-read frame cannot be resumed, so the pool
        discards it."""
        deadline = time.monotonic() + max(deadline_s, 0.05)
        try:
            n_out = _send_obj(self._sock, req)
            (n,) = _HDR.unpack(_recv_exact_sliced(
                self._sock, _HDR.size, deadline, cancel))
            if n > _MAX_FRAME:
                raise ConnectionError(f"dataplane frame too large: {n}")
            buf = _recv_exact_sliced(self._sock, n, deadline, cancel)
        except BaseException:
            self.broken = True
            raise
        self.last_used = time.monotonic()
        return pickle.loads(buf), n_out + n

    def exec_fragment(self, dag: dict, ranges, ts: int, epoch: int,
                      engine: str, aux: Optional[dict] = None,
                      frag: Optional[str] = None,
                      deadline_s: Optional[float] = None,
                      cancel: Optional[Callable[[], bool]] = None
                      ) -> Tuple[dict, int]:
        req = {"cmd": "exec", "dag": dag, "ranges": ranges, "ts": ts,
               "epoch": epoch, "engine": engine, "aux": aux,
               "frag": frag}
        return self.call(req, deadline_s if deadline_s is not None
                         else default_frag_timeout_s(), cancel)

    def ping(self, deadline_s: float = 1.0) -> bool:
        try:
            resp, _n = self.call({"cmd": "ping"}, deadline_s)
            return bool(resp.get("ok"))
        except Exception:
            return False

    def close(self):
        self.broken = True
        try:
            self._sock.close()
        except OSError:
            pass


class PeerPool:
    """Pooled peer connections: one dial per peer reused across
    dispatches, with a health-checked reconnect (stale sockets ping
    before reuse) and explicit pruning on member-leave so a dead peer
    cannot hold fds.  The pool lock is never held across a dial or any
    socket I/O."""

    def __init__(self, per_addr: int = 2):
        self._mu = make_lock("dataplane.rpc:PeerPool._mu")
        self._idle: Dict[str, List[PeerClient]] = {}
        self.per_addr = per_addr

    def acquire(self, addr: str,
                connect_timeout_s: float = 5.0) -> PeerClient:
        while True:
            with self._mu:
                conns = self._idle.get(addr)
                conn = conns.pop() if conns else None
            if conn is None:
                client = PeerClient(addr, timeout_s=connect_timeout_s)
                REGISTRY.inc("dataplane_conn_dials_total")
                return client
            if time.monotonic() - conn.last_used > _HEALTH_AGE_S:
                REGISTRY.inc("dataplane_conn_health_checks_total")
                if not conn.ping():
                    conn.close()
                    REGISTRY.inc("dataplane_conn_evictions_total")
                    continue
            REGISTRY.inc("dataplane_conn_reuse_total")
            return conn

    def release(self, conn: PeerClient):
        """Return a connection after use; broken connections (any error
        or an abandoned in-flight response) are discarded — a pooled
        socket must always be at a frame boundary."""
        if conn.broken:
            conn.close()
            REGISTRY.inc("dataplane_conn_evictions_total")
            return
        drop = None
        with self._mu:
            conns = self._idle.setdefault(conn.addr, [])
            if len(conns) >= self.per_addr:
                drop = conn
            else:
                conns.append(conn)
        if drop is not None:
            drop.close()
            REGISTRY.inc("dataplane_conn_evictions_total")

    def prune(self, live_addrs) -> int:
        """Close idle connections to peers no longer in the membership
        broadcast (member-leave / lease expiry)."""
        live = set(live_addrs)
        dead: List[PeerClient] = []
        with self._mu:
            for addr in [a for a in self._idle if a not in live]:
                dead.extend(self._idle.pop(addr) or ())
        for c in dead:
            c.close()
            REGISTRY.inc("dataplane_conn_evictions_total")
        return len(dead)

    def close_all(self):
        with self._mu:
            conns = [c for cs in self._idle.values() for c in cs]
            self._idle.clear()
        for c in conns:
            c.close()

    def idle_count(self) -> int:
        with self._mu:
            return sum(len(cs) for cs in self._idle.values())


#: process-global pool (one fleet per process; tests reset via
#: deactivate_dataplane -> close_all)
POOL = PeerPool()

"""Graceful drain of the port's MySQL wire server
(`tidb_tpu_torch.server.MySQLServer.shutdown`) with clients connected,
on the CPU.

Since Python 3.12.1 `asyncio.Server.wait_closed()` waits for every open
connection, so a drain that awaited it before closing its connections
never returned while a client was connected.  Each drain here runs
under a limit of `drain_s` + 10 s (`_drain`) and names that cause when
it is overrun:

- the in-flight statement finishes, a new connect is refused and the
  connection closes;
- a statement that outlives the drain budget gets ERR 1053 and is
  counted in `server_drain_cancelled_total`;
- a drain with one idle client returns within `drain_s` + 1 s;
- a prepared session is handed off on drain and replayed by a fresh
  server in the same process.
"""

import asyncio
import time

import pytest

from tidb_tpu_torch import ops as tops
from tidb_tpu_torch.coord import reset_plane
from tidb_tpu_torch.metrics import REGISTRY
from tidb_tpu_torch.server import MySQLServer
from tidb_tpu_torch.session import Domain

from test_torch_server import MiniClient, run


@pytest.fixture(scope="module")
def domain():
    """One Domain with table `d` = (42) for every server of the file."""
    tops.use_device("cpu")
    d = Domain()
    s = d.new_session()
    s.execute("create table d (a bigint)")
    s.execute("insert into d values (42)")
    yield d
    d.maintenance.stop()


@pytest.fixture(autouse=True)
def _plane_isolation():
    """The handoff plane is process-global: every test starts and ends
    on the lazy local default."""
    reset_plane()
    yield
    reset_plane()


async def _drain(srv, drain_s):
    """`srv.shutdown(drain_s)`, failing past `drain_s` + 10 s."""
    try:
        await asyncio.wait_for(srv.shutdown(drain_s=drain_s), drain_s + 10)
    except asyncio.TimeoutError:
        pytest.fail(f"shutdown(drain_s={drain_s}) hung with a client"
                    " connected: Server.wait_closed() awaited before the"
                    " connections were closed")


async def _serve(domain):
    srv = MySQLServer(domain, port=0)
    await srv.start()
    cli = MiniClient(srv.host, srv.port)
    await cli.connect(db="test")
    return srv, cli


def test_drain_finishes_inflight_refuses_new_and_closes(domain):
    async def body():
        srv, cli = await _serve(domain)
        await cli.command(0x03, b"select a, sleep(1.0) from d")
        # executing, not parked in the admission queue
        await asyncio.sleep(0.3)
        drain = asyncio.ensure_future(_drain(srv, 5.0))
        await asyncio.sleep(0.05)
        with pytest.raises(ConnectionRefusedError):
            await MiniClient(srv.host, srv.port).connect()
        assert (await cli.read_result())["rows"] == [("42", "0")]
        await drain
        assert await cli.reader.read() == b""
        cli.writer.close()

    run(body())


def test_drain_cancels_survivor_with_err_1053(domain):
    async def body():
        srv, cli = await _serve(domain)
        c0 = REGISTRY.get("server_drain_cancelled_total")
        await cli.command(0x03, b"select sleep(30)")
        await asyncio.sleep(0.3)
        t0 = time.monotonic()
        await _drain(srv, 0.1)
        assert time.monotonic() - t0 < 5.0
        r = await cli.read_result()
        assert r.get("error") == 1053, r
        assert REGISTRY.get("server_drain_cancelled_total") >= c0 + 1
        cli.writer.close()

    run(body())


def test_drain_with_idle_client_returns_within_budget(domain):
    async def body():
        srv, cli = await _serve(domain)
        assert (await cli.query("select 1"))["rows"] == [("1",)]
        t0 = time.monotonic()
        await _drain(srv, 0.5)
        assert time.monotonic() - t0 < 0.5 + 1.0
        assert await cli.reader.read() == b""
        cli.writer.close()

    run(body())


def test_drain_hands_off_prepared_session_to_fresh_server(domain):
    async def body():
        srv_a, cli = await _serve(domain)
        assert (await cli.query(
            "prepare ps1 from 'select 21 * 2'")).get("ok")
        assert (await cli.query(
            "set tidb_slow_log_threshold = 4321")).get("ok")
        p0 = REGISTRY.get("coord_handoff_put_total")
        r0 = REGISTRY.get("coord_handoff_replayed_total")
        await _drain(srv_a, 2.0)
        cli.writer.close()
        assert REGISTRY.get("coord_handoff_put_total") == p0 + 1
        dom_b = Domain()
        srv_b = MySQLServer(dom_b, port=0)
        await srv_b.start()
        try:
            assert REGISTRY.get("coord_handoff_replayed_total") == r0 + 1
            replayed = [s for s in dom_b.sessions.values()
                        if getattr(s, "handoff_origin", None) is not None]
            assert len(replayed) == 1
            assert replayed[0].query("execute ps1") == [(42,)]
            assert replayed[0].vars.get_int(
                "tidb_slow_log_threshold") == 4321
        finally:
            await srv_b.stop()
            dom_b.maintenance.stop()

    run(body())

"""The benchmark's MySQL protocol-4.1 client and its closed-loop streams.

It carries its own packet codec and imports nothing of the program under
test.  Run as a child process, so the clients' Python never takes the
server's interpreter lock:

    python3 -m benchmark.client

Protocol with the parent, one JSON object or word a line:

1. stdin: the spec, `{"host", "port", "db", "seconds", "drain_s",
   "warm": [[sql, ...], ...], "streams": [[sql, ...], ...]}`; every
   stream gets a connection of its own and sends its list in order, from
   the start again when it comes to the end;
2. stdout: `ready` once every connection has logged in and sent its
   warm-up statements (the streams at once), which are not timed;
3. stdin: `go`; the window opens, each stream sends its next statement
   when its last reply has come (a closed loop) until `seconds` have
   passed, and the statements still in flight then get up to `drain_s`
   more to answer;
4. stdout: the result, `{"t_open", "t_close", "stmts": [[stream, index,
   t_send, t_done, ok], ...], "answers": {sql: [rows, ...]},
   "errors": [...]}`: times on the host's monotonic clock
   (`time.perf_counter`, shared by every process of the machine), each
   distinct answer to each statement as wire text.
"""

from __future__ import annotations

import asyncio
import json
import struct
import sys
import time

CLIENT_CONNECT_WITH_DB = 0x0008
CLIENT_PROTOCOL_41 = 0x0200
CLIENT_SECURE_CONNECTION = 0x8000
COM_QUIT = 0x01
COM_QUERY = 0x03
UTF8_GENERAL_CI = 33


class WireError(Exception):
    """An ERR packet: the server refused or failed the statement."""


def read_lenenc_int(buf: bytes, pos: int):
    c = buf[pos]
    if c < 0xFB:
        return c, pos + 1
    if c == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if c == 0xFD:
        return int.from_bytes(buf[pos + 1:pos + 4], "little"), pos + 4
    return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9


def read_lenenc_str(buf: bytes, pos: int):
    n, pos = read_lenenc_int(buf, pos)
    return buf[pos:pos + n], pos + n


def frame(payload: bytes, seq: int) -> bytes:
    """`payload` as packets of at most 2**24 - 1 bytes from sequence id
    `seq` (a payload of exactly that size is followed by an empty one)."""
    out = b""
    off = 0
    while True:
        chunk = payload[off:off + 0xFFFFFF]
        out += len(chunk).to_bytes(3, "little") + bytes([seq & 0xFF]) + chunk
        seq += 1
        off += len(chunk)
        if len(chunk) != 0xFFFFFF:
            return out


def parse_row(pkt: bytes, ncols: int) -> tuple:
    """A text-protocol row: NULL (0xFB) or a length-encoded string."""
    pos = 0
    row = []
    for _ in range(ncols):
        if pkt[pos] == 0xFB:
            row.append(None)
            pos += 1
        else:
            v, pos = read_lenenc_str(pkt, pos)
            row.append(v.decode("utf8"))
    return tuple(row)


class Connection:
    """One logged-in connection: COM_QUERY with text result sets."""

    def __init__(self, reader, writer):
        self.reader, self.writer = reader, writer
        self.seq = 0

    @classmethod
    async def open(cls, host: str, port: int, db: str = "",
                   user: str = "root") -> "Connection":
        reader, writer = await asyncio.open_connection(host, port)
        conn = cls(reader, writer)
        greeting = await conn.recv()
        if greeting[0] != 10:
            raise WireError(f"protocol version {greeting[0]}, not 10")
        caps = CLIENT_PROTOCOL_41 | CLIENT_SECURE_CONNECTION
        if db:
            caps |= CLIENT_CONNECT_WITH_DB
        resp = struct.pack("<II", caps, 1 << 24) + bytes([UTF8_GENERAL_CI])
        resp += b"\x00" * 23 + user.encode() + b"\x00" + b"\x00"  # no auth
        if db:
            resp += db.encode() + b"\x00"
        await conn.send(resp)
        ok = await conn.recv()
        if ok[0] != 0x00:
            raise WireError(f"login refused: {ok[9:].decode(errors='replace')}")
        return conn

    async def recv(self) -> bytes:
        parts = []
        while True:
            header = await self.reader.readexactly(4)
            n = int.from_bytes(header[:3], "little")
            self.seq = header[3] + 1
            parts.append(await self.reader.readexactly(n) if n else b"")
            if n != 0xFFFFFF:
                return b"".join(parts)

    async def send(self, payload: bytes):
        self.writer.write(frame(payload, self.seq))
        self.seq += 1 + len(payload) // 0xFFFFFF
        await self.writer.drain()

    async def query(self, sql: str):
        """The rows of `sql` as tuples of wire text (None for NULL), or
        the affected-row count for a statement that returns no rows."""
        self.seq = 0
        await self.send(bytes([COM_QUERY]) + sql.encode())
        first = await self.recv()
        if first[0] == 0x00:
            return read_lenenc_int(first, 1)[0]
        if first[0] == 0xFF:
            code = struct.unpack_from("<H", first, 1)[0]
            raise WireError(f"{code}: {first[9:].decode(errors='replace')}")
        ncols = read_lenenc_int(first, 0)[0]
        for _ in range(ncols):
            await self.recv()  # column definitions
        if (await self.recv())[0] != 0xFE:
            raise WireError("no EOF after the column definitions")
        rows = []
        while True:
            pkt = await self.recv()
            if pkt[0] == 0xFE and len(pkt) < 9:
                return rows
            rows.append(parse_row(pkt, ncols))

    async def close(self):
        self.seq = 0
        try:
            await self.send(bytes([COM_QUIT]))
        finally:
            self.writer.close()


async def _stream(i, conn, stmts, t_close, rec, answers, errors):
    """Closed loop: the next statement when the last reply is in, until
    the window closes."""
    k = 0
    while time.perf_counter() < t_close:
        sql = stmts[k % len(stmts)]
        entry = [i, k, time.perf_counter(), None, 0]
        rec.append(entry)  # sent; t_done stays None if no answer comes
        try:
            rows = await conn.query(sql)
        except WireError as e:
            errors.append(f"stream {i} statement {k}: {e}")
            entry[3] = time.perf_counter()
            k += 1
            continue
        entry[3], entry[4] = time.perf_counter(), 1
        seen = answers.setdefault(sql, [])
        if rows not in seen:
            seen.append(rows)
        k += 1


async def _window(conns, spec):
    rec, answers, errors = [], {}, []
    t_open = time.perf_counter()
    t_close = t_open + float(spec["seconds"])
    tasks = [asyncio.ensure_future(_stream(i, c, st, t_close, rec, answers,
                                           errors))
             for i, (c, st) in enumerate(zip(conns, spec["streams"]))]
    done, pending = await asyncio.wait(
        tasks, timeout=t_close - time.perf_counter() + float(spec["drain_s"]))
    for t in pending:
        t.cancel()
        errors.append("a statement sent in the window did not answer "
                      f"within {spec['drain_s']} s of its close")
    await asyncio.gather(*pending, return_exceptions=True)
    for t in done:
        t.result()
    return {"t_open": t_open, "t_close": t_close, "stmts": rec,
            "answers": {sql: [[list(r) for r in rows] for rows in seen]
                        for sql, seen in answers.items()},
            "errors": errors}


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    async def warm(sqls):
        conn = await Connection.open(spec["host"], spec["port"], spec["db"])
        for sql in sqls:
            await conn.query(sql)
        return conn

    async def connect_all():
        return await asyncio.gather(*(warm(w) for w in spec["warm"]))

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    conns = loop.run_until_complete(connect_all())
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    out = loop.run_until_complete(_window(conns, spec))
    for c in conns:
        try:
            loop.run_until_complete(c.close())
        except OSError:
            pass
    loop.close()
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""MySQL wire packet framing + primitive codecs.

Reference: server/packetio.go (3-byte little-endian length + sequence id
framing), util/hack + protocol encoders in server/conn.go.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

MAX_PACKET = 1 << 24 - 1


def lenenc_int(n: int) -> bytes:
    if n < 0xFB:
        return bytes([n])
    if n < (1 << 16):
        return b"\xfc" + struct.pack("<H", n)
    if n < (1 << 24):
        return b"\xfd" + struct.pack("<I", n)[:3]
    return b"\xfe" + struct.pack("<Q", n)


def read_lenenc_int(buf: bytes, pos: int) -> Tuple[int, int]:
    c = buf[pos]
    if c < 0xFB:
        return c, pos + 1
    if c == 0xFC:
        return struct.unpack_from("<H", buf, pos + 1)[0], pos + 3
    if c == 0xFD:
        return int.from_bytes(buf[pos + 1:pos + 4], "little"), pos + 4
    return struct.unpack_from("<Q", buf, pos + 1)[0], pos + 9


def lenenc_str(s: bytes) -> bytes:
    return lenenc_int(len(s)) + s


def read_lenenc_str(buf: bytes, pos: int) -> Tuple[bytes, int]:
    n, pos = read_lenenc_int(buf, pos)
    return buf[pos:pos + n], pos + n


class PacketWriter:
    def __init__(self, writer):
        self.writer = writer
        self.seq = 0

    def reset_seq(self):
        self.seq = 0

    async def send(self, payload: bytes):
        off = 0
        n = len(payload)
        while True:
            chunk = payload[off:off + 0xFFFFFF]
            header = len(chunk).to_bytes(3, "little") + bytes([self.seq & 0xFF])
            self.writer.write(header + chunk)
            self.seq += 1
            off += len(chunk)
            if off >= n and len(chunk) != 0xFFFFFF:
                break
        await self.writer.drain()


class PacketReader:
    def __init__(self, reader):
        self.reader = reader
        self.seq = 0

    async def recv(self) -> Optional[bytes]:
        parts = []
        while True:
            header = await self.reader.readexactly(4)
            length = int.from_bytes(header[:3], "little")
            self.seq = header[3] + 1
            body = await self.reader.readexactly(length) if length else b""
            parts.append(body)
            if length != 0xFFFFFF:
                break
        return b"".join(parts)

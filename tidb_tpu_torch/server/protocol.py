"""MySQL protocol payloads: handshake, OK/ERR/EOF, column defs, row codecs.

Reference: server/conn.go (writeInitialHandshake :600s, handshake response
parse, writeOK/writeError), server/column.go (column definition 41),
server/util.go (dumpTextRow/dumpBinaryRow).
"""

from __future__ import annotations

import struct
from typing import List, Optional

from ..types import FieldType, TypeKind
from .packet import lenenc_int, lenenc_str

PROTOCOL_VERSION = 10
SERVER_VERSION = b"8.0.11-tidb-tpu-1.0"

# capability flags
CLIENT_LONG_PASSWORD = 1
CLIENT_FOUND_ROWS = 2
CLIENT_LONG_FLAG = 4
CLIENT_CONNECT_WITH_DB = 8
CLIENT_PROTOCOL_41 = 512
CLIENT_TRANSACTIONS = 8192
CLIENT_SECURE_CONNECTION = 32768
CLIENT_PLUGIN_AUTH = 1 << 19
CLIENT_DEPRECATE_EOF = 1 << 24

SERVER_CAPS = (
    CLIENT_LONG_PASSWORD | CLIENT_FOUND_ROWS | CLIENT_LONG_FLAG
    | CLIENT_CONNECT_WITH_DB | CLIENT_PROTOCOL_41 | CLIENT_TRANSACTIONS
    | CLIENT_SECURE_CONNECTION | CLIENT_PLUGIN_AUTH
)

# column types (mysql protocol)
T_DECIMAL = 0x00
T_TINY = 0x01
T_LONGLONG = 0x08
T_DOUBLE = 0x05
T_NULL = 0x06
T_DATE = 0x0A
T_DATETIME = 0x0C
T_VARCHAR = 0x0F
T_NEWDECIMAL = 0xF6
T_VAR_STRING = 0xFD

_KIND_TO_MYSQL = {
    TypeKind.NULLTYPE: T_NULL,
    TypeKind.INT: T_LONGLONG,
    TypeKind.UINT: T_LONGLONG,
    TypeKind.BOOL: T_TINY,
    TypeKind.FLOAT: T_DOUBLE,
    TypeKind.DECIMAL: T_NEWDECIMAL,
    TypeKind.STRING: T_VAR_STRING,
    TypeKind.DATE: T_DATE,
    TypeKind.DATETIME: T_DATETIME,
}


def handshake_v10(conn_id: int, salt: bytes) -> bytes:
    out = bytes([PROTOCOL_VERSION]) + SERVER_VERSION + b"\x00"
    out += struct.pack("<I", conn_id)
    out += salt[:8] + b"\x00"
    out += struct.pack("<H", SERVER_CAPS & 0xFFFF)
    out += bytes([33])  # charset utf8
    out += struct.pack("<H", 2)  # status: autocommit
    out += struct.pack("<H", (SERVER_CAPS >> 16) & 0xFFFF)
    out += bytes([21])  # auth data len
    out += b"\x00" * 10
    out += salt[8:20] + b"\x00"
    out += b"mysql_native_password\x00"
    return out


def parse_handshake_response(data: bytes) -> dict:
    caps = struct.unpack_from("<I", data, 0)[0]
    pos = 4 + 4 + 1 + 23  # caps, max packet, charset, filler
    end = data.index(b"\x00", pos)
    user = data[pos:end].decode("utf8", "replace")
    pos = end + 1
    if caps & CLIENT_SECURE_CONNECTION:
        alen = data[pos]
        pos += 1
        auth = data[pos:pos + alen]
        pos += alen
    else:
        end = data.index(b"\x00", pos)
        auth = data[pos:end]
        pos = end + 1
    db = ""
    if caps & CLIENT_CONNECT_WITH_DB and pos < len(data):
        end = data.find(b"\x00", pos)
        if end < 0:
            end = len(data)
        db = data[pos:end].decode("utf8", "replace")
    return {"caps": caps, "user": user, "auth": auth, "db": db}


def ok_packet(affected: int = 0, last_insert_id: int = 0,
              status: int = 2, warnings: int = 0) -> bytes:
    return (b"\x00" + lenenc_int(affected) + lenenc_int(last_insert_id)
            + struct.pack("<HH", status, warnings))


def eof_packet(status: int = 2, warnings: int = 0) -> bytes:
    return b"\xfe" + struct.pack("<HH", warnings, status)


def err_packet(code: int, message: str, state: str = "HY000") -> bytes:
    return (b"\xff" + struct.pack("<H", code) + b"#" + state.encode()
            + message.encode("utf8", "replace")[:400])


def column_def(name: str, ft: Optional[FieldType]) -> bytes:
    mt = wire_kind(ft)
    charset = 63 if mt in (T_LONGLONG, T_DOUBLE) else 33
    out = lenenc_str(b"def")           # catalog
    out += lenenc_str(b"")             # schema
    out += lenenc_str(b"")             # table
    out += lenenc_str(b"")             # org_table
    out += lenenc_str(name.encode("utf8", "replace"))
    out += lenenc_str(name.encode("utf8", "replace"))
    out += bytes([0x0C])
    out += struct.pack("<H", charset)
    out += struct.pack("<I", 1024)     # column length
    out += bytes([mt])
    out += struct.pack("<H", 0)        # flags
    decimals = ft.scale if ft and ft.kind == TypeKind.DECIMAL else 0
    out += bytes([decimals])
    out += b"\x00\x00"
    return out


def text_row(values) -> bytes:
    out = b""
    for v in values:
        if v is None:
            out += b"\xfb"
        else:
            if isinstance(v, float):
                s = repr(v)
            else:
                s = str(v)
            out += lenenc_str(s.encode("utf8", "replace"))
    return out


def wire_kind(ft: Optional[FieldType]) -> int:
    """Column type actually used on the wire.  DATE/DATETIME/DECIMAL go as
    strings (the session pre-formats them), so they are declared VAR_STRING
    and both text and binary rows encode them as lenenc strings."""
    if ft is None:
        return T_VAR_STRING
    if ft.kind in (TypeKind.INT, TypeKind.UINT, TypeKind.BOOL):
        return T_LONGLONG
    if ft.kind == TypeKind.FLOAT:
        return T_DOUBLE
    return T_VAR_STRING


def binary_row(values, fts) -> bytes:
    """Binary-protocol resultset row (conn_stmt dumpBinaryRow): 0x00 header,
    NULL bitmap with offset 2, then values encoded per declared wire type."""
    n = len(values)
    bitmap = bytearray((n + 9) // 8)
    body = b""
    for i, v in enumerate(values):
        if v is None:
            pos = i + 2
            bitmap[pos // 8] |= 1 << (pos % 8)
            continue
        wk = wire_kind(fts[i] if fts and i < len(fts) else None)
        if wk == T_LONGLONG:
            body += struct.pack("<q", int(v))
        elif wk == T_DOUBLE:
            body += struct.pack("<d", float(v))
        else:
            s = repr(v) if isinstance(v, float) else str(v)
            body += lenenc_str(s.encode("utf8", "replace"))
    return b"\x00" + bytes(bitmap) + body

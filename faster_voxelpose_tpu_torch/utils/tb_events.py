"""TensorBoard-readable scalar event files, dependency-free (the port's
copy of `faster_voxelpose_tpu/utils/tb_events.py`, byte for byte the
same records).

The reference streams its five loss scalars to tensorboardX
(lib/utils/utils.py:44-50, lib/core/function.py:102-109).  This module
writes the same `events.out.tfevents.*` files TensorBoard consumes,
without tensorboardX or protobuf: an Event proto carrying
Summary/simple_value is a fixed three-level message encoded by hand,
framed in TFRecord records (length + masked-crc32c, the format
`tf.io.TFRecordWriter` produces).  `read_events` is an independent
decoder for tests and offline inspection.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# crc32c (Castagnoli, reflected poly 0x82F63B78) — the TFRecord checksum
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        table = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding (varint / fixed64 / fixed32 / bytes)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def encode_scalar_event(tag: str, value: float, step: int, wall: float) -> bytes:
    """Event{wall_time=1, step=2, summary=5{value=1{tag=1, simple_value=2}}}."""
    val = _f_bytes(1, tag.encode("utf-8")) + _f_float(2, float(value))
    summary = _f_bytes(1, val)
    return _f_double(1, wall) + _f_varint(2, int(step)) + _f_bytes(5, summary)


def encode_version_event(wall: float) -> bytes:
    """Event{wall_time=1, file_version=3} — TensorBoard's header record."""
    return _f_double(1, wall) + _f_bytes(3, b"brain.Event:2")


def frame_record(payload: bytes) -> bytes:
    """TFRecord framing: u64 length, masked crc of the length bytes,
    payload, masked crc of the payload."""
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + payload
        + struct.pack("<I", masked_crc32c(payload))
    )


class TBEventWriter:
    """Append scalar events to an `events.out.tfevents.*` file that
    TensorBoard's `--logdir` scan picks up directly."""

    _seq = itertools.count()

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname() or "local"
        # pid + per-process counter suffix (as tensorboardX does) so two
        # writers created in the same log_dir within the same second get
        # distinct files instead of interleaving one stream
        self.path = os.path.join(
            log_dir,
            f"events.out.tfevents.{int(time.time())}.{host}."
            f"{os.getpid()}.{next(self._seq)}",
        )
        self._fh = open(self.path, "ab")
        self._fh.write(frame_record(encode_version_event(time.time())))
        self._fh.flush()

    def add_scalar(self, tag: str, value, step: int):
        self._fh.write(
            frame_record(
                encode_scalar_event(tag, float(value), int(step), time.time())
            )
        )
        self._fh.flush()

    def close(self):
        self._fh.close()


# ---------------------------------------------------------------------------
# independent decoder (tests + offline inspection of written files)
# ---------------------------------------------------------------------------


def read_events(path: str):
    """Decode an event file back to [{'wall', 'step', 'tag', 'value'} |
    {'wall', 'file_version'}], verifying every record CRC."""
    out = []
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        (lcrc,) = struct.unpack_from("<I", data, pos + 8)
        if masked_crc32c(data[pos : pos + 8]) != lcrc:
            raise ValueError(f"length crc mismatch at {pos}")
        payload = data[pos + 12 : pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if masked_crc32c(payload) != pcrc:
            raise ValueError(f"payload crc mismatch at {pos}")
        out.append(_decode_event(payload))
        pos += 16 + length
    return out


def _decode_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 1:
            (v,) = struct.unpack_from("<d", buf, pos)
            pos += 8
        elif wire == 5:
            (v,) = struct.unpack_from("<f", buf, pos)
            pos += 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            v = buf[pos : pos + n]
            pos += n
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _decode_event(payload: bytes):
    ev = {}
    for field, _wire, v in _decode_fields(payload):
        if field == 1:
            ev["wall"] = v
        elif field == 2:
            ev["step"] = v
        elif field == 3:
            ev["file_version"] = v.decode("utf-8")
        elif field == 5:
            for f2, _w2, v2 in _decode_fields(v):
                if f2 == 1:
                    for f3, _w3, v3 in _decode_fields(v2):
                        if f3 == 1:
                            ev["tag"] = v3.decode("utf-8")
                        elif f3 == 2:
                            ev["value"] = v3
    return ev

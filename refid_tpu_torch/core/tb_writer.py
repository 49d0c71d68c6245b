"""TensorBoard scalar writer in plain Python (mirrors
``refid_tpu/core/tb_writer.py``): no TensorFlow, tensorboardX or
TensorBoard package.

An ``events.out.tfevents.<time>.<host>`` file is a TFRecord stream (each
record: little-endian length, its masked CRC32C, the data, the data's
masked CRC32C) of ``Event`` protobuf messages, encoded here by hand: a
first event with ``file_version`` ``brain.Event:2``, then one event per
``add_scalars`` call holding a ``Summary`` of ``(tag, simple_value)``
values.  The train CLI writes the reference's tags: ``losses/<name>`` and
``learning_rate`` every ``print_freq`` iterations, ``metrics/<dataset>/<name>``
at each validation.
"""

from __future__ import annotations

import os
import socket
import struct
import time

__all__ = ["TensorBoardWriter", "read_scalars"]


def _crc_table():
    poly = 0x82F63B78                 # CRC32C (Castagnoli), reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire format, the few fields an event needs ---------------------------

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
    return _varint(field << 3 | wire)


def _bytes_field(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _event(step: int, summary: bytes = b"", file_version: str = "",
           wall_time: float = None) -> bytes:
    """Event {double wall_time = 1; int64 step = 2; string file_version = 3;
    Summary summary = 5}."""
    msg = _key(1, 1) + struct.pack("<d", time.time() if wall_time is None else wall_time)
    if step:
        msg += _key(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version:
        msg += _bytes_field(3, file_version.encode())
    if summary:
        msg += _bytes_field(5, summary)
    return msg


def _summary(tag_values: dict) -> bytes:
    """Summary {repeated Value value = 1}; Value {string tag = 1; float
    simple_value = 2}."""
    return b"".join(_bytes_field(1, _bytes_field(1, tag.encode())
                                 + _key(2, 5) + struct.pack("<f", float(v)))
                    for tag, v in tag_values.items())


class TensorBoardWriter:
    """Append-only scalar event file, flushed after each write."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}")
        self._f = open(self.path, "ab")
        self._write_record(_event(0, file_version="brain.Event:2"))
        self._f.flush()

    def _write_record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header + struct.pack("<I", _masked_crc(header)) + data
                      + struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int):
        self.add_scalars({tag: value}, step)

    def add_scalars(self, tag_values: dict, step: int):
        self._write_record(_event(int(step), _summary(tag_values)))
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --- reading back ------------------------------------------------------------------

def _fields(msg: bytes):
    """(field, wire type, value) of each field of a protobuf message."""
    pos = 0
    while pos < len(msg):
        key, pos = _read_varint(msg, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(msg, pos)
        elif wire == 1:
            value, pos = msg[pos:pos + 8], pos + 8
        elif wire == 5:
            value, pos = msg[pos:pos + 4], pos + 4
        elif wire == 2:
            n, pos = _read_varint(msg, pos)
            value, pos = msg[pos:pos + n], pos + n
        else:
            raise ValueError(f"protobuf wire type {wire} is not read here")
        yield field, wire, value


def _read_varint(msg: bytes, pos: int):
    n = shift = 0
    while True:
        b = msg[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, pos


def read_scalars(path: str):
    """``[(step, tag, value), ...]`` of an event file, in file order; every
    record's CRCs checked."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        if struct.unpack("<I", data[pos + 8:pos + 12])[0] != _masked_crc(header):
            raise ValueError(f"{path}: record header CRC mismatch at byte {pos}")
        event = data[pos + 12:pos + 12 + length]
        if struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])[0] != \
                _masked_crc(event):
            raise ValueError(f"{path}: record CRC mismatch at byte {pos}")
        pos += 16 + length
        step, values = 0, []
        for field, _, value in _fields(event):
            if field == 2:
                step = value
            elif field == 5:
                for _, _, v in _fields(value):
                    entry = dict((f, x) for f, _, x in _fields(v))
                    values.append((entry[1].decode(), struct.unpack("<f", entry[2])[0]))
        out.extend((step, tag, value) for tag, value in values)
    return out

"""Dependency-free TensorBoard scalar event writer and reader.

Counterpart of ``unet_zoo_tpu/utils/tb_writer.py``, copied (pure Python).
The training loop always logs through it, so the port needs no
``tensorboard`` install. It writes the TFRecord/Event wire format directly
(hand-rolled protobuf encoding + masked CRC32C) for the scalar subset the
loop uses; stock TensorBoard reads the files.

Wire format per record::

    uint64 length | uint32 masked_crc32c(length_le) | data | uint32 masked_crc32c(data)

``data`` is a serialized ``tensorboard.Event`` proto; only fields used:
Event{wall_time=1(double), step=2(int64), file_version=3(string),
summary=5(Summary)}; Summary{value=1(repeated Value)};
Value{tag=1(string), simple_value=2(float)}.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------- CRC32C

_CRC_TABLE = []
_POLY = 0x82F63B78  # Castagnoli, reflected


def _build_table():
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ _POLY if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field_double(num: int, v: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint((num << 3) | 0) + _varint(v)


def _field_bytes(num: int, v: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(v)) + v


def _field_float(num: int, v: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", v)


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    msg = _field_double(1, wall_time)
    if step is not None:
        msg += _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if summary is not None:
        msg += _field_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    return _field_bytes(1, val)


class EventFileWriter:
    """Minimal ``SummaryWriter``-compatible scalar writer (pure Python)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}.uz")
        self._path = os.path.join(log_dir, fname)
        self._f = open(self._path, "wb")
        self._write_record(_event(time.time(), file_version="brain.Event:2"))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    # SummaryWriter-compatible surface (scalar subset used by the harness)
    def add_scalar(self, tag: str, value: float, global_step: int = 0) -> None:
        self._write_record(
            _event(time.time(), step=int(global_step),
                   summary=_scalar_summary(tag, value)))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_scalar_events(path: str):
    """Parse an event file back into ``[(tag, step, value)]`` — used by
    tests and available for offline inspection without TensorBoard."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "corrupt record header"
            data = f.read(length)
            (dcrc,) = struct.unpack("<I", f.read(4))
            assert dcrc == _masked_crc(data), "corrupt record payload"
            out.extend(_parse_event(data))
    return out


def _read_varint(buf: bytes, i: int):
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _iter_fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        else:  # pragma: no cover - unknown wire type
            raise ValueError(f"wire type {wire}")
        yield num, wire, val


def _parse_event(data: bytes):
    step = 0
    summary = None
    for num, _, val in _iter_fields(data):
        if num == 2:
            step = val
        elif num == 5:
            summary = val
    if summary is None:
        return []
    out = []
    for num, _, val in _iter_fields(summary):
        if num != 1:
            continue
        tag, simple = None, None
        for n2, _, v2 in _iter_fields(val):
            if n2 == 1:
                tag = v2.decode()
            elif n2 == 2:
                (simple,) = struct.unpack("<f", v2)
        if tag is not None and simple is not None:
            out.append((tag, step, simple))
    return out

"""Native TensorBoard scalar-event writer, standard library only.

A copy of lushnerf_tpu/utils/tb_writer.py.  The reference logs
training/eval scalars through tensorboardX (run_lushnerf.py:312, 776-780);
this module writes the TensorBoard on-disk format directly:
TFRecord-framed `Event` protobufs with masked CRC32C checksums.  Only the
scalar subset is implemented (all the reference uses); for the same wall
times it writes the JAX package's writer's bytes.

Wire format:
  record  = len(uint64 LE) . masked_crc32c(len) . data . masked_crc32c(data)
  Event   = {1: wall_time double, 2: step int64, 3: file_version string,
             5: Summary}
  Summary = {1: repeated Value{1: tag string, 2: simple_value float}}
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path
from typing import Optional

# CRC-32C (Castagnoli), table-driven — the checksum TFRecord uses.
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf wire encoding (varint / fixed / length-delimited) --


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


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _field_double(num: int, value: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def _field_bytes(num: int, value: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(value)) + value


def _event(wall_time: float, step: int = 0, file_version: str = "",
           summary: bytes = b"") -> bytes:
    msg = _field_double(1, wall_time)
    if step:
        msg += _field_varint(2, step)
    if file_version:
        msg += _field_bytes(3, file_version.encode())
    if summary:
        msg += _field_bytes(5, summary)
    return msg


class SummaryWriter:
    """Append-only scalar event file under `logdir` (TB-compatible)."""

    def __init__(self, logdir: str | Path):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        self._f = open(self.logdir / fname, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
        summary = _field_bytes(1, val)
        self._write(_event(wall_time if wall_time is not None else time.time(),
                           step=int(step), summary=summary))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""Minimal tensorboard event-file writer, dependency-free.

Capability parity with the reference's tensorboard training callback
(ultralytics/utils/callbacks/tensorboard.py:8-97: per-epoch scalar
summaries next to results.csv). Rather than importing the tensorboard
package into the training process, this writes the on-disk format directly —
TFRecord-framed `Event` protobufs with masked CRC32C — which any stock
TensorBoard reads. The proto subset needed (Event{wall_time,step,summary},
Summary{value{tag,simple_value}}) is tiny and hand-encoded below.

File format (TFRecord):
    uint64le  length
    uint32le  masked_crc32c(length bytes)
    bytes     data (a serialized Event proto)
    uint32le  masked_crc32c(data)
masked = ((crc >> 15 | crc << 17) + 0xa282ead8) mod 2^32, CRC32C (Castagnoli).

Verified against the installed tensorboard's EventFileLoader in
tests/test_tb_events.py.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

_CRC_TABLE = []


def _crc32c_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reversed
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire encoding (only what Event needs) --

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_delim(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _int64(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value: tag=1 (string), simple_value=2 (float)
    sval = _len_delim(1, tag.encode()) + _float(2, float(value))
    summary = _len_delim(1, sval)  # Summary.value = 1 (repeated)
    # Event: wall_time=1 (double), step=2 (int64), summary=5
    return _double(1, wall_time) + _int64(2, int(step)) + _len_delim(5, summary)


def _version_event(wall_time: float) -> bytes:
    # Event.file_version = 3 (string)
    return _double(1, wall_time) + _len_delim(3, b"brain.Event:2")


class EventWriter:
    """Append-only scalar-event writer: ``w.scalar('train/loss', 0.5, step)``.

    One events file per writer, named the tensorboard way
    (events.out.tfevents.<time>.<host>), created lazily on first write.
    """

    def __init__(self, log_dir: str | os.PathLike):
        self.log_dir = Path(log_dir)
        self._f = None

    def _file(self):
        if self._f is None:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            now = time.time()
            name = f"events.out.tfevents.{int(now)}.{socket.gethostname()}"
            self._f = open(self.log_dir / name, "ab")
            self._write_record(_version_event(now))
        return self._f

    def _write_record(self, data: bytes) -> None:
        f = self._file()
        hdr = struct.pack("<Q", len(data))
        f.write(hdr)
        f.write(struct.pack("<I", _masked_crc(hdr)))
        f.write(data)
        f.write(struct.pack("<I", _masked_crc(data)))

    def scalar(self, tag: str, value: float, step: int,
               wall_time: float | None = None) -> None:
        v = float(value)
        if v != v:  # skip NaN (unvalidated epochs) like the reference callback
            return
        self._write_record(_scalar_event(
            tag, v, step, time.time() if wall_time is None else wall_time))

    def scalars(self, values: dict, step: int) -> None:
        now = time.time()
        for tag, v in values.items():
            self.scalar(tag, v, step, now)

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""Minimal TensorBoard scalar writer, no TensorFlow dependency. A copy of
``variational_mmt_tpu/utils/tensorboard.py`` (pure Python).

The reference logs scalars to TensorBoard (SURVEY.md §5 metrics row); this
writes the same ``events.out.tfevents.*`` format natively: hand-encoded
Event/Summary protobufs inside TFRecord frames (length + masked CRC32C).
Only scalar summaries are supported — exactly what the training loop emits.

Wire format notes (stable, public):
- TFRecord frame: u64 LE length, u32 masked_crc(length), payload,
  u32 masked_crc(payload); masked = ((c >> 15 | c << 17) + 0xa282ead8).
- Event proto: 1=wall_time (double), 2=step (varint), 5=summary (msg);
  Summary: repeated 1=Value; Value: 1=tag (string), 2=simple_value (f32);
  first record carries 3=file_version "brain.Event:2".
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven
# ---------------------------------------------------------------------------
_POLY = 0x82F63B78
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _TABLE.append(_c)


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire encoding (just what Event/Summary need)
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


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, v: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3) + _varint(v)


def _event(step: int, scalars: Optional[Dict[str, float]] = None,
           file_version: Optional[str] = None) -> bytes:
    msg = _field_double(1, time.time())
    msg += _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _field_bytes(1, _field_bytes(1, tag.encode()) + _field_float(2, float(v)))
            for tag, v in scalars.items()
        )
        msg += _field_bytes(5, summary)
    return msg


class TensorBoardWriter:
    """Append-only scalar event writer. ``log_dir=None`` disables (no-op)."""

    def __init__(self, log_dir: Optional[str]):
        self._f = None
        if not log_dir:
            return
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(os.path.join(log_dir, name), "ab")
        self._write(_event(0, file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "") -> None:
        if self._f is None:
            return
        tagged = {(f"{prefix}/{k}" if prefix else k): v for k, v in scalars.items()}
        self._write(_event(step, tagged))
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def read_events(path: str):
    """Parse a tfevents file back into [(step, {tag: value})] — used by
    tests to round-trip-verify the wire format (frame CRCs included)."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (n,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "corrupt length crc"
            payload = f.read(n)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == _masked_crc(payload), "corrupt payload crc"
            out.append(_parse_event(payload))
    return out


def _read_varint(b: bytes, i: int):
    v, shift = 0, 0
    while True:
        v |= (b[i] & 0x7F) << shift
        i += 1
        if not b[i - 1] & 0x80:
            return v, i
        shift += 7


def _parse_event(b: bytes):
    i, step, scalars = 0, 0, {}
    while i < len(b):
        key, i = _read_varint(b, i)
        num, wt = key >> 3, key & 7
        if wt == 1:
            i += 8
        elif wt == 5:
            i += 4
        elif wt == 0:
            v, i = _read_varint(b, i)
            if num == 2:
                step = v
        elif wt == 2:
            n, i = _read_varint(b, i)
            if num == 5:
                scalars.update(_parse_summary(b[i:i + n]))
            i += n
    return step, scalars


def _parse_summary(b: bytes):
    i, out = 0, {}
    while i < len(b):
        key, i = _read_varint(b, i)
        n, i = _read_varint(b, i)
        val = b[i:i + n]
        i += n
        j, tag, sv = 0, None, None
        while j < len(val):
            k, j = _read_varint(val, j)
            num, wt = k >> 3, k & 7
            if wt == 2:
                ln, j = _read_varint(val, j)
                if num == 1:
                    tag = val[j:j + ln].decode()
                j += ln
            elif wt == 5:
                if num == 2:
                    (sv,) = struct.unpack("<f", val[j:j + 4])
                j += 4
            elif wt == 1:
                j += 8
            else:
                _, j = _read_varint(val, j)
        if tag is not None:
            out[tag] = sv
    return out

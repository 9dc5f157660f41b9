"""Minimal protobuf wire-format codec (proto2 semantics).

Implements just what the vlslam schema needs: varint, 64-bit, 32-bit and
length-delimited fields, with unpacked *and* packed repeated scalars
accepted on decode (proto2 writers emit unpacked; packed is legal input).

The decoder walks the buffer once and returns {field_number: [raw values]}
with wire-level types (int for varint, bytes for length-delimited, float
for fixed32/64); message-level typing lives in vlslam.py.

Hot repeated-scalar runs (e.g. EdgeMap.data: 480k floats/frame) are
decoded with numpy.frombuffer when a contiguous run of same-tag fixed-size
fields is detected, which makes Python ingest ~vectorized; the C++ native
decoder (visma_tpu/native) is the fast path for bulk ingest.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

WIRETYPE_VARINT = 0
WIRETYPE_FIXED64 = 1
WIRETYPE_LENGTH = 2
WIRETYPE_FIXED32 = 5


def write_varint(buf: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's complement, 10 bytes
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def write_tag(buf: bytearray, field: int, wiretype: int) -> None:
    write_varint(buf, (field << 3) | wiretype)


def write_double(buf: bytearray, field: int, v: float) -> None:
    write_tag(buf, field, WIRETYPE_FIXED64)
    buf += struct.pack("<d", v)


def write_float(buf: bytearray, field: int, v: float) -> None:
    write_tag(buf, field, WIRETYPE_FIXED32)
    buf += struct.pack("<f", v)


def write_int(buf: bytearray, field: int, v: int) -> None:
    write_tag(buf, field, WIRETYPE_VARINT)
    write_varint(buf, int(v))


def write_bytes(buf: bytearray, field: int, v: bytes) -> None:
    write_tag(buf, field, WIRETYPE_LENGTH)
    write_varint(buf, len(v))
    buf += v


def write_string(buf: bytearray, field: int, v: str) -> None:
    write_bytes(buf, field, v.encode("utf-8"))


def read_varint(data, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


_f64 = struct.Struct("<d")
_f32 = struct.Struct("<f")


def parse_fields(data: bytes) -> Dict[int, List]:
    """One-pass parse into {field_number: list of raw values}.

    Runs of consecutive identical fixed64/fixed32 tags (unpacked repeated
    doubles/floats — the dominant byte volume in vlslam files) are decoded
    in bulk with numpy stride tricks.
    """
    out: Dict[int, List] = {}
    mv = memoryview(data)
    n = len(data)
    pos = 0
    while pos < n:
        key, pos = read_varint(data, pos)
        field, wt = key >> 3, key & 7
        lst = out.setdefault(field, [])
        if wt == WIRETYPE_VARINT:
            v, pos = read_varint(data, pos)
            lst.append(v)
        elif wt == WIRETYPE_FIXED64:
            # bulk-decode a run of identical single-byte tags
            run = _run_length(data, pos, key, 8, n)
            if run > 1:
                arr = np.frombuffer(mv[pos - 1 : pos - 1 + run * 9], dtype=np.uint8)
                vals = arr.reshape(run, 9)[:, 1:].copy().view("<f8").ravel()
                lst.extend(vals.tolist())
                pos += run * 9 - 1
            else:
                lst.append(_f64.unpack_from(data, pos)[0])
                pos += 8
        elif wt == WIRETYPE_FIXED32:
            run = _run_length(data, pos, key, 4, n)
            if run > 1:
                arr = np.frombuffer(mv[pos - 1 : pos - 1 + run * 5], dtype=np.uint8)
                vals = arr.reshape(run, 5)[:, 1:].copy().view("<f4").ravel()
                lst.extend(vals.astype(np.float64).tolist())
                pos += run * 5 - 1
            else:
                lst.append(_f32.unpack_from(data, pos)[0])
                pos += 4
        elif wt == WIRETYPE_LENGTH:
            ln, pos = read_varint(data, pos)
            lst.append(bytes(mv[pos : pos + ln]))
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wt} for field {field}")
    return out


def _run_length(data, pos: int, key: int, width: int, n: int) -> int:
    """Count consecutive repeats of a single-byte tag `key` with fixed-width
    payloads, starting with the payload at `pos` (whose tag was consumed)."""
    if key > 0x7F:
        return 1
    count = 1
    p = pos + width
    while p < n and data[p] == key:
        count += 1
        p += 1 + width
    return count


# ---- typed readers used by vlslam.py ----

def as_doubles(vals: List) -> np.ndarray:
    """Repeated double: unpacked values and/or packed chunks (bytes)."""
    out: List[float] = []
    for v in vals:
        if isinstance(v, (bytes, bytearray)):
            out.extend(np.frombuffer(v, dtype="<f8").tolist())
        else:
            out.append(float(v))
    return np.asarray(out, dtype=np.float64)


def as_floats(vals: List) -> np.ndarray:
    out: List[float] = []
    for v in vals:
        if isinstance(v, (bytes, bytearray)):
            out.extend(np.frombuffer(v, dtype="<f4").tolist())
        else:
            out.append(float(v))
    return np.asarray(out, dtype=np.float32)


def as_ints(vals: List) -> List[int]:
    out: List[int] = []
    for v in vals:
        if isinstance(v, (bytes, bytearray)):
            pos = 0
            while pos < len(v):
                x, pos = read_varint(v, pos)
                out.append(x)
        else:
            out.append(int(v))
    return out


def to_signed(v: int, bits: int = 64) -> int:
    """proto int32/int64 are encoded as two's-complement varints."""
    if v >= (1 << (bits - 1)):
        v -= 1 << bits
    return v

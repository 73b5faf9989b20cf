"""Byte-level codecs: varint, delta-encoded id lists, RLE.

Parity with tensor_compress's id/RLE codecs (tensor_compress/src/
{decompose,format}.rs capability). Pure-Python here; the hot framing
moves to the C++ native module (neumann_native) which implements the
same formats — these stay as the portable fallback and spec.

The port's copy of ``neumann_tpu/compress/codecs.py``: only its import
lines differ.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def varint_encode(values: Sequence[int]) -> bytes:
    out = bytearray()
    for v in values:
        if v < 0:
            raise ValueError("varint encodes unsigned ints")
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
    return bytes(out)


def varint_decode(buf: bytes) -> List[int]:
    out: List[int] = []
    cur = 0
    shift = 0
    for b in buf:
        cur |= (b & 0x7F) << shift
        if b & 0x80:
            shift += 7
        else:
            out.append(cur)
            cur = 0
            shift = 0
    if shift:
        raise ValueError("truncated varint stream")
    return out


def delta_encode_ids(ids: Sequence[int]) -> bytes:
    """Sorted id list -> delta + varint bytes (4-6x smaller for dense ids)."""
    prev = 0
    deltas = []
    for i in ids:
        if i < prev:
            raise ValueError("ids must be sorted ascending")
        deltas.append(i - prev)
        prev = i
    return varint_encode(deltas)


def delta_decode_ids(buf: bytes) -> List[int]:
    out = []
    cur = 0
    for d in varint_decode(buf):
        cur += d
        out.append(cur)
    return out


def rle_encode(data: bytes) -> bytes:
    """Simple byte RLE: [count u8][byte] pairs, runs capped at 255."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        run = 1
        while i + run < n and data[i + run] == b and run < 255:
            run += 1
        out.append(run)
        out.append(b)
        i += run
    return bytes(out)


def rle_decode(buf: bytes) -> bytes:
    if len(buf) % 2:
        raise ValueError("truncated RLE stream")
    out = bytearray()
    for i in range(0, len(buf), 2):
        out += bytes([buf[i + 1]]) * buf[i]
    return bytes(out)

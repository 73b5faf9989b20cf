"""Binary codec for TensorData / TensorValue.

Compact tagged binary format shared by the WAL and snapshots (the reference
uses bincode; formats need not match). Little-endian throughout.

Value encoding:
  tag u8:
    0 scalar-null   1 scalar-bool   2 scalar-int    3 scalar-float
    4 scalar-str    5 scalar-bytes  6 vector        7 sparse
    8 pointer       9 pointers

The port's copy of ``neumann_tpu/store/codec.py``:
only its import lines differ.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

from neumann_tpu_torch.store.sparse import SparseVector
from neumann_tpu_torch.store.tensor_store import TensorData, TensorValue
from neumann_tpu_torch.utils.errors import StoreError

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


def _native():
    """The C codec extension, or None (pure-Python fallback below).

    Both produce the identical byte format; the extension is ~4-7x
    faster on the per-record paths (WAL append/replay, snapshots)."""
    from neumann_tpu_torch.native import pycodec

    return pycodec.load()


def _pack_bytes(out: bytearray, b: bytes) -> None:
    out += _U32.pack(len(b))
    out += b


def _pack_str(out: bytearray, s: str) -> None:
    _pack_bytes(out, s.encode("utf-8"))


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise StoreError("truncated record")
        b = self.buf[self.pos: self.pos + n]
        self.pos += n
        return b

    # fixed-size reads use unpack_from at pos (no slice allocation);
    # bounds are checked explicitly so malformed input stays StoreError
    def u8(self) -> int:
        pos = self.pos
        if pos >= len(self.buf):
            raise StoreError("truncated record")
        self.pos = pos + 1
        return self.buf[pos]

    def u32(self) -> int:
        pos = self.pos
        if pos + 4 > len(self.buf):
            raise StoreError("truncated record")
        self.pos = pos + 4
        return _U32.unpack_from(self.buf, pos)[0]

    def i64(self) -> int:
        pos = self.pos
        if pos + 8 > len(self.buf):
            raise StoreError("truncated record")
        self.pos = pos + 8
        return _I64.unpack_from(self.buf, pos)[0]

    def f64(self) -> float:
        pos = self.pos
        if pos + 8 > len(self.buf):
            raise StoreError("truncated record")
        self.pos = pos + 8
        return _F64.unpack_from(self.buf, pos)[0]

    def bytes_(self) -> bytes:
        return self.take(self.u32())

    def str_(self) -> str:
        return self.bytes_().decode("utf-8")


def encode_value(out: bytearray, v: TensorValue) -> None:
    if v.kind == "scalar":
        s = v.value
        if s is None:
            out.append(0)
        elif isinstance(s, bool):
            out.append(1)
            out.append(1 if s else 0)
        elif isinstance(s, int):
            out.append(2)
            out += _I64.pack(s)
        elif isinstance(s, float):
            out.append(3)
            out += _F64.pack(s)
        elif isinstance(s, str):
            out.append(4)
            _pack_str(out, s)
        elif isinstance(s, bytes):
            out.append(5)
            _pack_bytes(out, s)
        else:
            raise StoreError(f"unencodable scalar type {type(s)}")
    elif v.kind == "vector":
        out.append(6)
        arr = np.asarray(v.value, dtype="<f4")
        _pack_bytes(out, arr.tobytes())
    elif v.kind == "sparse":
        out.append(7)
        sv: SparseVector = v.value
        out += _U32.pack(sv.dim)
        _pack_bytes(out, np.asarray(sv.positions, "<i4").tobytes())
        _pack_bytes(out, np.asarray(sv.values, "<f4").tobytes())
    elif v.kind == "pointer":
        out.append(8)
        _pack_str(out, v.value)
    elif v.kind == "pointers":
        out.append(9)
        out += _U32.pack(len(v.value))
        for p in v.value:
            _pack_str(out, p)
    else:
        raise StoreError(f"unencodable value kind {v.kind}")


def decode_value(r: _Reader) -> TensorValue:
    tag = r.u8()
    if tag == 0:
        return TensorValue.scalar(None)
    if tag == 1:
        return TensorValue.scalar(bool(r.u8()))
    if tag == 2:
        return TensorValue.scalar(r.i64())
    if tag == 3:
        return TensorValue.scalar(r.f64())
    if tag == 4:
        return TensorValue.scalar(r.str_())
    if tag == 5:
        return TensorValue.scalar(r.bytes_())
    if tag == 6:
        return TensorValue.vector(np.frombuffer(r.bytes_(), "<f4").copy())
    if tag == 7:
        dim = r.u32()
        pos = np.frombuffer(r.bytes_(), "<i4").copy()
        vals = np.frombuffer(r.bytes_(), "<f4").copy()
        return TensorValue.sparse(SparseVector(pos, vals, dim))
    if tag == 8:
        return TensorValue.pointer(r.str_())
    if tag == 9:
        n = r.u32()
        return TensorValue.pointers([r.str_() for _ in range(n)])
    raise StoreError(f"bad value tag {tag}")


def encode_data(data: TensorData) -> bytes:
    ext = _native()
    if ext is not None:
        try:
            return ext.encode_data(data)
        except (ValueError, OverflowError, TypeError) as e:
            raise StoreError(str(e)) from None
    out = bytearray()
    out += _U32.pack(len(data.fields))
    for name, value in data.fields.items():
        _pack_str(out, name)
        encode_value(out, value)
    return bytes(out)


def decode_data(buf: bytes, pos: int = 0) -> TensorData:
    ext = _native()
    if ext is not None:
        try:
            return ext.decode_data(buf, pos)
        except ValueError as e:
            raise StoreError(str(e)) from None
    r = _Reader(buf, pos)
    n = r.u32()
    td = TensorData()
    for _ in range(n):
        name = r.str_()
        td.set(name, decode_value(r))
    return td

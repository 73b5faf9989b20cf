"""Point-in-time snapshots of the tensor store.

Parity with tensor_store/src/snapshot.rs: magic + version header, atomic
tmp+rename write, CRC-checked body. Format "NTPU" v1.

The port's copy of ``neumann_tpu/store/snapshot.py``:
only its import lines differ.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict

from neumann_tpu_torch.store import codec
from neumann_tpu_torch.store.tensor_store import TensorData
from neumann_tpu_torch.utils.errors import StoreError

MAGIC = b"NTPU"
MAGIC_Z = b"NTPZ"   # zlib-compressed wrapper around an NTPU snapshot
VERSION = 1
_HDR = struct.Struct("<4sII")  # magic, version, count


def dumps(entries: Dict[str, TensorData],
          compressed: bool = False) -> bytes:
    """Serialize a store map to snapshot bytes (no file involved)."""
    ext = codec._native()
    if ext is not None:
        try:
            body = ext.encode_snapshot_body(list(entries.items()))
        except (ValueError, OverflowError, TypeError) as e:
            raise StoreError(str(e)) from None
    else:
        body = bytearray()
        for key, data in entries.items():
            kb = key.encode("utf-8")
            body += struct.pack("<I", len(kb))
            body += kb
            payload = codec.encode_data(data)
            body += struct.pack("<I", len(payload))
            body += payload
    blob = _HDR.pack(MAGIC, VERSION, len(entries)) + struct.pack(
        "<I", zlib.crc32(bytes(body))) + bytes(body)
    if compressed:
        blob = MAGIC_Z + zlib.compress(blob, level=6)
    return blob


def save(entries: Dict[str, TensorData], path,
         compressed: bool = False) -> None:
    path = os.fspath(path)
    blob = dumps(entries, compressed=compressed)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as fh:
        fh.write(blob)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def load(path) -> Dict[str, TensorData]:
    path = os.fspath(path)
    with open(path, "rb") as fh:
        return loads(fh.read())


def loads(buf: bytes) -> Dict[str, TensorData]:
    """Deserialize snapshot bytes produced by dumps()."""
    if buf[:4] == MAGIC_Z:
        try:
            buf = zlib.decompress(buf[4:])
        except zlib.error as e:
            raise StoreError(f"corrupt compressed snapshot: {e}") \
                from None
    if len(buf) < _HDR.size + 4:
        raise StoreError("snapshot truncated")
    magic, version, count = _HDR.unpack_from(buf, 0)
    if magic != MAGIC:
        raise StoreError("bad snapshot magic")
    if version != VERSION:
        raise StoreError(f"unsupported snapshot version {version}")
    (crc,) = struct.unpack_from("<I", buf, _HDR.size)
    body = buf[_HDR.size + 4:]
    if zlib.crc32(body) != crc:
        raise StoreError("snapshot checksum mismatch")
    ext = codec._native()
    if ext is not None and hasattr(ext, "snapshot_lazy"):
        from neumann_tpu_torch.store.tensor_store import LazyTensorData

        try:
            # records decode on first access (promote-on-read): load
            # becomes a structure pass + slot-only wrappers
            return ext.snapshot_lazy(body, count, LazyTensorData)
        except ValueError as e:
            raise StoreError(f"corrupt snapshot: {e}") from None
    if ext is not None:
        try:
            return ext.decode_snapshot_body(body, count)
        except ValueError as e:
            raise StoreError(f"corrupt snapshot: {e}") from None
    out: Dict[str, TensorData] = {}
    pos = 0
    # `count` sits in the header OUTSIDE the CRC-covered body, so it
    # must be validated structurally like everything it gates
    try:
        for _ in range(count):
            if pos + 4 > len(body):
                raise StoreError("snapshot truncated (count)")
            (klen,) = struct.unpack_from("<I", body, pos)
            pos += 4
            if pos + klen > len(body):
                raise StoreError("snapshot truncated (key)")
            key = body[pos: pos + klen].decode("utf-8", "replace")
            pos += klen
            if pos + 4 > len(body):
                raise StoreError("snapshot truncated (len)")
            (plen,) = struct.unpack_from("<I", body, pos)
            pos += 4
            if pos + plen > len(body):
                raise StoreError("snapshot truncated (payload)")
            out[key] = codec.decode_data(body[pos: pos + plen])
            pos += plen
    except struct.error as e:
        raise StoreError(f"corrupt snapshot: {e}") from None
    return out

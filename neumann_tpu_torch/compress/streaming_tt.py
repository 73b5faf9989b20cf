"""Streaming TT file format: append/iterate TT-compressed vectors.

Parity with tensor_compress's streaming TT format (streaming_tt.rs):
write TT-compressed embeddings to a file incrementally (bounded memory
regardless of corpus size) and stream them back without loading the
whole file. Used for archiving large embedding collections at the TT
compression ratio (10-20x on structured 1024d+ vectors).

Format "NTTS" v1, little-endian:

  header:  magic 'NTTS' | u16 version | u32 dim
  record:  u32 key_len | key utf-8 | u8 n_cores
           per core: u16 r_left | u16 mode | u16 r_right | f32 data
           u32 crc32 of the record body (torn/corrupt tails stop the
           stream, like the WAL)

Appending re-opens in 'ab'; readers stop cleanly at the first
corrupt/torn record.

The port's copy of ``neumann_tpu/compress/streaming_tt.py``: only its import
lines differ.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

from neumann_tpu_torch.compress.tensor_train import (
    TTConfig,
    TTVector,
    tt_decompose,
    tt_reconstruct,
)
from neumann_tpu_torch.utils.errors import NeumannError

MAGIC = b"NTTS"
VERSION = 1
_HDR = struct.Struct("<4sHI")
_CORE = struct.Struct("<HHH")


class StreamingTTWriter:
    """Append TT-compressed vectors to a file, one record at a time."""

    def __init__(self, path, dim: int,
                 config: Optional[TTConfig] = None):
        self.path = os.fspath(path)
        self.dim = dim
        self.config = config or TTConfig.for_dim(dim)
        exists = os.path.exists(self.path) and \
            os.path.getsize(self.path) >= _HDR.size
        if exists:
            with open(self.path, "rb") as f:
                magic, version, fdim = _HDR.unpack(f.read(_HDR.size))
            if magic != MAGIC:
                raise NeumannError(f"{self.path} is not an NTTS file")
            if fdim != dim:
                raise NeumannError(
                    f"dimension mismatch: file {fdim}, writer {dim}")
        self._fh = open(self.path, "ab")
        if not exists:
            self._fh.write(_HDR.pack(MAGIC, VERSION, dim))
        self.written = 0

    def add(self, key: str, vector) -> TTVector:
        """TT-compress and append one vector; returns the TT form."""
        vec = np.asarray(vector, np.float32)
        if vec.shape != (self.dim,):
            raise NeumannError(
                f"expected dim-{self.dim} vector, got {vec.shape}")
        tt = tt_decompose(vec, self.config)
        self.add_tt(key, tt)
        return tt

    def add_tt(self, key: str, tt: TTVector) -> None:
        kb = key.encode("utf-8")
        body = bytearray(struct.pack("<I", len(kb)))
        body += kb
        body.append(len(tt.cores))
        for core in tt.cores:
            r1, m, r2 = core.shape
            body += _CORE.pack(r1, m, r2)
            body += np.ascontiguousarray(core, "<f4").tobytes()
        self._fh.write(bytes(body)
                       + struct.pack("<I", zlib.crc32(bytes(body))))
        self.written += 1

    def flush(self) -> None:
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        self._fh.flush()
        self._fh.close()

    def __enter__(self) -> "StreamingTTWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def stream_tt(path) -> Iterator[Tuple[str, TTVector]]:
    """Yield (key, TTVector) records; stops at the first corrupt or
    torn record (crash-safe tail semantics, like WAL replay)."""
    path = os.fspath(path)
    with open(path, "rb") as f:
        hdr = f.read(_HDR.size)
        if len(hdr) < _HDR.size:
            return
        magic, version, dim = _HDR.unpack(hdr)
        if magic != MAGIC:
            raise NeumannError(f"{path} is not an NTTS file")
        while True:
            lenb = f.read(4)
            if len(lenb) < 4:
                return
            (klen,) = struct.unpack("<I", lenb)
            if klen > 1 << 20:
                return                       # corrupt length
            rest = f.read(klen + 1)
            if len(rest) < klen + 1:
                return                       # torn tail
            key = rest[:klen].decode("utf-8", "replace")
            n_cores = rest[klen]
            body = bytearray(lenb) + rest
            cores = []
            ok = True
            for _ in range(n_cores):
                shp = f.read(_CORE.size)
                if len(shp) < _CORE.size:
                    return
                r1, m, r2 = _CORE.unpack(shp)
                if r1 * m * r2 > (1 << 24):
                    return           # corrupt shape: would demand GBs
                data = f.read(4 * r1 * m * r2)
                if len(data) < 4 * r1 * m * r2:
                    return
                body += shp
                body += data
                if not ok:
                    continue
                cores.append(np.frombuffer(data, "<f4").reshape(
                    r1, m, r2).copy())
            crcb = f.read(4)
            if len(crcb) < 4:
                return
            (crc,) = struct.unpack("<I", crcb)
            if zlib.crc32(bytes(body)) != crc:
                return                       # corruption: stop stream
            yield key, TTVector(cores=cores, dim=dim)


def stream_dense(path) -> Iterator[Tuple[str, np.ndarray]]:
    """Like stream_tt but reconstructs each vector to dense."""
    for key, tt in stream_tt(path):
        yield key, np.asarray(tt_reconstruct(tt), np.float32)

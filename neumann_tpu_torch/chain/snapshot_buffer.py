"""Adaptive memory/disk buffer for snapshot assembly with bounded memory.

Parity with tensor_chain/src/snapshot_buffer.rs: snapshot bytes
accumulate in memory until a configurable threshold, then transparently
spill to a temp file served through mmap (zero-copy slices); SHA-256 is
computed incrementally during writes; temp files are removed on cleanup
(and by the finalizer). `SnapshotReceiver` (snapshot_streaming.py) uses
it so a multi-GB install_snapshot never holds the whole blob on the
Python heap during the receive window.

The port's copy of ``neumann_tpu/chain/snapshot_buffer.py``:
only its import lines differ.
"""
from __future__ import annotations

import hashlib
import mmap
import os
import tempfile
import uuid
from dataclasses import dataclass
from typing import Iterator, Optional

from neumann_tpu_torch.utils.errors import ChainError

DEFAULT_MEMORY_THRESHOLD = 64 * 1024 * 1024


@dataclass
class SnapshotBufferConfig:
    memory_threshold: int = DEFAULT_MEMORY_THRESHOLD
    temp_dir: Optional[str] = None


class SnapshotBuffer:
    """Write-then-serve buffer: memory mode below the threshold, mmap'd
    temp file above it (snapshot_buffer.rs:239-516)."""

    def __init__(self, config: Optional[SnapshotBufferConfig] = None):
        self.config = config or SnapshotBufferConfig()
        self._mem: Optional[bytearray] = bytearray()
        self._file = None
        self._path: Optional[str] = None
        self._mmap: Optional[mmap.mmap] = None
        self._hasher = hashlib.sha256()
        self._size = 0
        self._finalized = False

    # -- write side ------------------------------------------------------------

    def write(self, data: bytes) -> None:
        if self._finalized:
            raise ChainError("snapshot buffer already finalized")
        self._hasher.update(data)
        self._size += len(data)
        if self._mem is not None:
            self._mem.extend(data)
            if self._size > self.config.memory_threshold:
                self._spill()
        else:
            self._file.write(data)

    def _spill(self) -> None:
        fd, path = tempfile.mkstemp(
            prefix=f"snapbuf-{uuid.uuid4().hex[:8]}-", suffix=".tmp",
            dir=self.config.temp_dir)
        self._file = os.fdopen(fd, "wb")
        self._path = path
        self._file.write(self._mem)
        self._mem = None

    def finalize(self) -> None:
        """Freeze the buffer for serving; fsyncs and mmaps file mode."""
        if self._finalized:
            return
        self._finalized = True
        if self._file is not None:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()
            self._file = None
            if self._size:
                with open(self._path, "rb") as fh:
                    self._mmap = mmap.mmap(fh.fileno(), 0,
                                           access=mmap.ACCESS_READ)

    # -- read side ---------------------------------------------------------------

    @property
    def size(self) -> int:
        return self._size

    @property
    def spilled(self) -> bool:
        return self._mem is None

    def temp_path(self) -> Optional[str]:
        return self._path

    def hash(self) -> bytes:
        return self._hasher.digest()

    def hash_hex(self) -> str:
        return self._hasher.hexdigest()

    def _backing(self):
        if not self._finalized:
            raise ChainError("finalize() the buffer before reading")
        return self._mem if self._mem is not None else self._mmap

    def as_slice(self, offset: int, length: int) -> memoryview:
        """Zero-copy view of [offset, offset+length)."""
        if offset < 0 or offset + length > self._size:
            raise ChainError("snapshot buffer slice out of bounds")
        backing = self._backing()
        if backing is None:
            return memoryview(b"")
        return memoryview(backing)[offset: offset + length]

    def as_bytes(self) -> memoryview:
        return self.as_slice(0, self._size)

    def read_chunk(self, offset: int, length: int) -> bytes:
        length = min(length, self._size - offset)
        return bytes(self.as_slice(offset, max(length, 0)))

    def chunks(self, chunk_size: int, resume_from: int = 0
               ) -> Iterator[bytes]:
        for off in range(resume_from, self._size, chunk_size):
            yield self.read_chunk(off, chunk_size)

    # -- lifecycle ----------------------------------------------------------------

    def cleanup(self) -> None:
        if self._mmap is not None:
            self._mmap.close()
            self._mmap = None
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._path is not None:
            try:
                os.unlink(self._path)
            except OSError:
                pass
            self._path = None
        self._mem = None

    def __enter__(self) -> "SnapshotBuffer":
        return self

    def __exit__(self, *exc) -> None:
        self.cleanup()

    def __del__(self):  # best-effort temp-file removal (Rust Drop analog)
        try:
            self.cleanup()
        except Exception:
            pass

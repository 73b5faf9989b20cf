"""Chunked snapshot transfer with SHA-256 validation.

Parity with tensor_chain/src/snapshot_streaming.rs: a large state
snapshot streams to a lagging follower as fixed-size chunks, each
carrying (offset, total, chunk-digest); the receiver reassembles,
verifies the whole-snapshot SHA-256 before applying, and can resume
from the last contiguous offset after an interruption.

The port's copy of ``neumann_tpu/chain/snapshot_streaming.py``:
only its import lines differ.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from neumann_tpu_torch.utils.errors import ChainError

CHUNK = 256 * 1024


@dataclass
class SnapshotChunk:
    snapshot_id: str
    offset: int
    total: int
    sha256: str           # digest of the WHOLE snapshot
    data: bytes

    def to_payload(self) -> dict:
        return {"id": self.snapshot_id, "offset": self.offset,
                "total": self.total, "sha256": self.sha256,
                "data": self.data.hex()}

    @staticmethod
    def from_payload(p: dict) -> "SnapshotChunk":
        return SnapshotChunk(p["id"], p["offset"], p["total"],
                             p["sha256"], bytes.fromhex(p["data"]))


def stream_snapshot(snapshot_id: str, blob: bytes,
                    chunk_size: int = CHUNK,
                    resume_from: int = 0) -> Iterator[SnapshotChunk]:
    digest = hashlib.sha256(blob).hexdigest()
    for off in range(resume_from, max(len(blob), 1), chunk_size):
        yield SnapshotChunk(snapshot_id, off, len(blob), digest,
                            blob[off: off + chunk_size])


def stream_snapshot_buffer(snapshot_id: str, buf,
                           chunk_size: int = CHUNK,
                           resume_from: int = 0
                           ) -> Iterator[SnapshotChunk]:
    """Stream from a finalized chain.snapshot_buffer.SnapshotBuffer:
    chunks are mmap reads and the digest is the buffer's incremental
    SHA-256 — the sender never materializes the whole blob either."""
    digest = buf.hash_hex()
    for off in range(resume_from, max(buf.size, 1), chunk_size):
        yield SnapshotChunk(snapshot_id, off, buf.size, digest,
                            buf.read_chunk(off, chunk_size))


class SnapshotReceiver:
    """Reassembles streamed chunks. Snapshots whose declared total
    exceeds ``memory_threshold`` assemble through a disk-spilling
    SnapshotBuffer (chain/snapshot_buffer.py — the reference's
    snapshot_buffer.rs) with an INCREMENTAL whole-stream SHA-256, so the
    receive window never holds a multi-GB blob on the heap; small ones
    keep the in-memory out-of-order-tolerant path."""

    def __init__(self, memory_threshold: Optional[int] = None):
        from neumann_tpu_torch.chain.snapshot_buffer import \
            DEFAULT_MEMORY_THRESHOLD

        self.memory_threshold = (DEFAULT_MEMORY_THRESHOLD
                                 if memory_threshold is None
                                 else memory_threshold)
        self._buffers: Dict[str, bytearray] = {}
        self._spill: Dict[str, object] = {}
        self._meta: Dict[str, dict] = {}

    def receive(self, chunk: SnapshotChunk) -> Optional[bytes]:
        """Feed a chunk; returns the verified snapshot when complete."""
        meta = self._meta.get(chunk.snapshot_id)
        if meta is None:
            meta = {"total": chunk.total, "sha256": chunk.sha256,
                    "received": 0}
            self._meta[chunk.snapshot_id] = meta
            if chunk.total > self.memory_threshold:
                from neumann_tpu_torch.chain.snapshot_buffer import (
                    SnapshotBuffer, SnapshotBufferConfig)
                self._spill[chunk.snapshot_id] = SnapshotBuffer(
                    SnapshotBufferConfig(
                        memory_threshold=self.memory_threshold))
            else:
                self._buffers[chunk.snapshot_id] = bytearray(chunk.total)
        if chunk.total != meta["total"] or chunk.sha256 != meta["sha256"]:
            raise ChainError("snapshot metadata changed mid-stream")
        end = chunk.offset + len(chunk.data)
        if end > meta["total"]:
            raise ChainError("snapshot chunk out of bounds")
        spill = self._spill.get(chunk.snapshot_id)
        if spill is not None:
            # disk-spill assembly is sequential (the stream is ordered;
            # resume re-sends from the last contiguous offset) — append
            # only the unseen suffix of this chunk
            if chunk.offset > meta["received"]:
                raise ChainError("snapshot chunk gap in spilled stream")
            skip = meta["received"] - chunk.offset
            if skip < len(chunk.data):
                spill.write(bytes(chunk.data[skip:]))
            meta["received"] = max(meta["received"], end)
            if meta["received"] >= meta["total"]:
                spill.finalize()
                if spill.hash_hex() != meta["sha256"]:
                    self.abort(chunk.snapshot_id)
                    raise ChainError("snapshot SHA-256 mismatch")
                blob = bytes(spill.as_bytes())
                self.abort(chunk.snapshot_id)
                return blob
            return None
        buf = self._buffers[chunk.snapshot_id]
        buf[chunk.offset: end] = chunk.data
        meta["received"] = max(meta["received"], end)
        if meta["received"] >= meta["total"]:
            blob = bytes(buf)
            if hashlib.sha256(blob).hexdigest() != meta["sha256"]:
                self.abort(chunk.snapshot_id)
                raise ChainError("snapshot SHA-256 mismatch")
            self.abort(chunk.snapshot_id)  # clear buffers
            return blob
        return None

    def resume_offset(self, snapshot_id: str) -> int:
        """Next offset to request after an interruption."""
        meta = self._meta.get(snapshot_id)
        return meta["received"] if meta else 0

    def abort(self, snapshot_id: str) -> None:
        self._buffers.pop(snapshot_id, None)
        spill = self._spill.pop(snapshot_id, None)
        if spill is not None:
            spill.cleanup()
        self._meta.pop(snapshot_id, None)

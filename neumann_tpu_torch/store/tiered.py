"""Tiered storage: hot in-memory map / cold mmap segments.

Parity with tensor_store/src/{tiered,mmap}.rs: access-tracked hot tier,
explicit cold migration of least-recently-used entries into an
append-only mmap'd segment file (codec-serialized), promotion back to hot
on read, preload, and tier statistics. Sampled access counters mirror
instrumentation.rs.

The port's copy of ``neumann_tpu/store/tiered.py``: only its import
lines differ.
"""

from __future__ import annotations

import mmap
import os
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from neumann_tpu_torch.store import codec
from neumann_tpu_torch.store.tensor_store import TensorData
from neumann_tpu_torch.utils.errors import StoreError

_SEG_HDR = struct.Struct("<I")  # payload length


class _ColdSegment:
    """Append-only codec-serialized records in an mmap'd file."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path):
            with open(path, "wb") as fh:
                fh.write(b"")
        self._fh = open(path, "r+b")
        self._size = os.path.getsize(path)
        self._mm: Optional[mmap.mmap] = None
        self._remap()

    def _remap(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self._size > 0:
            self._mm = mmap.mmap(self._fh.fileno(), self._size,
                                 access=mmap.ACCESS_READ)

    def append(self, payload: bytes) -> Tuple[int, int]:
        self._fh.seek(0, os.SEEK_END)
        offset = self._fh.tell() + _SEG_HDR.size
        self._fh.write(_SEG_HDR.pack(len(payload)))
        self._fh.write(payload)
        self._fh.flush()
        self._size = self._fh.tell()
        self._remap()
        return offset, len(payload)

    def read(self, offset: int, length: int) -> bytes:
        if self._mm is None or offset + length > self._size:
            raise StoreError("cold segment read out of bounds")
        return self._mm[offset: offset + length]

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
        self._fh.close()


class TieredStore:
    def __init__(self, directory: str, sample_rate: int = 1):
        self.dir = os.fspath(directory)
        self._hot: Dict[str, TensorData] = {}
        self._cold_index: Dict[str, Tuple[int, int]] = {}
        self._segment = _ColdSegment(os.path.join(self.dir, "cold.seg"))
        self._access: Dict[str, Tuple[int, float]] = {}  # key->(count, ts)
        self._sample_rate = max(1, sample_rate)
        self._op_counter = 0
        self._lock = threading.RLock()

    # -- core ------------------------------------------------------------
    def _track(self, key: str) -> None:
        self._op_counter += 1
        if self._op_counter % self._sample_rate:
            return
        count, _ = self._access.get(key, (0, 0.0))
        self._access[key] = (count + 1, time.monotonic())

    def put(self, key: str, data: TensorData) -> None:
        with self._lock:
            self._hot[key] = data
            self._cold_index.pop(key, None)
            self._track(key)

    def get(self, key: str) -> Optional[TensorData]:
        with self._lock:
            self._track(key)
            data = self._hot.get(key)
            if data is not None:
                return data
            loc = self._cold_index.get(key)
            if loc is None:
                return None
            payload = self._segment.read(*loc)
            data = codec.decode_data(payload)
            # promotion on read
            self._hot[key] = data
            del self._cold_index[key]
            return data

    def delete(self, key: str) -> bool:
        with self._lock:
            a = self._hot.pop(key, None) is not None
            b = self._cold_index.pop(key, None) is not None
            return a or b

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._hot or key in self._cold_index

    def __len__(self) -> int:
        with self._lock:
            return len(self._hot) + len(self._cold_index)

    # -- tiering -----------------------------------------------------------
    def migrate_cold(self, max_items: Optional[int] = None,
                     min_idle_s: float = 0.0) -> int:
        """Demote the least-recently-accessed hot entries to the cold
        segment. Returns the number migrated."""
        with self._lock:
            now = time.monotonic()
            candidates = []
            for key in self._hot:
                count, ts = self._access.get(key, (0, 0.0))
                if now - ts >= min_idle_s:
                    candidates.append((count, ts, key))
            candidates.sort()
            if max_items is not None:
                candidates = candidates[:max_items]
            n = 0
            for _, _, key in candidates:
                payload = codec.encode_data(self._hot[key])
                self._cold_index[key] = self._segment.append(payload)
                del self._hot[key]
                n += 1
            return n

    def preload(self, keys: List[str]) -> int:
        """Promote cold keys to hot ahead of access."""
        n = 0
        with self._lock:
            for key in keys:
                loc = self._cold_index.get(key)
                if loc is None:
                    continue
                self._hot[key] = codec.decode_data(
                    self._segment.read(*loc))
                del self._cold_index[key]
                n += 1
        return n

    def stats(self) -> dict:
        with self._lock:
            return {"hot": len(self._hot), "cold": len(self._cold_index),
                    "cold_bytes": self._segment._size}

    @staticmethod
    def _shard_of(key: str) -> int:
        return hash(key) & 15

    def hot_shards(self, limit: int = 16):
        """Most-accessed shards as (shard, access_count), descending
        (tiered.rs hot_shards: sampled instrumentation rollup)."""
        with self._lock:
            counts = [0] * 16
            for key, (count, _ts) in self._access.items():
                counts[self._shard_of(key)] += count
        ranked = sorted(enumerate(counts), key=lambda kv: -kv[1])
        return [(s, c) for s, c in ranked[:limit] if c > 0]

    def cold_shards(self, threshold_s: float):
        """Shards with no access within the threshold (tiered.rs
        cold_shards) — candidates for migrate_cold."""
        import time as _time

        now = _time.monotonic()
        with self._lock:
            latest = [None] * 16
            for key, (_count, ts) in self._access.items():
                s = self._shard_of(key)
                if latest[s] is None or ts > latest[s]:
                    latest[s] = ts
        return [s for s, ts in enumerate(latest)
                if ts is None or now - ts > threshold_s]

    def compact(self) -> None:
        """Rewrite the cold segment dropping dead space."""
        with self._lock:
            live = {k: self._segment.read(*loc)
                    for k, loc in self._cold_index.items()}
            self._segment.close()
            os.remove(self._segment.path)
            self._segment = _ColdSegment(self._segment.path)
            self._cold_index = {
                k: self._segment.append(p) for k, p in live.items()}

    def close(self) -> None:
        self._segment.close()

"""Host-side tensor store: the unified KV layer.

Capability parity with tensor_store::TensorStore
(tensor_store/src/lib.rs:209-1482): `type:id` string keys, a tagged value
model (scalar / dense vector / sparse vector / pointer / pointers), prefix
scan, snapshots, and WAL-backed durability. The Rust version shards a
DashMap and prefix-routes to columnar slabs; here the hot numeric paths
(embeddings, columns, adjacency) live in device-backed slabs owned by the
engines, and this store holds the authoritative host view plus all metadata.

The port's copy of ``neumann_tpu/store/tensor_store.py``: its import
lines differ, and ``recover`` with put hooks registered also runs the
delete hooks for every key the WAL deletes after the snapshot loaded it
(the original drops such keys from the map only, so engines rebuilt
from the snapshot kept them).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np

from neumann_tpu_torch.store.sparse import (
    DEFAULT_SPARSITY_THRESHOLD,
    DEFAULT_VALUE_THRESHOLD,
    SparseVector,
)
from neumann_tpu_torch.utils.errors import StoreError

ScalarValue = Union[None, bool, int, float, str, bytes]

# native fast constructor for scalar TensorValues (codec extension);
# resolved lazily to avoid a circular import with native.pycodec
_fast_scalar = None
_fast_scalar_tried = False


def _get_fast_scalar():
    global _fast_scalar, _fast_scalar_tried
    if not _fast_scalar_tried:
        _fast_scalar_tried = True
        try:
            from neumann_tpu_torch.native import pycodec

            m = pycodec.load()
            if m is not None:
                _fast_scalar = m.make_scalar
        except Exception:
            pass
    return _fast_scalar


@dataclass(frozen=True, slots=True)
class TensorValue:
    """Tagged union matching TensorValue (tensor_store/src/lib.rs:324-338).

    slots=True: a store holds one of these per field per entity, so the
    56-byte instance dict per value is real memory at 1M+ rows, and
    slot construction is measurably faster on every put/decode path."""

    kind: str  # "scalar" | "vector" | "sparse" | "pointer" | "pointers"
    value: object

    # -- constructors ---------------------------------------------------
    @staticmethod
    def scalar(v: ScalarValue) -> "TensorValue":
        f = _fast_scalar or _get_fast_scalar()
        if f is not None:
            return f(v)
        return TensorValue("scalar", v)

    @staticmethod
    def vector(v) -> "TensorValue":
        return TensorValue("vector", np.asarray(v, dtype=np.float32))

    @staticmethod
    def sparse(v: SparseVector) -> "TensorValue":
        return TensorValue("sparse", v)

    @staticmethod
    def pointer(key: str) -> "TensorValue":
        return TensorValue("pointer", key)

    @staticmethod
    def pointers(keys: Iterable[str]) -> "TensorValue":
        return TensorValue("pointers", list(keys))

    @staticmethod
    def from_embedding(
        dense,
        value_threshold: float = DEFAULT_VALUE_THRESHOLD,
        sparsity_threshold: float = DEFAULT_SPARSITY_THRESHOLD,
    ) -> "TensorValue":
        """Auto-pick sparse vs dense, like TensorValue::from_embedding.

        Counts near-zeros first (count_nonzero, no index materialization)
        and only builds the SparseVector when sparse actually wins —
        the dense common case had paid a full nonzero + fancy-index per
        put (~30% of mass-ingest time at 768d)."""
        arr = np.asarray(dense, dtype=np.float32)
        n = int(arr.shape[0])
        if sparsity_threshold <= 1.0 and n:
            nnz = int(np.count_nonzero(np.abs(arr) > value_threshold))
            if 1.0 - nnz / n >= sparsity_threshold:
                return TensorValue.sparse(
                    SparseVector.from_dense_with_threshold(
                        arr, value_threshold))
        return TensorValue.vector(dense)

    # -- accessors -------------------------------------------------------
    def is_vector(self) -> bool:
        return self.kind in ("vector", "sparse")

    def to_dense(self) -> Optional[np.ndarray]:
        if self.kind == "vector":
            return np.asarray(self.value, dtype=np.float32)
        if self.kind == "sparse":
            return self.value.to_dense()
        return None

    def dimension(self) -> Optional[int]:
        if self.kind == "vector":
            return int(len(self.value))
        if self.kind == "sparse":
            return self.value.dim
        return None

    def dot(self, other: "TensorValue") -> Optional[float]:
        a, b = self.to_dense(), other.to_dense()
        if a is None or b is None or len(a) != len(b):
            return None
        return float(np.dot(a.astype(np.float64), b.astype(np.float64)))

    def cosine_similarity(self, other: "TensorValue") -> Optional[float]:
        a, b = self.to_dense(), other.to_dense()
        if a is None or b is None or len(a) != len(b):
            return None
        na = float(np.linalg.norm(a))
        nb = float(np.linalg.norm(b))
        if na == 0.0 or nb == 0.0:
            return 0.0
        return float(np.dot(a.astype(np.float64), b.astype(np.float64))
                     / (na * nb))

    def __eq__(self, other):
        if not isinstance(other, TensorValue) or self.kind != other.kind:
            return False
        if self.kind == "vector":
            return np.array_equal(self.value, other.value)
        return self.value == other.value


@dataclass(slots=True)
class TensorData:
    """A named bag of TensorValues — one stored entity."""

    fields: Dict[str, TensorValue] = field(default_factory=dict)

    def set(self, name: str, value: TensorValue) -> "TensorData":
        self.fields[name] = value
        return self

    def get(self, name: str) -> Optional[TensorValue]:
        return self.fields.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self.fields

    @staticmethod
    def with_values(**kwargs) -> "TensorData":
        td = TensorData()
        for k, v in kwargs.items():
            if isinstance(v, TensorValue):
                td.set(k, v)
            elif isinstance(v, SparseVector):
                td.set(k, TensorValue.sparse(v))
            elif isinstance(v, (list, tuple, np.ndarray)) and not isinstance(
                v, (str, bytes)
            ):
                td.set(k, TensorValue.vector(v))
            else:
                td.set(k, TensorValue.scalar(v))
        return td


class LazyTensorData(TensorData):
    """TensorData whose fields decode from serialized bytes on first
    access.

    Bulk WAL recovery (codec wal_apply) inserts these wrappers instead
    of materializing every record — replay becomes a C frame scan plus
    cheap slot-only objects (reference replays 10K records in ~400 us,
    tensor-store.md; materializing Python objects per record cannot).
    The wrapper shares the WAL buffer; decode cost moves to first use.
    """

    __slots__ = ("_buf", "_pos", "_mat")

    def __init__(self, buf: bytes = b"", pos: int = 0):
        self._buf = buf
        self._pos = pos
        self._mat = None

    @property
    def fields(self):  # type: ignore[override]
        m = self._mat
        if m is None:
            from neumann_tpu_torch.store import codec

            m = codec.decode_data(self._buf, self._pos).fields
            self._mat = m
            self._buf = b""      # drop the buffer ref once decoded
        return m

    @fields.setter
    def fields(self, value):
        self._mat = value
        self._buf = b""


class TensorStore:
    """Concurrent host KV store with prefix scan and durability hooks.

    API parity: put/get/delete/exists/scan/scan_count/len plus
    save_snapshot/load_snapshot and open_durable/recover via
    neumann_tpu.store.{snapshot,wal}.
    """

    def __init__(self):
        from neumann_tpu_torch.store.ordered_index import OrderedKeyIndex

        self._map: Dict[str, TensorData] = {}
        # MetadataSlab equivalent: 16-way sharded ordered key index
        # (tensor_store/src/metadata_slab.rs) so prefix/range scans are
        # O(log n + m) instead of sorting the whole map per scan
        self._index = OrderedKeyIndex()
        # direct handle on the index's write-behind deque (never
        # rebound) — saves an attribute hop on the put fast path
        self._pending_keys = self._index._pending
        # plain Lock (not RLock): no method calls another mutator
        # while holding it, and Lock is ~2x cheaper per acquire
        self._lock = threading.Lock()
        self._wal = None  # set by open_durable
        # WAL-overlay recovery state (native): replayed records live in
        # a C++ map and materialize on first access (promote-on-read,
        # like the reference's cold tier, tensor_store/src/tiered.rs)
        self._ov_cap = None
        self._ov_ext = None
        self._ov_flushed = False
        # listeners let engines keep device slabs in sync with raw puts
        self._put_hooks: List[Callable[[str, TensorData], None]] = []
        self._delete_hooks: List[Callable[[str], None]] = []

    # -- core ------------------------------------------------------------
    def put(self, key: str, data: TensorData) -> None:
        if not isinstance(key, str) or not key:
            raise StoreError("key must be a non-empty string")
        if (self._wal is None and self._ov_cap is None
                and not self._put_hooks):
            # lock-free fast path (DashMap-style): dict item assignment
            # and deque.append are each GIL-atomic, and _pending is
            # never rebound (flush drains by popleft), so no writer
            # lock is needed. A scan racing this put may miss the key —
            # same as the put not having happened yet.
            self._map[key] = data
            self._pending_keys.append(key)
            return
        with self._lock:
            if self._ov_cap is not None:   # drop any stale shadow
                self._ov_ext.overlay_pop(self._ov_cap, key)
            self._map[key] = data
            self._index._pending.append(key)
            if self._wal is not None:
                self._wal.log_put(key, data)
        if self._put_hooks:
            for hook in self._put_hooks:
                hook(key, data)

    def get(self, key: str) -> Optional[TensorData]:
        # Lock-free read (DashMap-style): dict.get is GIL-atomic and
        # every writer mutates _map with single atomic ops (item
        # assignment / pop / clear / rebind), so a reader sees either
        # the old or the new state — the lock added latency, not safety.
        v = self._map.get(key)
        if v is None and self._ov_cap is not None:
            return self._promote(key)
        return v

    def _promote(self, key: str) -> Optional[TensorData]:
        """Materialize one WAL-overlay record into the map."""
        with self._lock:
            v = self._map.get(key)
            if v is not None or self._ov_cap is None:
                return v
            try:
                code, td = self._ov_ext.overlay_pop(self._ov_cap, key)
            except ValueError as e:   # deferred-CRC failure (lazy)
                raise StoreError(
                    f"WAL record for {key!r} is corrupt: {e}") from None
            if code != 1:
                return None
            self._map[key] = td
            self._index._pending.append(key)
            if self._ov_ext.overlay_count(self._ov_cap) == 0:
                self._ov_cap = None
            return td

    def _flush_overlay_keys(self) -> None:
        """Make overlay keys visible to the ordered index (first scan)."""
        if self._ov_cap is None or self._ov_flushed:
            return
        puts, _ = self._ov_ext.overlay_keys(self._ov_cap)
        self._index._pending.extend(puts)
        self._ov_flushed = True

    def _materialize_all(self) -> None:
        """Promote every overlay record (snapshots/clear need the full
        map; this is where the deferred replay decode cost lands)."""
        if self._ov_cap is None:
            return
        puts, _ = self._ov_ext.overlay_keys(self._ov_cap)
        for key in puts:
            self._promote(key)
        self._ov_cap = None

    def delete(self, key: str) -> bool:
        with self._lock:
            existed = self._map.pop(key, None) is not None
            if not existed and self._ov_cap is not None:
                code, _ = self._ov_ext.overlay_pop(self._ov_cap, key)
                existed = code == 1
            if existed:
                self._index.remove(key)
                if self._wal is not None:
                    self._wal.log_delete(key)
        if existed:
            for hook in self._delete_hooks:
                hook(key)
        return existed

    def exists(self, key: str) -> bool:
        if key in self._map:      # GIL-atomic, see get()
            return True
        return self._ov_cap is not None and self.get(key) is not None

    def scan(self, prefix: str = "") -> List[str]:
        with self._lock:
            self._flush_overlay_keys()
            return self._index.scan_prefix(prefix)

    def scan_range(self, lo: str, hi: Optional[str] = None) -> List[str]:
        """Ordered keys in [lo, hi); hi=None scans to the end."""
        with self._lock:
            self._flush_overlay_keys()
            return self._index.scan_range(lo, hi)

    def scan_count(self, prefix: str = "") -> int:
        with self._lock:
            if not prefix:
                n = len(self._map)
                if self._ov_cap is not None:
                    n += self._ov_ext.overlay_count(self._ov_cap)
                return n
            self._flush_overlay_keys()
            return self._index.count_prefix(prefix)

    def keys(self) -> List[str]:
        return self.scan("")

    def __len__(self) -> int:
        with self._lock:
            n = len(self._map)
            if self._ov_cap is not None:
                n += self._ov_ext.overlay_count(self._ov_cap)
            return n

    def clear(self, notify: bool = True) -> None:
        """Remove all entries. With notify=True (default), delete hooks
        fire per key so engine device mirrors drop their rows too."""
        # overlay records never fired put hooks, so dropping them
        # needs no delete notifications
        with self._lock:
            self._ov_cap = None
            keys = list(self._map)
            self._map.clear()
            self._index.clear()
        if notify:
            for key in keys:
                for hook in self._delete_hooks:
                    hook(key)

    # -- hooks -------------------------------------------------------------
    def on_put(self, fn: Callable[[str, TensorData], None]) -> None:
        self._put_hooks.append(fn)

    def on_delete(self, fn: Callable[[str], None]) -> None:
        self._delete_hooks.append(fn)

    # -- durability (wired in store.wal / store.snapshot) -----------------
    def save_snapshot(self, path, compressed: bool = False) -> None:
        from neumann_tpu_torch.store import snapshot

        self._materialize_all()
        with self._lock:
            snapshot.save(self._map, path, compressed=compressed)

    def save_snapshot_compressed(self, path) -> None:
        self.save_snapshot(path, compressed=True)

    def snapshot_bytes(self, compressed: bool = True) -> bytes:
        """Serialize the full store to snapshot bytes (for raft
        compaction / snapshot transfer; tensor_chain snapshot_bytes
        capability)."""
        from neumann_tpu_torch.store import snapshot

        self._materialize_all()
        with self._lock:
            return snapshot.dumps(self._map, compressed=compressed)

    def restore_from_bytes(self, buf: bytes) -> None:
        """Replace all state with a snapshot produced by
        snapshot_bytes(). Fires delete hooks for dropped keys and put
        hooks for loaded ones so engine device mirrors follow."""
        from neumann_tpu_torch.store import snapshot

        loaded = snapshot.loads(buf)
        self.clear(notify=True)
        with self._lock:
            self._map = loaded
            self._index.clear()
            self._index._pending.extend(loaded.keys())
        for key, data in list(loaded.items()):
            for hook in self._put_hooks:
                hook(key, data)

    def load_snapshot(self, path) -> None:
        from neumann_tpu_torch.store import snapshot

        loaded = snapshot.load(path)
        with self._lock:
            self._map = loaded
            self._index.clear()
            # write-behind: the next ordered scan bulk-flushes (same
            # policy as put), so load cost is the structure pass only
            self._index._pending.extend(loaded.keys())
        for key, data in list(loaded.items()):
            for hook in self._put_hooks:
                hook(key, data)

    def open_durable(self, wal_path, sync_mode="batched") -> None:
        """Attach a WAL; subsequent puts/deletes are logged."""
        from neumann_tpu_torch.store.wal import TensorWal

        self._wal = TensorWal(wal_path, sync_mode=sync_mode)

    def recover(self, wal_path, snapshot_path=None,
                verify: str = "eager") -> int:
        """Rebuild state from snapshot + WAL replay. Returns #records.

        With the native codec, replay is a single C pass that yields
        each key's FINAL state as a lazy wrapper (no per-record object
        materialization) — decode cost moves to first access, so
        recovery runs at reference-class record rates.

        verify="lazy" additionally defers each payload's CRC to first
        access: replay then touches only frame headers (header-rate
        recovery). Every byte is still CRC-checked BEFORE use — the
        trade is that mid-log bit rot surfaces as a StoreError at the
        first read of the damaged key instead of truncating replay
        (the final frame, where torn writes land, is always checked
        eagerly)."""
        import os as _os

        from neumann_tpu_torch.store import codec
        from neumann_tpu_torch.store.wal import TensorWal

        if snapshot_path is not None:
            if _os.path.exists(snapshot_path):
                self.load_snapshot(snapshot_path)
        ext = codec._native()
        if ext is not None and hasattr(ext, "wal_overlay") \
                and _os.path.exists(_os.fspath(wal_path)):
            import mmap as _mmap

            with open(_os.fspath(wal_path), "rb") as fh:
                size = _os.fstat(fh.fileno()).st_size
                if size >= (2 << 20) and not self._put_hooks:
                    # zero-copy: the overlay capsule holds a buffer
                    # view of the mmap (a read() memcpy of the log
                    # dominated replay time on cloud-VM memory).
                    # SMALL logs read() instead: fresh page-table
                    # population made the mmap parse 2-3x slower
                    # than parsing a heap buffer
                    buf = _mmap.mmap(fh.fileno(), 0,
                                     access=_mmap.ACCESS_READ)
                else:
                    buf = fh.read()
            try:
                if not self._put_hooks:
                    # fastest path: records stay in a C++ overlay map
                    # (zero Python objects) and promote on first read
                    cap, n = ext.wal_overlay(buf,
                                             1 if verify == "lazy"
                                             else 0)
                    with self._lock:
                        self._ov_ext = ext
                        self._ov_cap = cap
                        self._ov_flushed = False
                        dels = ext.overlay_tombstones(cap)
                        for key in dels:        # tombstones apply now
                            ext.overlay_pop(cap, key)
                            if self._map.pop(key, None) is not None:
                                self._index.remove(key)
                        if ext.overlay_count(cap) == 0:
                            self._ov_cap = None
                    return n
                # hooks registered: engines must see every record, so
                # build lazy per-record wrappers instead (still one C
                # pass; field decode happens when a hook touches it)
                final, n = ext.wal_apply(buf, LazyTensorData)
            except ValueError as e:
                raise StoreError(f"malformed WAL record: {e}") from None
            puts, dels = [], []
            with self._lock:
                for key, val in final.items():
                    if val is None:
                        if self._map.pop(key, None) is not None:
                            self._index.remove(key)
                            dels.append(key)
                    else:
                        self._map[key] = val
                        puts.append(key)
                self._index.insert_many(puts)
            # a logged delete of a key the snapshot loaded: the engines
            # saw the snapshot's put, so they must see the delete (the
            # JAX package's store drops the key without telling them)
            for key in dels:
                for hook in self._delete_hooks:
                    hook(key)
            for key in puts:
                data = self._map.get(key)
                if data is not None:
                    for hook in self._put_hooks:
                        hook(key, data)
            return n
        n = 0
        for op, key, data in TensorWal.replay(wal_path):
            if op == "put":
                self.put(key, data)
            else:
                self.delete(key)
            n += 1
        return n

    def checkpoint(self, snapshot_path) -> None:
        """Snapshot current state and truncate the WAL."""
        self.save_snapshot(snapshot_path)
        if self._wal is not None:
            self._wal.truncate()

    def wal_flush(self) -> None:
        if self._wal is not None:
            self._wal.flush()

"""Ordered key index: the TPU build's MetadataSlab.

The reference stores metadata in 16-way sharded BTreeMaps routed by the
first key byte with ordered iteration (tensor_store/src/metadata_slab.rs).
Here values live in the TensorStore dict; this index keeps the KEYS
ordered so prefix/range scans are O(log n + m) instead of
sort-the-whole-map per scan.

Two implementations behind one class:

* native: C++ sharded ``std::set`` (neumann_tpu/native), called via
  ctypes with the GIL released — shard is the high nibble of the first
  byte so concatenating shards yields global lexicographic order.
* fallback: 16 bisect-maintained sorted lists with the same sharding.

The port's copy of ``neumann_tpu/store/ordered_index.py``:
only its import lines differ.
"""

from __future__ import annotations

import bisect
import threading
from collections import deque
from typing import List, Optional

from neumann_tpu_torch import native


def _shard_of(key: str) -> int:
    return (key.encode("utf-8", "surrogatepass")[0] >> 4) if key else 0


def _prefix_end(prefix: bytes) -> bytes:
    """Smallest byte string > every string with this prefix ('' = none)."""
    e = prefix.rstrip(b"\xff")
    if not e:
        return b""
    return e[:-1] + bytes([e[-1] + 1])


class OrderedKeyIndex:
    """Sharded ordered set of string keys with prefix/range scans."""

    def __init__(self, use_native: Optional[bool] = None):
        if use_native is None:
            use_native = native.available()
        self._lib = native.load() if use_native else None
        if self._lib is not None:
            self._h = self._lib.nn_oki_new()
            if not self._h:  # pragma: no cover - allocation failure
                self._lib = None
        if self._lib is None:
            self._shards: List[List[bytes]] = [[] for _ in range(16)]
            self._lock = threading.Lock()
        # write-behind buffer: puts append here (one list append), and
        # any read/remove flushes via one bulk insert — ordered scans
        # are rarer than puts, so the per-put ctypes/bisect crossing
        # moves off the hot write path
        # a deque that is NEVER rebound: appends are GIL-atomic, so the
        # store's lock-free put path can buffer keys without a lock;
        # flush drains via popleft instead of swapping the object
        self._pending: deque = deque()
        # keys containing "\n" would corrupt the native scan protocol
        # (newline-joined buffers), so they overflow to this sorted
        # Python-side list and are merged into results
        self._nl: List[bytes] = []

    def _flush(self) -> None:
        dq = self._pending
        if not dq:
            return
        keys: List[str] = []
        pop = dq.popleft
        while True:
            try:
                keys.append(pop())
            except IndexError:
                break
        if keys:
            self.insert_many(keys)

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def __del__(self):  # pragma: no cover - interpreter teardown order
        try:
            if self._lib is not None and self._h:
                self._lib.nn_oki_free(self._h)
                self._h = None
        except Exception:
            pass

    # -- mutation ---------------------------------------------------------
    def insert_lazy(self, key: str) -> None:
        """Buffer an insert; flushed in bulk before the next ordered
        read (the TensorStore put path)."""
        self._pending.append(key)

    def insert(self, key: str) -> bool:
        b = key.encode("utf-8", "surrogatepass")
        if self._lib is not None:
            if b"\n" in b:
                return self._nl_insert(b)
            return bool(self._lib.nn_oki_insert(self._h, b, len(b)))
        with self._lock:
            shard = self._shards[b[0] >> 4 if b else 0]
            i = bisect.bisect_left(shard, b)
            if i < len(shard) and shard[i] == b:
                return False
            shard.insert(i, b)
            return True

    def insert_many(self, keys) -> int:
        """Bulk insert; one native call (or one sort per shard) instead
        of a ctypes/bisect crossing per key. Returns #new keys."""
        encoded = [k.encode("utf-8", "surrogatepass") for k in keys]
        if not encoded:
            return 0
        if self._lib is not None:
            import ctypes

            added = 0
            if any(b"\n" in b for b in encoded):
                keep = []
                for b in encoded:
                    if b"\n" in b:
                        added += self._nl_insert(b)
                    else:
                        keep.append(b)
                encoded = keep
                if not encoded:
                    return added
            buf = b"".join(encoded)
            lens = (ctypes.c_uint32 * len(encoded))(
                *(len(b) for b in encoded))
            return added + int(self._lib.nn_oki_insert_batch(
                self._h, buf, lens, len(encoded)))
        with self._lock:
            added = 0
            by_shard: dict = {}
            for b in encoded:
                by_shard.setdefault(b[0] >> 4 if b else 0, []).append(b)
            for s, items in by_shard.items():
                shard = self._shards[s]
                before = len(shard)
                merged = sorted(set(shard) | set(items))
                self._shards[s] = merged
                added += len(merged) - before
            return added

    def remove(self, key: str) -> bool:
        self._flush()
        b = key.encode("utf-8", "surrogatepass")
        if self._lib is not None:
            if b"\n" in b:
                return self._nl_remove(b)
            return bool(self._lib.nn_oki_remove(self._h, b, len(b)))
        with self._lock:
            shard = self._shards[b[0] >> 4 if b else 0]
            i = bisect.bisect_left(shard, b)
            if i < len(shard) and shard[i] == b:
                shard.pop(i)
                return True
            return False

    def clear(self) -> None:
        self._pending.clear()
        self._nl = []
        if self._lib is not None:
            self._lib.nn_oki_free(self._h)
            self._h = self._lib.nn_oki_new()
            return
        with self._lock:
            self._shards = [[] for _ in range(16)]

    # -- queries ----------------------------------------------------------
    def __len__(self) -> int:
        self._flush()
        if self._lib is not None:
            return int(self._lib.nn_oki_len(self._h)) + len(self._nl)
        with self._lock:
            return sum(len(s) for s in self._shards)

    def count_prefix(self, prefix: str = "") -> int:
        self._flush()
        b = prefix.encode("utf-8", "surrogatepass")
        if self._lib is not None:
            n = int(self._lib.nn_oki_count_prefix(self._h, b, len(b)))
            if self._nl:
                hi = _prefix_end(b)
                n += len(self._nl_range(b, hi, not hi))
            return n
        hi = _prefix_end(b)
        with self._lock:
            return self._count_range_locked(b, hi, not hi)

    def scan_prefix(self, prefix: str = "") -> List[str]:
        self._flush()
        b = prefix.encode("utf-8", "surrogatepass")
        if self._lib is not None:
            import ctypes

            need = self._lib.nn_oki_scan_prefix(self._h, b, len(b),
                                                None, 0)
            if need == 0:
                if self._nl:
                    hi = _prefix_end(b)
                    return self._nl_merge([], b, hi, not hi)
                return []
            buf = ctypes.create_string_buffer(need)
            self._lib.nn_oki_scan_prefix(self._h, b, len(b), buf, need)
            # one whole-buffer decode + str split is ~4x a per-key
            # decode ("\n" is a single byte, so UTF-8 decoding is
            # unaffected by the joins)
            out = buf.raw[:need].decode(
                "utf-8", "surrogatepass").split("\n")[:-1]
            if self._nl:
                hi = _prefix_end(b)
                out = self._nl_merge(out, b, hi, not hi)
            return out
        hi = _prefix_end(b)
        with self._lock:
            return self._scan_range_locked(b, hi, not hi)

    def scan_range(self, lo: str, hi: Optional[str] = None) -> List[str]:
        """Keys in [lo, hi), ordered; hi=None scans to the end."""
        self._flush()
        lob = lo.encode("utf-8", "surrogatepass")
        hib = b"" if hi is None else hi.encode("utf-8", "surrogatepass")
        if self._lib is not None:
            import ctypes

            unb = 1 if hi is None else 0
            need = self._lib.nn_oki_scan_range(
                self._h, lob, len(lob), hib, len(hib), unb, None, 0)
            if need == 0:
                if self._nl:
                    return self._nl_merge([], lob, hib, hi is None)
                return []
            buf = ctypes.create_string_buffer(need)
            self._lib.nn_oki_scan_range(self._h, lob, len(lob), hib,
                                        len(hib), unb, buf, need)
            out = buf.raw[:need].decode(
                "utf-8", "surrogatepass").split("\n")[:-1]
            if self._nl:
                out = self._nl_merge(out, lob, hib, hi is None)
            return out
        with self._lock:
            return self._scan_range_locked(lob, hib, hi is None)

    # -- newline-key overflow (native path only) --------------------------
    def _nl_insert(self, b: bytes) -> bool:
        i = bisect.bisect_left(self._nl, b)
        if i < len(self._nl) and self._nl[i] == b:
            return False
        self._nl.insert(i, b)
        return True

    def _nl_remove(self, b: bytes) -> bool:
        i = bisect.bisect_left(self._nl, b)
        if i < len(self._nl) and self._nl[i] == b:
            self._nl.pop(i)
            return True
        return False

    def _nl_range(self, lo: bytes, hi: bytes,
                  unbounded: bool) -> List[bytes]:
        i = bisect.bisect_left(self._nl, lo) if lo else 0
        out = []
        for j in range(i, len(self._nl)):
            if not unbounded and self._nl[j] >= hi:
                break
            out.append(self._nl[j])
        return out

    def _nl_merge(self, keys: List[str], lo: bytes, hi: bytes,
                  unbounded: bool) -> List[str]:
        extra = [b.decode("utf-8", "surrogatepass")
                 for b in self._nl_range(lo, hi, unbounded)]
        if not extra:
            return keys
        return sorted(keys + extra)

    # -- fallback internals -------------------------------------------------
    def _iter_range_locked(self, lo: bytes, hi: bytes, unbounded: bool):
        lo_shard = (lo[0] >> 4) if lo else 0
        hi_shard = 15 if unbounded else ((hi[0] >> 4) if hi else 0)
        for s in range(lo_shard, min(hi_shard, 15) + 1):
            shard = self._shards[s]
            i = bisect.bisect_left(shard, lo) if lo else 0
            for j in range(i, len(shard)):
                if not unbounded and shard[j] >= hi:
                    break
                yield shard[j]

    def _scan_range_locked(self, lo, hi, unbounded):
        return [k.decode("utf-8", "surrogatepass")
                for k in self._iter_range_locked(lo, hi, unbounded)]

    def _count_range_locked(self, lo, hi, unbounded):
        return sum(1 for _ in self._iter_range_locked(lo, hi, unbounded))

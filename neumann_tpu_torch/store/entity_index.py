"""String key <-> dense row id vocabulary.

Same role as tensor_store/src/entity_index.rs: every entity key gets a
stable small integer id, which is its row in the device-resident slabs.
Deleted ids go to a free list and are reused, so the device arrays stay
dense-ish and capacity growth is amortized.

The port's copy of ``neumann_tpu/store/entity_index.py``:
only its import lines differ.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class EntityIndex:
    def __init__(self):
        self._lock = threading.RLock()
        self._key_to_id: Dict[str, int] = {}
        self._id_to_key: List[Optional[str]] = []
        self._free: List[int] = []

    def get_or_insert(self, key: str) -> int:
        with self._lock:
            eid = self._key_to_id.get(key)
            if eid is not None:
                return eid
            if self._free:
                eid = self._free.pop()
                self._id_to_key[eid] = key
            else:
                eid = len(self._id_to_key)
                self._id_to_key.append(key)
            self._key_to_id[key] = eid
            return eid

    def get_or_insert_many(self, keys) -> "np.ndarray":
        """Vectorized get_or_insert for a batch of keys (columnar
        ingest). The fresh-ingest common case — no free-listed ids, no
        key already present, no duplicate within the batch — is three
        C-speed dict/set operations instead of a per-key Python loop;
        anything else falls back to the exact per-key path."""
        import numpy as np

        n = len(keys)
        with self._lock:
            k2i, i2k = self._key_to_id, self._id_to_key
            if not self._free:
                seen = set(keys)
                if len(seen) == n and k2i.keys().isdisjoint(seen):
                    start = len(i2k)
                    k2i.update(zip(keys, range(start, start + n)))
                    i2k.extend(keys)
                    return np.arange(start, start + n, dtype=np.int64)
            out = np.empty(n, np.int64)
            free = self._free
            for i, key in enumerate(keys):
                eid = k2i.get(key)
                if eid is None:
                    if free:
                        eid = free.pop()
                        i2k[eid] = key
                    else:
                        eid = len(i2k)
                        i2k.append(key)
                    k2i[key] = eid
                out[i] = eid
            return out

    def lookup(self, key: str) -> Optional[int]:
        with self._lock:
            return self._key_to_id.get(key)

    def key_of(self, eid: int) -> Optional[str]:
        with self._lock:
            if 0 <= eid < len(self._id_to_key):
                return self._id_to_key[eid]
            return None

    def keys_of(self, eids) -> List[Optional[str]]:
        """Batch key_of: one lock acquisition for a whole result set
        (the per-hit lock was measurable at serving batch sizes)."""
        with self._lock:
            i2k = self._id_to_key
            n = len(i2k)
            return [i2k[e] if 0 <= e < n else None for e in eids]

    def remove(self, key: str) -> Optional[int]:
        with self._lock:
            eid = self._key_to_id.pop(key, None)
            if eid is not None:
                self._id_to_key[eid] = None
                self._free.append(eid)
            return eid

    def __len__(self) -> int:
        with self._lock:
            return len(self._key_to_id)

    @property
    def capacity(self) -> int:
        """Highest id ever allocated + 1 (device row count)."""
        with self._lock:
            return len(self._id_to_key)

    def keys(self):
        with self._lock:
            return list(self._key_to_id.keys())

    def items(self):
        with self._lock:
            return list(self._key_to_id.items())

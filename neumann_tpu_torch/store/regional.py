"""Region-aware storage: Voronoi-sorted runs for geometric locality.

Parity with tensor_store/src/mmap_regional.rs + voronoi.rs capability:
vectors are assigned to Voronoi regions, buffered writes flush as
append-only runs SORTED by (region_id, sequence), each run carries a
region index so an entire region can be read with one contiguous scan
(the k-NN locality read), and LSM-style compaction merges runs without
rewriting payloads out of order.

Host-side only by design: this is the cold/disk tier. The hot path stays
in the device EmbeddingSlab; a regional read feeds candidate vectors back
into the device scan (nprobe-style).

The port's copy of ``neumann_tpu/store/regional.py``: only its
import lines differ (``VoronoiPartitioner`` is the port's).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from neumann_tpu_torch.parallel.partitioner import VoronoiPartitioner
from neumann_tpu_torch.utils.errors import StoreError

_MAGIC = b"RGN1"
_HDR = struct.Struct("<4sI")          # magic, entry count
_ENTRY = struct.Struct("<IQHI")       # region, seq, key len, data len
_FOOT = struct.Struct("<Q")           # offset of the region index


class LocalityKeyGenerator:
    """(region_id, monotonic per-region sequence) — the sort key that
    groups geometrically similar vectors together on disk."""

    def __init__(self, partitioner: VoronoiPartitioner):
        self.partitioner = partitioner
        self._seq: Dict[int, int] = {}
        self._lock = threading.Lock()

    def key_for(self, vector: np.ndarray) -> Tuple[int, int]:
        region = self.partitioner.assign(vector)
        with self._lock:
            seq = self._seq.get(region, 0)
            self._seq[region] = seq + 1
        return region, seq


class _Run:
    """One immutable sorted run file, mmapped, with its region index."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, self.count = _HDR.unpack_from(self._mm, 0)
        if magic != _MAGIC:
            raise StoreError(f"bad regional run magic in {path}")
        (index_off,) = _FOOT.unpack_from(self._mm,
                                         len(self._mm) - _FOOT.size)
        raw = self._mm[index_off: len(self._mm) - _FOOT.size]
        # region -> [start_offset, entry_count]
        self.index: Dict[int, List[int]] = {
            int(k): v for k, v in json.loads(raw.decode()).items()}

    def read_region(self, region: int) -> List[Tuple[str, bytes]]:
        info = self.index.get(region)
        if info is None:
            return []
        off, count = info
        out = []
        for _ in range(count):
            rg, _seq, klen, dlen = _ENTRY.unpack_from(self._mm, off)
            off += _ENTRY.size
            key = self._mm[off: off + klen].decode()
            off += klen
            data = zlib.decompress(self._mm[off: off + dlen])
            off += dlen
            out.append((key, data))
        return out

    def iter_all(self):
        off = _HDR.size
        for _ in range(self.count):
            region, seq, klen, dlen = _ENTRY.unpack_from(self._mm, off)
            off += _ENTRY.size
            key = self._mm[off: off + klen].decode()
            off += klen
            data = zlib.decompress(self._mm[off: off + dlen])
            off += dlen
            yield region, seq, key, data

    def close(self) -> None:
        self._mm.close()
        self._f.close()


def _write_run(path: str,
               entries: List[Tuple[int, int, str, bytes]]) -> None:
    """entries: (region, seq, key, raw-data) — sorted here."""
    entries = sorted(entries, key=lambda e: (e[0], e[1]))
    index: Dict[int, List[int]] = {}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_HDR.pack(_MAGIC, len(entries)))
        for region, seq, key, data in entries:
            if region not in index:
                index[region] = [f.tell(), 0]
            index[region][1] += 1
            kb = key.encode()
            packed = zlib.compress(data, 3)
            f.write(_ENTRY.pack(region, seq, len(kb), len(packed)))
            f.write(kb)
            f.write(packed)
        index_off = f.tell()
        f.write(json.dumps(index).encode())
        f.write(_FOOT.pack(index_off))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class RegionalStore:
    """LSM of region-sorted runs + an in-memory write buffer."""

    def __init__(self, directory: str, partitioner: VoronoiPartitioner,
                 flush_threshold: int = 1024):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.keygen = LocalityKeyGenerator(partitioner)
        self.partitioner = partitioner
        self.flush_threshold = flush_threshold
        self._buffer: List[Tuple[int, int, str, bytes]] = []
        self._runs: List[_Run] = []
        self._lock = threading.Lock()
        self._run_counter = 0
        for name in sorted(os.listdir(directory)):
            if name.endswith(".rgn"):
                self._runs.append(_Run(os.path.join(directory, name)))
                self._run_counter += 1

    # -- writes -----------------------------------------------------------
    def put(self, key: str, vector: np.ndarray, data: bytes) -> int:
        """Buffer an entry; returns its region id."""
        region, seq = self.keygen.key_for(np.asarray(vector, np.float32))
        with self._lock:
            self._buffer.append((region, seq, key, data))
            should_flush = len(self._buffer) >= self.flush_threshold
        if should_flush:
            self.flush()
        return region

    def flush(self) -> Optional[str]:
        """Write the buffer as one new sorted run."""
        with self._lock:
            if not self._buffer:
                return None
            entries, self._buffer = self._buffer, []
            self._run_counter += 1
            path = os.path.join(self.dir,
                                f"run-{self._run_counter:06d}.rgn")
        _write_run(path, entries)
        with self._lock:
            self._runs.append(_Run(path))
        return path

    # -- reads ------------------------------------------------------------
    def load_region(self, region: int) -> List[Tuple[str, bytes]]:
        """All entries of one region: one contiguous scan per run, in
        write order (later runs, and later sequences, win on dup keys)."""
        with self._lock:
            runs = list(self._runs)
            buffered = [(s, k, d) for r, s, k, d in self._buffer
                        if r == region]
        out: Dict[str, bytes] = {}
        for run in runs:
            for key, data in run.read_region(region):
                out[key] = data
        for _seq, key, data in sorted(buffered):
            out[key] = data
        return list(out.items())

    def nearest_regions(self, query: np.ndarray, n: int) -> List[int]:
        """Region ids by seed distance — the nprobe candidate order."""
        q = np.asarray(query, np.float32)
        d2 = np.sum((self.partitioner.seeds - q[None, :]) ** 2, axis=1)
        return [int(i) for i in np.argsort(d2)[:n]]

    def knn_candidates(self, query: np.ndarray, nprobe: int = 1
                       ) -> List[Tuple[str, bytes]]:
        """Locality read: entries from the nprobe nearest regions."""
        out = []
        for region in self.nearest_regions(query, nprobe):
            out.extend(self.load_region(region))
        return out

    # -- maintenance --------------------------------------------------------
    def compact(self) -> int:
        """Merge all runs into one; returns the number of runs removed."""
        self.flush()
        with self._lock:
            runs = list(self._runs)
            if len(runs) <= 1:
                return 0
            merged: Dict[str, Tuple[int, int, bytes]] = {}
            for run in runs:                    # later runs win on dups
                for region, seq, key, data in run.iter_all():
                    merged[key] = (region, seq, data)
            self._run_counter += 1
            path = os.path.join(self.dir,
                                f"run-{self._run_counter:06d}.rgn")
        _write_run(path, [(r, s, k, d)
                          for k, (r, s, d) in merged.items()])
        with self._lock:
            for run in runs:
                run.close()
                os.unlink(run.path)
            self._runs = [r for r in self._runs if r not in runs]
            self._runs.append(_Run(path))
        return len(runs)

    def stats(self) -> dict:
        with self._lock:
            return {
                "runs": len(self._runs),
                "buffered": len(self._buffer),
                "entries": sum(r.count for r in self._runs),
                "regions": sorted({rg for r in self._runs
                                   for rg in r.index}),
            }

    def close(self) -> None:
        self.flush()
        with self._lock:
            for run in self._runs:
                run.close()
            self._runs = []

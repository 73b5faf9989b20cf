"""HNSW: hierarchical navigable small-world ANN index (host-side).

Parity with the reference's native HNSW (tensor_store/src/hnsw.rs:
HNSWIndex {insert, insert_auto, insert_quantized, insert_sparse,
insert_tt, search, search_with_ef, search_sparse}, HNSWConfig presets
at hnsw.rs:1434-1553, per-node EmbeddingStorage modes at hnsw.rs:564).

Role in the TPU build: the *bulk* SIMILAR path is the MXU matmul scan
(ops/scan.py) — measured faster than graph ANN on-chip well past 10M
rows — but HNSW is the right structure where queries arrive one at a
time against a host-resident, incrementally-built index: the semantic
LLM-cache lookup and small per-collection indexes. The graph walk and
distance kernels live in C++ (native/hnsw_native.cpp, the "native
component" this row demands); this module is the ctypes wrapper plus a
pure-NumPy fallback implementing the identical algorithm and the same
"NHN1" serialized format.

Distance semantics match the reference (hnsw.rs:135-160): internal
distances are cosine-distance / L2 / negative-dot, and returned scores
are similarities (1-d, 1/(1+d), -d respectively).

The port's copy of ``neumann_tpu/ops/hnsw.py``: only its import lines
differ. The index is host-side in both packages (no tensor of it lives
on a card); the native core is the port's copy of ``hnsw_native.cpp``.
"""

from __future__ import annotations

import heapq
import math
import os
import struct
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

import numpy as np

from neumann_tpu_torch import native

_METRIC_IDS = {"cosine": 0, "euclidean": 1, "dot": 2}
KIND_F32, KIND_U8, KIND_BIN, KIND_SPARSE = 0, 1, 2, 3
_KIND_NAMES = {KIND_F32: "dense", KIND_U8: "quantized",
               KIND_BIN: "binary", KIND_SPARSE: "sparse"}


@dataclass
class HNSWConfig:
    """Mirror of the reference's HNSWConfig (hnsw.rs:1434-1482)."""

    m: int = 16
    m0: int = 0                      # 0 -> 2*m
    ef_construction: int = 200
    ef_search: int = 50
    ml: float = 0.0                  # 0 -> 1/ln(m)
    sparsity_threshold: float = 0.5
    max_nodes: int = 10_000_000
    metric: str = "cosine"

    def __post_init__(self):
        if self.m0 <= 0:
            self.m0 = 2 * self.m
        if self.ml <= 0:
            self.ml = 1.0 / math.log(self.m)
        if self.metric not in _METRIC_IDS:
            raise ValueError(f"unknown HNSW metric '{self.metric}'")

    @classmethod
    def high_recall(cls) -> "HNSWConfig":
        return cls(m=32, m0=64, ef_construction=400, ef_search=200)

    @classmethod
    def high_speed(cls) -> "HNSWConfig":
        return cls(m=8, m0=16, ef_construction=100, ef_search=20)

    def with_metric(self, metric: str) -> "HNSWConfig":
        return replace(self, metric=metric)


def _similarity(metric: str, dist: float) -> float:
    if metric == "cosine":
        return 1.0 - dist
    if metric == "euclidean":
        return 1.0 / (1.0 + dist)
    return -dist


class _PyHnsw:
    """Pure-NumPy fallback: same algorithm, same NHN1 format."""

    def __init__(self, dim: int, cfg: HNSWConfig, seed: int):
        self.dim = dim
        self.cfg = cfg
        self.n_searches = 0
        self.n_inserts = 0
        self.n_dist = 0
        self.n_search_dist = 0
        self.rng = np.random.default_rng(seed)
        self.entry = -1
        self.top_level = -1
        self.kinds: List[int] = []
        self.levels: List[int] = []
        self.payloads: List[tuple] = []    # kind-specific raw data
        self.dense: List[np.ndarray] = []  # math view (dequantized)
        self.norms: List[float] = []
        self.sumsqs: List[float] = []
        self.nbrs: List[List[List[int]]] = []

    def __len__(self) -> int:
        return len(self.dense)

    def _random_level(self) -> int:
        u = float(self.rng.random())
        return min(63, max(0, int(-math.log(u or 1e-12) * self.cfg.ml)))

    def _dist(self, q: np.ndarray, qn: float, qs: float, i: int) -> float:
        self.n_dist += 1
        d = float(q @ self.dense[i])
        if self.cfg.metric == "cosine":
            denom = qn * self.norms[i]
            return 1.0 - d / denom if denom > 0 else 1.0
        if self.cfg.metric == "euclidean":
            s = qs - 2.0 * d + self.sumsqs[i]
            return math.sqrt(s) if s > 0 else 0.0
        return -d

    def _search_layer(self, q, qn, qs, ep: int, ef: int, layer: int
                      ) -> List[Tuple[float, int]]:
        d0 = self._dist(q, qn, qs, ep)
        visited = {ep}
        cands = [(d0, ep)]
        best = [(-d0, ep)]                 # max-heap on distance
        while cands:
            d, cur = heapq.heappop(cands)
            if len(best) >= ef and d > -best[0][0]:
                break
            for nb in self.nbrs[cur][layer]:
                if nb in visited:
                    continue
                visited.add(nb)
                dn = self._dist(q, qn, qs, nb)
                if len(best) < ef or dn < -best[0][0]:
                    heapq.heappush(cands, (dn, nb))
                    heapq.heappush(best, (-dn, nb))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted((-d, i) for d, i in best)

    def _pair_dist(self, a: np.ndarray, b: np.ndarray) -> float:
        d = float(a @ b)
        if self.cfg.metric == "cosine":
            denom = float(np.linalg.norm(a) * np.linalg.norm(b))
            return 1.0 - d / denom if denom > 0 else 1.0
        if self.cfg.metric == "euclidean":
            return float(np.linalg.norm(a - b))
        return -d

    def _select(self, cands: List[Tuple[float, int]], m: int
                ) -> List[int]:
        cands = sorted(cands)
        kept: List[int] = []
        for dist, cid in cands:
            if len(kept) >= m:
                break
            cv = self.dense[cid]
            if all(self._pair_dist(cv, self.dense[k]) >= dist
                   for k in kept):
                kept.append(cid)
        for dist, cid in cands:
            if len(kept) >= m:
                break
            if cid not in kept:
                kept.append(cid)
        return kept

    def _prune(self, i: int, layer: int, cap: int) -> None:
        lst = self.nbrs[i][layer]
        if len(lst) <= cap:
            return
        base = self.dense[i]
        qn = float(np.linalg.norm(base))
        qs = float(base @ base)
        cands = [(self._dist(base, qn, qs, nb), nb) for nb in lst]
        self.nbrs[i][layer] = self._select(cands, cap)

    def insert(self, kind: int, payload: tuple, dense: np.ndarray
               ) -> int:
        if self.cfg.max_nodes and len(self) >= self.cfg.max_nodes:
            return -1
        self.n_inserts += 1
        level = self._random_level()
        nid = len(self.dense)
        self.kinds.append(kind)
        self.levels.append(level)
        self.payloads.append(payload)
        self.dense.append(dense)
        ss = float(dense @ dense)
        self.sumsqs.append(ss)
        self.norms.append(math.sqrt(ss))
        self.nbrs.append([[] for _ in range(level + 1)])
        if self.entry < 0:
            self.entry, self.top_level = nid, level
            return nid
        q, qn, qs = dense, self.norms[nid], ss
        ep = self.entry
        for layer in range(self.top_level, level, -1):
            moved = True
            d = self._dist(q, qn, qs, ep)
            while moved:
                moved = False
                for nb in self.nbrs[ep][layer]:
                    dn = self._dist(q, qn, qs, nb)
                    if dn < d:
                        d, ep, moved = dn, nb, True
        for layer in range(min(level, self.top_level), -1, -1):
            found = self._search_layer(q, qn, qs, ep,
                                       self.cfg.ef_construction, layer)
            cap = self.cfg.m0 if layer == 0 else self.cfg.m
            sel = self._select(found, self.cfg.m)
            self.nbrs[nid][layer] = list(sel)
            for nb in sel:
                self.nbrs[nb][layer].append(nid)
                self._prune(nb, layer, cap)
            if found:
                ep = found[0][1]
        if level > self.top_level:
            self.top_level, self.entry = level, nid
        return nid

    def search(self, q: np.ndarray, k: int, ef: int
               ) -> List[Tuple[int, float]]:
        if self.entry < 0 or k <= 0:
            return []
        self.n_searches += 1
        dist_before = self.n_dist
        qs = float(q @ q)
        qn = math.sqrt(qs)
        ep = self.entry
        for layer in range(self.top_level, 0, -1):
            moved = True
            d = self._dist(q, qn, qs, ep)
            while moved:
                moved = False
                for nb in self.nbrs[ep][layer]:
                    dn = self._dist(q, qn, qs, nb)
                    if dn < d:
                        d, ep, moved = dn, nb, True
        found = self._search_layer(q, qn, qs, ep, max(ef, k), 0)
        self.n_search_dist += self.n_dist - dist_before
        return [(i, _similarity(self.cfg.metric, d))
                for d, i in found[:k]]


class HNSWIndex:
    """Multi-layer graph ANN index with per-node storage modes.

    Native C++ core when available (neumann_tpu/native), NumPy
    fallback otherwise. TT nodes are densified at insert — the TPU
    build keeps compressed TT cores in the collection layer — but the
    cores are retained for memory accounting and round-trip.
    """

    def __init__(self, dim: int, config: Optional[HNSWConfig] = None,
                 seed: int = 0xC0FFEE):
        if dim <= 0:
            raise ValueError("dim must be positive")
        self.dim = dim
        self.config = config or HNSWConfig()
        self._kind_counts = {k: 0 for k in _KIND_NAMES}
        self._tt_ids: set = set()
        self._lib = native.load()
        if self._lib is not None:
            self._h = self._lib.nn_hnsw_new(
                dim, self.config.m, self.config.m0,
                self.config.ef_construction,
                _METRIC_IDS[self.config.metric],
                self.config.max_nodes, seed or 1)
            self._py = None
        else:
            self._h = None
            self._py = _PyHnsw(dim, self.config, seed)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and getattr(self, "_lib", None) is not None:
            self._lib.nn_hnsw_free(h)
            self._h = None

    def __len__(self) -> int:
        if self._py is not None:
            return len(self._py)
        return int(self._lib.nn_hnsw_len(self._h))

    # ------------------------------------------------------------ insert
    def _check_vec(self, vector) -> np.ndarray:
        v = np.ascontiguousarray(vector, dtype=np.float32)
        if v.shape != (self.dim,):
            raise ValueError(
                f"expected dim-{self.dim} vector, got shape {v.shape}")
        if not np.all(np.isfinite(v)):
            raise ValueError("vector contains NaN/Inf")
        return v

    def _capacity_check(self):
        if self.config.max_nodes and len(self) >= self.config.max_nodes:
            raise OverflowError(
                f"HNSW index at capacity ({self.config.max_nodes})")

    def _count(self, nid: int, kind: int) -> int:
        if nid < 0:
            raise OverflowError(
                f"HNSW index at capacity ({self.config.max_nodes})")
        self._kind_counts[kind] += 1
        return nid

    def insert(self, vector) -> int:
        v = self._check_vec(vector)
        self._capacity_check()
        if self._py is not None:
            return self._count(self._py.insert(KIND_F32, (v,), v),
                               KIND_F32)
        return self._count(
            self._lib.nn_hnsw_insert(
                self._h, v.ctypes.data_as(_F32P)), KIND_F32)

    def insert_quantized(self, vector) -> int:
        v = self._check_vec(vector)
        self._capacity_check()
        if self._py is not None:
            lo, hi = float(v.min()), float(v.max())
            scale = (hi - lo) / 255.0 or 1.0
            codes = np.clip(np.rint((v - lo) / scale), 0,
                            255).astype(np.uint8)
            deq = (lo + scale * codes.astype(np.float32))
            return self._count(
                self._py.insert(KIND_U8, (codes, scale, lo), deq),
                KIND_U8)
        return self._count(
            self._lib.nn_hnsw_insert_quantized(
                self._h, v.ctypes.data_as(_F32P)), KIND_U8)

    def insert_binary(self, vector) -> int:
        v = self._check_vec(vector)
        self._capacity_check()
        if self._py is not None:
            bits = v > 0
            deq = np.where(bits, 1.0, -1.0).astype(np.float32)
            return self._count(
                self._py.insert(KIND_BIN, (np.packbits(
                    bits, bitorder="little"),), deq), KIND_BIN)
        return self._count(
            self._lib.nn_hnsw_insert_binary(
                self._h, v.ctypes.data_as(_F32P)), KIND_BIN)

    def insert_sparse(self, sparse) -> int:
        """Insert a SparseVector (anything with .positions/.values)."""
        idx = np.ascontiguousarray(sparse.positions, dtype=np.uint32)
        val = np.ascontiguousarray(sparse.values, dtype=np.float32)
        if idx.size and int(idx.max()) >= self.dim:
            raise ValueError("sparse index out of range")
        self._capacity_check()
        if self._py is not None:
            dense = np.zeros(self.dim, np.float32)
            dense[idx] = val
            return self._count(
                self._py.insert(KIND_SPARSE, (idx, val), dense),
                KIND_SPARSE)
        return self._count(
            self._lib.nn_hnsw_insert_sparse(
                self._h, idx.ctypes.data_as(_U32P),
                val.ctypes.data_as(_F32P), len(idx)), KIND_SPARSE)

    def insert_auto(self, vector) -> int:
        """Sparse storage when sparsity exceeds the config threshold
        (hnsw.rs insert_auto semantics)."""
        v = self._check_vec(vector)
        sparsity = float(np.mean(v == 0.0))
        if sparsity > self.config.sparsity_threshold:
            from neumann_tpu_torch.store.sparse import SparseVector

            return self.insert_sparse(SparseVector.from_dense(v))
        return self.insert(v)

    def insert_tt(self, vector, tt_config=None) -> int:
        """TT-compress then insert (densified; cores retained for
        memory accounting)."""
        from neumann_tpu_torch.compress.tensor_train import (
            TTConfig, tt_decompose, tt_reconstruct)

        v = self._check_vec(vector)
        tt = tt_decompose(v, tt_config or TTConfig.for_dim(self.dim))
        nid = self.insert(np.asarray(tt_reconstruct(tt),
                                     dtype=np.float32))
        self._tt_ids.add(nid)
        return nid

    # ------------------------------------------------------------ search
    def search(self, query, k: int) -> List[Tuple[int, float]]:
        return self.search_with_ef(query, k, self.config.ef_search)

    def search_with_ef(self, query, k: int, ef: int
                       ) -> List[Tuple[int, float]]:
        q = self._check_vec(query)
        if k <= 0 or len(self) == 0:
            return []
        if self._py is not None:
            return self._py.search(q, k, ef)
        out_ids = np.empty(k, np.int64)
        out_scores = np.empty(k, np.float32)
        n = self._lib.nn_hnsw_search(
            self._h, q.ctypes.data_as(_F32P), k, max(ef, k),
            out_ids.ctypes.data_as(_I64P),
            out_scores.ctypes.data_as(_F32P))
        return [(int(out_ids[i]), float(out_scores[i]))
                for i in range(n)]

    def search_sparse(self, sparse, k: int,
                      ef: Optional[int] = None) -> List[Tuple[int, float]]:
        dense = np.zeros(self.dim, np.float32)
        idx = np.asarray(sparse.positions, dtype=np.int64)
        dense[idx] = np.asarray(sparse.values, dtype=np.float32)
        return self.search_with_ef(dense, k,
                                   ef or self.config.ef_search)

    def get(self, node_id: int) -> Optional[np.ndarray]:
        """Reconstruct the stored (possibly lossy) vector."""
        if node_id < 0 or node_id >= len(self):
            return None
        if self._py is not None:
            return self._py.dense[node_id].copy()
        out = np.empty(self.dim, np.float32)
        if self._lib.nn_hnsw_get(self._h, node_id,
                                 out.ctypes.data_as(_F32P)) != 0:
            return None
        return out

    def access_stats(self) -> dict:
        """HNSWStatsSnapshot parity (instrumentation.rs:359-373):
        searches, inserts, query-path distance calculations."""
        if self._py is not None:
            s, i, d, sd = (self._py.n_searches, self._py.n_inserts,
                           self._py.n_dist, self._py.n_search_dist)
        else:
            import ctypes as ct

            out = (ct.c_uint64 * 4)()
            self._lib.nn_hnsw_stats(self._h, out)
            s, i, d, sd = (int(out[0]), int(out[1]), int(out[2]),
                           int(out[3]))
        return {"total_searches": s, "total_inserts": i,
                "distance_calculations": d,
                "avg_distances_per_search": (sd / s) if s else 0.0}

    def memory_stats(self) -> dict:
        """HNSWMemoryStats parity (hnsw.rs:1484-1503)."""
        if self._py is not None:
            emb = sum(p[0].nbytes if isinstance(p[0], np.ndarray)
                      else 0 for p in self._py.payloads)
        else:
            emb = int(self._lib.nn_hnsw_memory_bytes(self._h))
        tt = len(self._tt_ids)
        return {
            "total_nodes": len(self),
            "dense_count": self._kind_counts[KIND_F32] - tt,
            "sparse_count": self._kind_counts[KIND_SPARSE],
            "quantized_count": self._kind_counts[KIND_U8],
            "binary_count": self._kind_counts[KIND_BIN],
            "tt_count": tt,
            "embedding_bytes": emb,
        }

    # ----------------------------------------------------- serialization
    def to_bytes(self) -> bytes:
        if self._py is None:
            need = self._lib.nn_hnsw_serialize(self._h, None, 0)
            buf = np.empty(need, np.uint8)
            self._lib.nn_hnsw_serialize(
                self._h, buf.ctypes.data_as(_U8P), need)
            core = buf.tobytes()
        else:
            core = _py_serialize(self._py)
        tt = struct.pack("<I", len(self._tt_ids)) + b"".join(
            struct.pack("<q", i) for i in sorted(self._tt_ids))
        counts = struct.pack("<4I", *(self._kind_counts[k]
                                      for k in range(4)))
        return b"NHNW" + counts + tt + core

    @classmethod
    def from_bytes(cls, data: bytes) -> "HNSWIndex":
        if data[:4] != b"NHNW":
            raise ValueError("not an HNSW index blob")
        counts = struct.unpack("<4I", data[4:20])
        ntt, = struct.unpack("<I", data[20:24])
        pos = 24
        if pos + 8 * ntt > len(data):
            raise ValueError("corrupt HNSW blob: bad tt count")
        tt_ids = set(struct.unpack(f"<{ntt}q",
                                   data[pos:pos + 8 * ntt]))
        pos += 8 * ntt
        core = data[pos:]
        lib = native.load()
        if lib is not None:
            h = lib.nn_hnsw_deserialize(
                np.frombuffer(core, np.uint8).ctypes.data_as(_U8P),
                len(core))
            if not h:
                raise ValueError("corrupt HNSW blob")
            ix = cls.__new__(cls)
            ix._lib = lib
            ix._h = h
            ix._py = None
            hdr = _parse_header(core)
        else:
            try:
                py = _py_deserialize(core)
            except (struct.error, IndexError) as e:
                raise ValueError(f"corrupt HNSW blob: {e}") from None
            ix = cls.__new__(cls)
            ix._lib = None
            ix._h = None
            ix._py = py
            hdr = (py.dim, py.cfg)
        ix.dim, ix.config = hdr[0], hdr[1]
        ix._kind_counts = dict(enumerate(counts))
        ix._tt_ids = tt_ids
        return ix

    def save(self, path) -> None:
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            f.write(self.to_bytes())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path) -> "HNSWIndex":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())


import ctypes as _ct  # noqa: E402  (kept local to the wrapper)

_F32P = _ct.POINTER(_ct.c_float)
_U32P = _ct.POINTER(_ct.c_uint32)
_I64P = _ct.POINTER(_ct.c_int64)
_U8P = _ct.POINTER(_ct.c_uint8)

_HDR = struct.Struct("<5i2Qqi Q".replace(" ", ""))


def _parse_header(core: bytes) -> tuple:
    if core[:4] != b"NHN1":
        raise ValueError("corrupt HNSW core blob")
    dim, m, m0, efc, metric_id, max_nodes, _rng, _entry, _top, _n = \
        _HDR.unpack_from(core, 4)
    metric = {v: k for k, v in _METRIC_IDS.items()}.get(metric_id)
    if metric is None:
        raise ValueError(f"corrupt HNSW blob: bad metric {metric_id}")
    cfg = HNSWConfig(m=m, m0=m0, ef_construction=efc,
                     max_nodes=max_nodes, metric=metric)
    return dim, cfg


def _py_serialize(py: _PyHnsw) -> bytes:
    out = bytearray(b"NHN1")
    out += _HDR.pack(py.dim, py.cfg.m, py.cfg.m0,
                     py.cfg.ef_construction,
                     _METRIC_IDS[py.cfg.metric], py.cfg.max_nodes,
                     1, py.entry, py.top_level, len(py.dense))
    words = (py.dim + 63) // 64
    for i in range(len(py.dense)):
        kind = py.kinds[i]
        scale = bias = 0.0
        if kind == KIND_U8:
            _codes, scale, bias = py.payloads[i]
        out += struct.pack("<Bi4f", kind, py.levels[i], scale, bias,
                           py.norms[i], py.sumsqs[i])
        if kind == KIND_F32:
            out += py.payloads[i][0].astype("<f4").tobytes()
        elif kind == KIND_U8:
            out += py.payloads[i][0].tobytes()
        elif kind == KIND_BIN:
            packed = py.payloads[i][0]
            padded = np.zeros(words * 8, np.uint8)
            padded[:len(packed)] = packed
            out += padded.tobytes()
        else:
            idx, val = py.payloads[i]
            out += struct.pack("<I", len(idx))
            out += idx.astype("<u4").tobytes()
            out += val.astype("<f4").tobytes()
        for layer in range(py.levels[i] + 1):
            lst = py.nbrs[i][layer]
            out += struct.pack("<I", len(lst))
            out += np.asarray(lst, "<u4").tobytes()
    return bytes(out)


def _py_deserialize(core: bytes) -> _PyHnsw:
    dim, cfg = _parse_header(core)
    (_, _, _, _, _, _, _rng, entry, top, n) = _HDR.unpack_from(core, 4)
    py = _PyHnsw(dim, cfg, 1)
    py.entry, py.top_level = entry, top
    pos = 4 + _HDR.size
    words = (dim + 63) // 64
    node = struct.Struct("<Bi4f")
    for _ in range(n):
        kind, level, scale, bias, norm, sumsq = node.unpack_from(
            core, pos)
        pos += node.size
        if not 0 <= level <= 63:
            raise ValueError("corrupt HNSW blob: bad level")
        if kind == KIND_F32:
            v = np.frombuffer(core, "<f4", dim, pos).copy()
            pos += 4 * dim
            payload, dense = (v,), v
        elif kind == KIND_U8:
            codes = np.frombuffer(core, np.uint8, dim, pos).copy()
            pos += dim
            payload = (codes, scale, bias)
            dense = (bias + scale * codes.astype(np.float32))
        elif kind == KIND_BIN:
            raw = np.frombuffer(core, np.uint8, words * 8, pos).copy()
            pos += words * 8
            bits = np.unpackbits(raw, bitorder="little")[:dim]
            payload = (raw,)
            dense = np.where(bits > 0, 1.0, -1.0).astype(np.float32)
        elif kind == KIND_SPARSE:
            nnz, = struct.unpack_from("<I", core, pos)
            pos += 4
            idx = np.frombuffer(core, "<u4", nnz, pos).copy()
            pos += 4 * nnz
            val = np.frombuffer(core, "<f4", nnz, pos).copy()
            pos += 4 * nnz
            payload = (idx, val)
            dense = np.zeros(dim, np.float32)
            dense[idx] = val
        else:
            raise ValueError(f"corrupt HNSW blob: bad kind {kind}")
        py.kinds.append(kind)
        py.levels.append(level)
        py.payloads.append(payload)
        py.dense.append(dense)
        py.norms.append(norm)
        py.sumsqs.append(sumsq)
        layers = []
        for _l in range(level + 1):
            cnt, = struct.unpack_from("<I", core, pos)
            pos += 4
            layers.append(
                np.frombuffer(core, "<u4", cnt, pos).astype(int)
                .tolist())
            pos += 4 * cnt
        py.nbrs.append(layers)
    return py

"""Vector engine: embedding storage + similarity search on one GPU (port
of ``neumann_tpu/engines/vector.py``).

The TensorStore stays authoritative (keys ``emb:{key}``,
``entity:{key}``, ``col:{name}:{key}``); the engine mirrors puts/deletes
into one device corpus (EmbeddingSlab) per namespace ("" default,
"entity", "col/{name}") and dimension through store hooks, so WAL replay
rebuilds the device state. Search routes, in the JAX engine's order:

* cosine (and angular/geodesic, which order by cosine) against a corpus
  of at least ``ivf_auto_threshold`` rows, unfiltered, stored as none or
  int8: the auto IVF index (``ops/ivf.DeviceIVFInt8``), built on the
  first query. Batches of up to ``ivf_auto_max_batch`` queries take the
  latency path (probe kernel), larger ones the batched path (top-2
  kernel). Rows mutated after the build are dropped from the index
  results and rescanned exactly at their current values;
* binary storage: hamming top-k over packed sign bits (hamming kernel),
  score -distance;
* pq storage: an ADC scan (``ops/pq.pq_topk``, the ADC kernel) over a
  codebook trained on every live row, cached under the slab's version;
  score 1 / (1 + distance);
* tt storage: rows decomposed into tensor-train cores on the device
  (``compress/tt_batch``, cached under the slab's version), rebuilt at
  each search for the exact scan;
* int8 storage, cosine / dot / euclidean: the pooled-bits int8 scan and
  an exact f32 rerank (int8 pooled kernel) where the pooled gate passes
  (``_pooled_pool``: cosine, dense, enough pools), else the int8 scan
  (int8 scores kernel);
* unquantized cosine past the pooled gate (by default 256K rows and
  2,048 pools): the f32 pooled-bits scan and an exact rerank (f32
  pooled kernel);
* everything else: the exact f32 scan (``ops/scan.topk_scan``) over the
  slab's device view.

Metadata filters are a host-evaluated row mask fused into each route.

The ANN index APIs: ``build_ivf_index`` / ``search_with_ivf_nprobe``
(the legacy ``ops/ivf.IVFIndex`` on the device), ``build_hnsw_index`` /
``search_with_hnsw`` (the host HNSW graph, ``ops/hnsw``), and
``save_index`` / ``load_index`` in the JAX engine's ``.npz`` format.

Not ported yet (raises ``NotImplementedError`` naming its ROADMAP item):
the scan limits. One card places no corpus on a mesh.

Every tensor lives on the engine's ``device`` (default "cuda"); nothing
switches to the CPU on its own.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from neumann_tpu_torch.ops.quant import (
    _pick_pool,
    binary_quantize,
    hamming_topk,
    int8_topk_scan,
)
from neumann_tpu_torch.ops.rerank import (
    f32_pooled_rerank_topk,
    int8_pooled_rerank_topk,
)
from neumann_tpu_torch.ops.scan import METRICS, host_pull, topk_scan
from neumann_tpu_torch.store.embedding_slab import EmbeddingSlab
from neumann_tpu_torch.store.entity_index import EntityIndex
from neumann_tpu_torch.store.tensor_store import (
    TensorData,
    TensorStore,
    TensorValue,
)
from neumann_tpu_torch.utils.errors import VectorError

EMB_PREFIX = "emb:"
ENTITY_PREFIX = "entity:"
COLLECTION_PREFIX = "col:"
_EMBEDDING_FIELD = "embedding"

QUANTIZATIONS = ("none", "int8", "binary", "pq", "tt")
# a large ingest (ingest_matrix, or a bulk_ingest flush) freezes the
# garbage collector's view of the heap past this many rows (see
# ingest_matrix)
_GC_FREEZE_MIN_ROWS = 1 << 16


# ---------------------------------------------------------------------------
# results / filters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SearchResult:
    """Key + similarity score."""

    key: str
    score: float


@dataclass(frozen=True)
class FilterCondition:
    """Metadata filter tree (eq/ne/lt/le/gt/ge/exists/contains/
    starts_with/in/true/and/or), evaluated on the host into a row mask."""

    op: str
    fieldname: Optional[str] = None
    value: object = None
    left: Optional["FilterCondition"] = None
    right: Optional["FilterCondition"] = None

    @staticmethod
    def eq(f, v):
        return FilterCondition("eq", f, v)

    @staticmethod
    def ne(f, v):
        return FilterCondition("ne", f, v)

    @staticmethod
    def lt(f, v):
        return FilterCondition("lt", f, v)

    @staticmethod
    def le(f, v):
        return FilterCondition("le", f, v)

    @staticmethod
    def gt(f, v):
        return FilterCondition("gt", f, v)

    @staticmethod
    def ge(f, v):
        return FilterCondition("ge", f, v)

    @staticmethod
    def exists(f):
        return FilterCondition("exists", f)

    @staticmethod
    def contains(f, s):
        return FilterCondition("contains", f, s)

    @staticmethod
    def starts_with(f, s):
        return FilterCondition("starts_with", f, s)

    @staticmethod
    def in_(f, values):
        return FilterCondition("in", f, tuple(values))

    @staticmethod
    def true():
        return FilterCondition("true")

    def and_(self, other):
        return FilterCondition("and", left=self, right=other)

    def or_(self, other):
        return FilterCondition("or", left=self, right=other)

    def evaluate(self, metadata: Dict[str, object]) -> bool:
        op = self.op
        if op == "true":
            return True
        if op == "and":
            return self.left.evaluate(metadata) and self.right.evaluate(
                metadata)
        if op == "or":
            return self.left.evaluate(metadata) or self.right.evaluate(
                metadata)
        if op == "exists":
            return self.fieldname in metadata
        have = self.fieldname in metadata
        val = metadata.get(self.fieldname)
        if op == "eq":
            return have and val == self.value
        if op == "ne":
            return have and val != self.value
        if op in ("lt", "le", "gt", "ge"):
            if not have:
                return False
            try:
                if op == "lt":
                    return val < self.value
                if op == "le":
                    return val <= self.value
                if op == "gt":
                    return val > self.value
                return val >= self.value
            except TypeError:
                return False
        if op == "contains":
            return have and isinstance(val, str) and self.value in val
        if op == "starts_with":
            return have and isinstance(val, str) and val.startswith(
                self.value)
        if op == "in":
            return have and val in self.value
        raise VectorError(f"unknown filter op {op}")


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclass
class VectorEngineConfig:
    """The JAX package's VectorEngineConfig: every field, with the same
    names and defaults, and its two presets.

    On one card some fields have one meaning only:

    * ``pooled_selector``: every value takes the exact cut (torch has
      no ``approx_max_k``), so "approx" and "approx:<target>" give the
      "topk" results;
    * ``mesh_auto`` / ``mesh_threshold``: one card is no mesh, so no
      corpus is ever placed on one (the mesh is ROADMAP item 12).

    ``max_keys_per_scan`` and ``search_timeout_s`` (set by
    ``low_memory()``) are accepted and enforced by neither engine: the
    JAX engine reads neither, so an engine on that preset answers as the
    JAX engine does.
    """

    default_dimension: Optional[int] = None
    sparse_threshold: float = 0.5
    default_metric: str = "cosine"
    max_dimension: Optional[int] = None
    max_keys_per_scan: Optional[int] = None
    search_timeout_s: Optional[float] = None
    # auto IVF routing: cosine corpora of at least this many rows
    # search through the windowed int8 IVF index
    ivf_auto: bool = True
    ivf_auto_threshold: int = 4_000_000
    ivf_auto_max_batch: int = 32
    # batches past ivf_auto_max_batch take the batched kernel path
    ivf_auto_batched: bool = True
    ivf_auto_clusters: int = 1024
    ivf_auto_nprobe: int = 64
    ivf_auto_rebuild_frac: float = 0.02
    # second int8 plane of the quantization error (rerank at ~int16
    # fidelity), unless the plane would exceed the byte cap
    ivf_auto_residual: bool = True
    ivf_auto_residual_max_bytes: int = 4 << 30
    pooled_selector: str = "topk"
    mesh_auto: bool = True
    mesh_threshold: int = 262_144

    @staticmethod
    def high_throughput() -> "VectorEngineConfig":
        return VectorEngineConfig()

    @staticmethod
    def low_memory() -> "VectorEngineConfig":
        return VectorEngineConfig(
            sparse_threshold=0.3, max_dimension=4096,
            max_keys_per_scan=10_000, search_timeout_s=30.0)

    def validate(self) -> None:
        if self.default_metric not in METRICS:
            raise VectorError(f"bad metric {self.default_metric}")
        if not (0.0 <= self.sparse_threshold <= 1.0):
            raise VectorError("sparse_threshold must be in [0,1]")
        if self.max_dimension is not None and self.max_dimension <= 0:
            raise VectorError("max_dimension must be positive")


@dataclass
class VectorCollectionConfig:
    """Per-collection config (dimension enforced, metric, storage mode)."""

    dimension: Optional[int] = None
    metric: str = "cosine"
    quantization: str = "none"  # none | int8 | binary | pq | tt

    def validate(self) -> None:
        if self.metric not in METRICS:
            raise VectorError(f"bad metric {self.metric}")
        if self.quantization not in QUANTIZATIONS:
            raise VectorError(f"bad quantization {self.quantization}")
        if self.dimension is not None and self.dimension <= 0:
            raise VectorError("dimension must be positive")


# ---------------------------------------------------------------------------
# corpus: one device-searchable namespace
# ---------------------------------------------------------------------------

class _Corpus:
    """EntityIndex + EmbeddingSlab + host metadata for one namespace and
    dimension."""

    def __init__(self, dim: int, device):
        self.dim = dim
        self.index = EntityIndex()
        self.slab = EmbeddingSlab(dim, device=device)
        self.meta: Dict[int, Dict[str, object]] = {}
        self.lock = threading.RLock()
        # serializes auto-IVF (re)builds
        self.build_lock = threading.Lock()
        self._auto_ivf = None
        self._auto_ivf_delta = None
        # (slab version, ...) of the pq / tt storage routes
        self._pq = None
        self._tt = None

    def upsert(self, key: str, vec: np.ndarray,
               metadata: Optional[Dict[str, object]] = None) -> int:
        with self.lock:
            row = self.index.get_or_insert(key)
            self.slab.set_row(row, vec)
            if metadata is not None:
                self.meta[row] = dict(metadata)
            else:
                self.meta.pop(row, None)
            return row

    def remove(self, key: str) -> bool:
        with self.lock:
            row = self.index.remove(key)
            if row is None:
                return False
            self.slab.clear_row(row)
            self.meta.pop(row, None)
            return True

    def count(self) -> int:
        return len(self.index)

    def filter_mask(self, cond: FilterCondition) -> np.ndarray:
        """Host-evaluated metadata filter -> row bitmask."""
        mask = np.zeros(self.slab.capacity, dtype=bool)
        with self.lock:
            for _key, row in self.index.items():
                if cond.evaluate(self.meta.get(row, {})):
                    mask[row] = True
        return mask


def _euclid_report(score: float) -> float:
    """Internal -dist -> the 1/(1+dist) display score."""
    return 1.0 / (1.0 + max(-score, 0.0))


def _pooled_pool(corpus: _Corpus, k: int, metric: str,
                 extra_mask) -> Optional[int]:
    """Gate + pool size for the pooled-bits scans, or None to fall back
    (the JAX engine's gate, same environment overrides).

    Pooled selection keeps ONE row per pool, so it needs a dense corpus
    and many pools: a true top-k row is lost only when a better one
    shares its pool, expected loss ~(k-1)/(2 npools). A metadata filter
    is known on the host, so its actual pool occupancy is checked."""
    if metric != "cosine":
        return None
    cap = corpus.slab.capacity
    used = corpus.slab.valid_count()
    pooled_min = int(os.environ.get("NEUMANN_POOLED_MIN_ROWS", 256 * 1024))
    min_pools = max(int(os.environ.get("NEUMANN_POOLED_MIN_POOLS", 2048)),
                    32 * k)
    if used < pooled_min or used * 2 < cap:
        return None
    pool_cap = min(4096, max(8, cap // max(min_pools, 1)))
    pool = _pick_pool(cap, k, pool_cap)
    if pool is None or cap // pool < min_pools:
        return None
    if extra_mask is not None:
        m = np.asarray(extra_mask, bool)[:cap]
        nonempty = int(m.reshape(-1, pool).any(axis=1).sum())
        if nonempty < max(min_pools, 8 * k):
            return None
    return pool


def _scan_k_metric(corpus: _Corpus, top_k: int,
                   metric: str) -> Tuple[int, str]:
    """(k, metric) as the brute-force routes take them: k within 1 and
    the slab's rows, angular / geodesic ordered by cosine."""
    k = max(1, min(top_k, corpus.slab.capacity))
    return k, "cosine" if metric in ("angular", "geodesic") else metric


def _brute_route(corpus: _Corpus, k: int, metric: str, extra_mask,
                 quantization: str) -> Tuple[str, Optional[int]]:
    """(route, pool) of ``VectorEngine._device_search``: "pq", "tt",
    "binary", "int8_pooled" or "int8_scan", "f32_pooled", or "exact"
    (the f32 scan); ``pool`` only for the pooled routes. ``k`` and
    ``metric`` as ``_scan_k_metric`` gives them."""
    if quantization in ("pq", "tt", "binary"):
        return quantization, None
    if quantization == "int8" and metric in ("cosine", "dot", "euclidean"):
        pool = _pooled_pool(corpus, k, metric, extra_mask)
        return ("int8_scan", None) if pool is None else ("int8_pooled", pool)
    pool = (_pooled_pool(corpus, k, metric, extra_mask)
            if quantization == "none" else None)
    return ("exact", None) if pool is None else ("f32_pooled", pool)


class VectorEngine:
    def __init__(self, store: Optional[TensorStore] = None,
                 config: Optional[VectorEngineConfig] = None,
                 device="cuda"):
        self.store = store if store is not None else TensorStore()
        self.config = config or VectorEngineConfig()
        self.config.validate()
        self.device = torch.device(device)
        # namespace ("" | "entity" | "col/{name}") -> dim -> corpus
        self._corpora: Dict[str, Dict[int, _Corpus]] = {}
        self._collections: Dict[str, VectorCollectionConfig] = {}
        self._lock = threading.RLock()
        # bulk-ingest mode: queued (ns, key, vec, metadata) puts, flushed
        # as one vectorized set_rows per (namespace, dim)
        self._bulk: Optional[list] = None
        # the ANN index APIs' state: (index, corpus, row ids)
        self._ivf = None
        self._hnsw = None
        # store writes seen: every put and delete (the hooks below see
        # every key, not only embeddings) and each columnar ingest; the
        # router's query cache holds results while it stands still
        self.writes = 0
        # set while the store is cleared and reloaded (``restoring``)
        self._restoring = False
        self.store.on_put(self._on_store_put)
        self.store.on_delete(self._on_store_delete)

    # ------------------------------------------------------------------
    # store-hook mirroring
    # ------------------------------------------------------------------
    @staticmethod
    def _parse_key(key: str) -> Optional[Tuple[str, str]]:
        """Store key -> (namespace, inner key), or None for keys that
        are not embeddings."""
        if key.startswith(EMB_PREFIX):
            return "", key[len(EMB_PREFIX):]
        if key.startswith(ENTITY_PREFIX):
            return "entity", key[len(ENTITY_PREFIX):]
        if key.startswith(COLLECTION_PREFIX):
            name, sep, inner = key[len(COLLECTION_PREFIX):].partition(":")
            if sep:
                return f"col/{name}", inner
        return None

    def _on_store_put(self, key: str, data: TensorData) -> None:
        self.writes += 1
        parsed = self._parse_key(key)
        if parsed is None:
            return
        ns, inner = parsed
        emb = data.get(_EMBEDDING_FIELD)
        if emb is None or not emb.is_vector():
            return
        vec = emb.to_dense()
        metadata = {n: v.value for n, v in data.fields.items()
                    if n != _EMBEDDING_FIELD and v.kind == "scalar"}
        with self._lock:
            if self._bulk is not None:
                self._bulk.append((ns, inner, vec, metadata or None))
                return
        self._corpus_for(ns, len(vec), create=True).upsert(
            inner, vec, metadata or None)

    def bulk_ingest(self):
        """Context manager: defer slab writes during mass ingestion and
        flush one vectorized ``set_rows`` per (namespace, dim) at exit
        (searches flush first, so visibility matches the per-row path).
        Reentrant."""
        @contextlib.contextmanager
        def _cm():
            with self._lock:
                nested = self._bulk is not None
                if not nested:
                    self._bulk = []
            try:
                yield self
            finally:
                if not nested:
                    self._flush_bulk(end=True)

        return _cm()

    def _flush_bulk(self, end: bool = False) -> None:
        with self._lock:
            pending = self._bulk
            self._bulk = None if (end or pending is None) else []
        if not pending:
            return
        groups: Dict[Tuple[str, int], list] = {}
        for item in pending:
            groups.setdefault((item[0], len(item[2])), []).append(item)
        for (ns, dim), items in groups.items():
            corpus = self._corpus_for(ns, dim, create=True)
            with corpus.lock:
                rows = np.fromiter(
                    (corpus.index.get_or_insert(it[1]) for it in items),
                    np.int64, count=len(items))
                corpus.slab.set_rows(rows, np.stack([it[2] for it in items]))
                for row, it in zip(rows, items):
                    if it[3] is not None:
                        corpus.meta[int(row)] = dict(it[3])
                    else:
                        corpus.meta.pop(int(row), None)
        if len(pending) >= _GC_FREEZE_MIN_ROWS:
            # as after a large ingest_matrix. Without it the young
            # collections of the next queries took 30-48 ms each after a
            # 1M-row flush (H100 host), against at most 2 ms with it; no
            # full collection ran in either case
            gc.freeze()

    def _flush_bulk_if_pending(self) -> None:
        if self._bulk:
            self._flush_bulk()

    def _on_store_delete(self, key: str) -> None:
        self.writes += 1
        parsed = self._parse_key(key)
        if parsed is None:
            return
        # a queued bulk put of this key must land before the delete
        self._flush_bulk_if_pending()
        ns, inner = parsed
        with self._lock:
            corpora = list(self._corpora.get(ns, {}).values())
        for corpus in corpora:
            corpus.remove(inner)
            if self._restoring and corpus.count() == 0:
                with corpus.lock:
                    corpus.index = EntityIndex()

    @contextlib.contextmanager
    def restoring(self):
        """Context manager around a store cleared and reloaded (ROLLBACK):
        a corpus the clear empties hands out rows from 0 again, not the
        free list's reverse, so the reload gives keys rows in the
        snapshot's order. Where the rows were in put order at the
        checkpoint (no delete freed a row a later key took), each key
        gets its row back and equal scores break as they did; otherwise
        only the scores and the hits off the last tied score are kept.
        A plain delete keeps the free list, as the JAX engine does."""
        self._restoring = True
        try:
            yield
        finally:
            self._restoring = False

    def _corpus_for(self, ns: str, dim: int, create: bool) -> _Corpus:
        with self._lock:
            by_dim = self._corpora.setdefault(ns, {})
            corpus = by_dim.get(dim)
            if corpus is None:
                if not create:
                    raise VectorError(f"no embeddings of dimension {dim}")
                corpus = by_dim[dim] = _Corpus(dim, self.device)
            return corpus

    # ------------------------------------------------------------------
    # embedding storage
    # ------------------------------------------------------------------
    def _validate_vec(self, embedding, dim_hint: Optional[int] = None
                      ) -> np.ndarray:
        if hasattr(embedding, "to_dense"):
            embedding = embedding.to_dense()
        vec = np.asarray(embedding, dtype=np.float32)
        if vec.ndim != 1 or vec.size == 0:
            raise VectorError("embedding must be a non-empty 1-D vector")
        if self.config.max_dimension and vec.size > self.config.max_dimension:
            raise VectorError(
                f"dimension {vec.size} exceeds max {self.config.max_dimension}")
        want = dim_hint or self.config.default_dimension
        if want and vec.size != want:
            raise VectorError(
                f"dimension mismatch: expected {want}, got {vec.size}")
        return vec

    def store_embedding(self, key: str, embedding,
                        metadata: Optional[Dict[str, object]] = None) -> None:
        vec = self._validate_vec(embedding)
        data = TensorData()
        data.set(_EMBEDDING_FIELD, TensorValue.from_embedding(
            vec, sparsity_threshold=1.01
            if self.config.sparse_threshold >= 1.0
            else max(self.config.sparse_threshold, 0.0)))
        for n, v in (metadata or {}).items():
            data.set(n, TensorValue.scalar(v))
        self.store.put(EMB_PREFIX + key, data)

    def batch_store_embeddings(
            self, items: Sequence[Tuple[str, object]]) -> int:
        with self.bulk_ingest():
            for key, emb in items:
                self.store_embedding(key, emb)
        return len(items)

    _INGEST_SAFE_HOOKS = frozenset((
        # hooks that ignore (or are superseded by) a direct emb:*
        # columnar write; anything else forces the per-row path
        "VectorEngine._on_store_put",
        "RelationalEngine._on_store_put",
        "GraphEngine._on_store_put",
    ))

    def ingest_matrix(self, keys: Sequence[str], matrix, ns: str = "",
                      copy: bool = True) -> int:
        """Columnar mass ingest: one [N, d] matrix + N keys through the
        store map, entity index and slab, vectorized, into the default
        namespace (``ns=""``, keys ``emb:``) or the entity namespace
        (``ns="entity"``, keys ``entity:``). Equivalent to
        batch_store_embeddings(zip(keys, matrix)) without metadata;
        embeddings are stored dense.

        With ``copy=False``, a fresh slab whose padded dim equals d, and
        keys that map to rows exactly 0..N-1 in order, the slab ADOPTS
        the buffer zero-copy (the caller must not mutate it afterwards).
        Any other row order copies: adopting would bind row i's vector
        to the wrong key.

        Falls back to the per-row path when the store has a WAL, a
        recovery overlay, or a put hook other than the engines' own —
        into the SAME namespace (the JAX engine's fallback writes every
        row to the default namespace, whatever ``ns`` is)."""
        matrix = np.ascontiguousarray(matrix, dtype=np.float32)
        if matrix.ndim != 2 or len(keys) != matrix.shape[0]:
            raise VectorError("ingest_matrix expects keys + [N, d]")
        if ns == "":
            prefix, put_row = EMB_PREFIX, self.store_embedding
        elif ns == "entity":
            prefix, put_row = ENTITY_PREFIX, self.store_entity_embedding
        else:
            raise VectorError(f"ingest_matrix: unsupported ns {ns!r}")
        store = self.store
        hooks_ok = all(
            getattr(getattr(h, "__func__", None), "__qualname__", "")
            in self._INGEST_SAFE_HOOKS for h in store._put_hooks)
        if store._wal is not None or store._ov_cap is not None \
                or not hooks_ok:
            with self.bulk_ingest():
                for i, key in enumerate(keys):
                    put_row(key, matrix[i])
            return len(keys)
        self._flush_bulk_if_pending()
        key_list = keys if isinstance(keys, list) else list(keys)
        corpus = self._corpus_for(ns, matrix.shape[1], create=True)
        with corpus.lock:
            rows = corpus.index.get_or_insert_many(key_list)
            adopted = False
            if not copy and rows.size and \
                    np.array_equal(rows, np.arange(rows.size)):
                adopted = corpus.slab.adopt_matrix(matrix)
            if not adopted:
                corpus.slab.set_rows(rows, matrix)
        m = store._map
        pend = store._pending_keys
        fast = None
        try:
            from neumann_tpu_torch.native import pycodec

            fast = pycodec.load()
        except Exception:   # noqa: BLE001 — pure-Python fallback below
            pass
        if fast is not None and hasattr(fast, "bulk_embed_entries"):
            fast.bulk_embed_entries(m, pend, prefix, key_list, matrix,
                                    _EMBEDDING_FIELD)
        else:
            for i, key in enumerate(key_list):
                full = prefix + key
                m[full] = TensorData({_EMBEDDING_FIELD: TensorValue(
                    "vector", matrix[i])})
                pend.append(full)
        self.writes += 1
        if len(key_list) >= _GC_FREEZE_MIN_ROWS:
            # the store now holds several long-lived Python objects per row;
            # the interpreter's next full collection walks all of them
            # (one 2.09 s pause inside the first 64 SIMILARs after a
            # 4.19M-row ingest, H100 host). Freezing moves every object
            # alive now out of the collector's generations; reference
            # counting still frees them.
            gc.freeze()
        return len(key_list)

    def get_embedding(self, key: str) -> Optional[np.ndarray]:
        data = self.store.get(EMB_PREFIX + key)
        if data is None:
            return None
        emb = data.get(_EMBEDDING_FIELD)
        return None if emb is None else emb.to_dense()

    def get_metadata(self, key: str) -> Optional[Dict[str, object]]:
        data = self.store.get(EMB_PREFIX + key)
        if data is None:
            return None
        return {n: v.value for n, v in data.fields.items()
                if n != _EMBEDDING_FIELD and v.kind == "scalar"}

    def delete_embedding(self, key: str) -> bool:
        return self.store.delete(EMB_PREFIX + key)

    def embedding_exists(self, key: str) -> bool:
        return self.store.exists(EMB_PREFIX + key)

    def count_embeddings(self) -> int:
        return self.store.scan_count(EMB_PREFIX)

    def list_embeddings(self, limit: Optional[int] = None) -> List[str]:
        keys = [k[len(EMB_PREFIX):] for k in self.store.scan(EMB_PREFIX)]
        return keys[:limit] if limit else keys

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------
    def _results(self, corpus: _Corpus, scores: np.ndarray, ids: np.ndarray,
                 top_k: int, map_score) -> List[List[SearchResult]]:
        """Host (scores, row ids) -> per-query hits; one index lock for
        the whole key lookup. As in the JAX engine, only ids below 0 and
        rows whose key is gone are skipped: a row scoring NaN or +-inf
        is a hit."""
        flat_ids = ids.reshape(-1).tolist()
        flat_keys = corpus.index.keys_of(flat_ids)
        width = ids.shape[1]
        out: List[List[SearchResult]] = []
        for qi in range(ids.shape[0]):
            row: List[SearchResult] = []
            base = qi * width
            for j, s in enumerate(scores[qi].tolist()):
                if len(row) >= top_k:
                    break
                key = flat_keys[base + j]
                if flat_ids[base + j] >= 0 and key is not None:
                    row.append(SearchResult(key, map_score(s)))
            out.append(row)
        return out

    def _device_search(self, corpus: _Corpus, queries: np.ndarray,
                       top_k: int, metric: str,
                       extra_mask: Optional[np.ndarray] = None,
                       quantization: str = "none"
                       ) -> List[List[SearchResult]]:
        """The brute-force routes (see the module docstring) over one
        corpus; a metadata filter is a row mask fused into each."""
        angular = metric in ("angular", "geodesic")
        k, metric = _scan_k_metric(corpus, top_k, metric)
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != corpus.dim:
            raise VectorError(f"query dimension {q.shape[1]} != corpus "
                              f"dimension {corpus.dim}")
        qp = np.zeros((q.shape[0], corpus.slab.dim_pad), np.float32)
        qp[:, :corpus.dim] = q
        qd = torch.from_numpy(qp).to(self.device)

        def row_mask(valid):
            if extra_mask is None:
                return valid
            return valid & torch.from_numpy(
                np.asarray(extra_mask, bool)).to(self.device)

        route, pool = _brute_route(corpus, k, metric, extra_mask,
                                   quantization)
        if route == "pq":
            return self._pq_search(corpus, qd, top_k, extra_mask)
        if route == "tt":
            scores, idx = self._tt_scan(corpus, qd, k, metric, extra_mask)
        elif route == "binary":
            bits, valid = corpus.slab.quantized_view("binary")
            scores, idx = hamming_topk(bits, binary_quantize(qd), k,
                                       row_mask(valid))
        elif route == "int8_pooled":
            cq, cs, rmult, valid = corpus.slab.quantized_view("int8c")
            scores, idx = int8_pooled_rerank_topk(
                cq, cs, qd, k, pool=pool, mask=row_mask(valid),
                row_mult=rmult)
        elif route == "int8_scan":
            cq, cs, valid = corpus.slab.quantized_view("int8")
            scores, idx = int8_topk_scan(cq, cs, qd, k, metric,
                                         row_mask(valid))
        elif route == "f32_pooled":
            emb, rmult, valid = corpus.slab.quantized_view("f32c")
            scores, idx = f32_pooled_rerank_topk(
                emb, qd, k, pool=pool, mask=row_mask(valid),
                row_mult=rmult)
        else:
            emb, valid = corpus.slab.device_view()
            scores, idx = topk_scan(emb, qd, k, metric, row_mask(valid))
        scores, idx = host_pull(scores, idx)

        def report(s):
            if quantization == "binary":
                return s                 # -hamming distance, any metric
            if metric == "euclidean":
                return _euclid_report(s)
            if angular:
                # quantized cosine may slightly exceed [-1, 1]
                return float(-np.arccos(np.clip(s, -1.0, 1.0)))
            return s

        return self._results(corpus, scores, idx, k, report)

    def _live_rows(self, corpus: _Corpus) -> Tuple[np.ndarray, torch.Tensor]:
        """(rows [n] int64 on the host, their embeddings [n, dim_pad] on
        the device) of the corpus's live keys, in the index's key order
        (the JAX engine's code order, so ties break as there)."""
        valid = corpus.slab.valid_mask_host()
        rows = np.fromiter((row for _, row in corpus.index.items()),
                           np.int64)
        rows = rows[rows < len(valid)]
        rows = rows[valid[rows]]
        emb, _ = corpus.slab.device_view()
        return rows, emb[torch.from_numpy(rows).to(self.device)]

    def _code_mask(self, corpus: _Corpus, rows: np.ndarray,
                   extra_mask: Optional[np.ndarray]) -> torch.Tensor:
        """The live mask of ``rows`` (the code order of a pq / tt state),
        AND the filter where one is given: a row deleted after the state
        was checked is masked, so the search still fills k."""
        mask = corpus.slab.valid_mask_host()[rows]
        if extra_mask is not None:
            mask = mask & np.asarray(extra_mask, bool)[rows]
        return torch.from_numpy(np.ascontiguousarray(mask)).to(self.device)

    def _pq_search(self, corpus: _Corpus, qd: torch.Tensor, top_k: int,
                   extra_mask: Optional[np.ndarray]
                   ) -> List[List[SearchResult]]:
        """QUANTIZATION pq: an ADC scan (``ops/pq.pq_topk``, the ADC
        kernel) over a codebook of ``max(8, dim_pad // 8)`` subspaces
        trained on every live row. The codebook and codes are cached on
        the corpus under the slab's version, so any write retrains before
        the next search. Scores are 1 / (1 + distance)."""
        from neumann_tpu_torch.ops.pq import PQCodebook, PQConfig, pq_topk

        with corpus.lock:
            state = corpus._pq
            version = corpus.slab.version
        if state is None or state[0] != version:
            rows, mat = self._live_rows(corpus)
            dim_pad = corpus.slab.dim_pad
            book = PQCodebook(dim_pad, PQConfig(
                n_subspaces=max(8, dim_pad // 8)), device=self.device)
            codes = None
            if len(rows):
                book.train(mat)
                codes = book.encode(mat)
            del mat
            state = (version, book, codes, rows)
            with corpus.lock:
                corpus._pq = state
        _, book, codes, rows = state
        if not len(rows):
            return [[] for _ in range(qd.shape[0])]
        scores, idx = host_pull(*pq_topk(
            book, codes, qd, min(top_k, len(rows)),
            self._code_mask(corpus, rows, extra_mask)))
        idx = np.where(idx >= 0, rows[np.maximum(idx, 0)], -1)
        # ADC gives squared distance; report 1/(1+d), d in f32 as the
        # JAX engine takes it
        return self._results(
            corpus, scores, idx, top_k,
            lambda s: 1.0 / (1.0 + float(np.sqrt(np.float32(max(-s, 0.0))))))

    def _tt_scan(self, corpus: _Corpus, qd: torch.Tensor, k: int,
                 metric: str, extra_mask: Optional[np.ndarray]):
        """QUANTIZATION tt: rows live as tensor-train cores (decomposed
        on the device by ``compress/tt_batch``, cached on the corpus
        under the slab's version); each search reconstructs them and runs
        the exact scan. Returns (scores, slab row ids) on the device."""
        from neumann_tpu_torch.compress.tensor_train import TTConfig
        from neumann_tpu_torch.compress.tt_batch import tt_decompose_batch

        with corpus.lock:
            state = corpus._tt
            version = corpus.slab.version
        if state is None or state[0] != version:
            rows, mat = self._live_rows(corpus)
            tts = tt_decompose_batch(mat, TTConfig.for_dim(
                corpus.slab.dim_pad))
            del mat
            state = (version, tts, rows)
            with corpus.lock:
                corpus._tt = state
        _, tts, rows = state
        kk = min(k, len(rows))
        if kk == 0:
            q = qd.shape[0]
            return (torch.empty((q, 0), device=self.device),
                    torch.empty((q, 0), dtype=torch.int32,
                                device=self.device))
        scores, idx = topk_scan(tts.reconstruct(), qd, kk, metric,
                                self._code_mask(corpus, rows, extra_mask))
        row_map = torch.from_numpy(rows).to(self.device)
        idx = torch.where(idx >= 0, row_map[idx.clamp_min(0).long()],
                          -1).int()
        return scores, idx

    def _search_ns(self, ns: str, query, top_k: int, metric: Optional[str],
                   filter_cond: Optional[FilterCondition] = None,
                   quantization: str = "none",
                   dim_hint: Optional[int] = None) -> List[SearchResult]:
        self._flush_bulk_if_pending()
        if top_k <= 0:
            raise VectorError("top_k must be positive")
        q = self._validate_vec(query, dim_hint)
        metric = metric or self.config.default_metric
        if metric not in METRICS:
            raise VectorError(f"unknown metric {metric}")
        if metric in ("cosine", "dot", "angular", "geodesic") and \
                float(np.linalg.norm(q)) == 0.0:
            return []
        with self._lock:
            corpus = self._corpora.get(ns, {}).get(q.size)
        if corpus is None or corpus.count() == 0:
            return []
        if filter_cond is None:
            auto = self._auto_ivf_search(corpus, q[None, :], top_k, metric,
                                         quantization)
            if auto is not None:
                return auto[0]
        extra = corpus.filter_mask(filter_cond) if filter_cond else None
        return self._device_search(corpus, q, top_k, metric, extra,
                                   quantization)[0]

    # ------------------------------------------------------------------
    # auto IVF routing (sub-linear path at large N)
    # ------------------------------------------------------------------
    def build_auto_ivf(self, ns: str = "", dim: Optional[int] = None) -> int:
        """Build (or rebuild) the auto IVF index; servers call this at
        load time so the first query is fast. Returns #rows."""
        self._flush_bulk_if_pending()
        dim = dim or self.config.default_dimension
        if dim is None:
            with self._lock:
                dims = list(self._corpora.get(ns, {}))
            if len(dims) != 1:
                raise VectorError("specify dim (namespace has "
                                  f"{len(dims)} dimensions)")
            dim = dims[0]
        with self._lock:
            corpus = self._corpora.get(ns, {}).get(dim)
        if corpus is None:
            raise VectorError(f"no corpus for dim {dim}")
        return self._build_auto_ivf(corpus)

    def _build_auto_ivf(self, corpus: _Corpus) -> int:
        from neumann_tpu_torch.ops.ivf import DeviceIVFInt8

        cfg = self.config
        slab = corpus.slab
        n = corpus.count()
        # arm the watcher BEFORE reading: rows mutated during the build
        # get the exact-delta treatment
        slab.watch("auto_ivf")
        residual = None
        if cfg.ivf_auto_residual and \
                slab.capacity * slab.dim_pad <= cfg.ivf_auto_residual_max_bytes:
            q8, scale, rq, rscale = slab.host_int8(residual=True)
            residual = (rq, rscale)
        else:
            q8, scale = slab.host_int8()
        clusters = max(4, min(cfg.ivf_auto_clusters, max(1, n // 64)))
        ivf = DeviceIVFInt8(slab.dim_pad, n_clusters=clusters,
                            nprobe=min(cfg.ivf_auto_nprobe, clusters),
                            device=self.device)
        ivf.build(q8, scale, sample_mask=slab.valid_mask_host(),
                  residual=residual)
        with corpus.lock:
            corpus._auto_ivf = ivf
            corpus._auto_ivf_delta = None
        return n

    def _auto_ivf_applies(self, corpus: _Corpus, n_queries: int,
                          metric: str, quantization: str) -> bool:
        """The auto-IVF gate: cosine (or angular) over a float or int8
        corpus of at least ``ivf_auto_threshold`` rows, and batches only
        where ``ivf_auto_batched`` allows them."""
        cfg = self.config
        if metric in ("angular", "geodesic"):
            metric = "cosine"
        if not cfg.ivf_auto or metric != "cosine" or \
                quantization not in ("none", "int8"):
            return False
        if corpus.count() < cfg.ivf_auto_threshold:
            return False
        return n_queries <= cfg.ivf_auto_max_batch or cfg.ivf_auto_batched

    def search_route(self, ns: str, dim: int, top_k: int,
                     metric: Optional[str] = None,
                     filter_cond: Optional[FilterCondition] = None,
                     quantization: str = "none") -> Optional[dict]:
        """The route one query of ``dim`` floats takes over namespace
        ``ns`` (``_search_ns``'s gates, evaluated without searching), or
        None when the namespace holds no such rows: ``route`` ("auto_ivf"
        or a ``_brute_route`` name), ``kernel`` (the ``kernels.LAUNCHES``
        name it launches on the card, None for the torch scans), ``pool``
        and ``rows``."""
        from neumann_tpu_torch.ops.pq import pq_kernel
        from neumann_tpu_torch.ops.quant import hamming_kernel

        self._flush_bulk_if_pending()
        metric = metric or self.config.default_metric
        with self._lock:
            corpus = self._corpora.get(ns, {}).get(dim)
        if corpus is None or corpus.count() == 0:
            return None
        rows = corpus.count()
        if filter_cond is None and self._auto_ivf_applies(
                corpus, 1, metric, quantization):
            return dict(route="auto_ivf", kernel="ivf_probe", pool=None,
                        rows=rows)
        k, metric = _scan_k_metric(corpus, top_k, metric)
        extra = corpus.filter_mask(filter_cond) if filter_cond else None
        route, pool = _brute_route(corpus, k, metric, extra, quantization)
        kernel = {"binary": hamming_kernel(k),
                  "pq": pq_kernel(min(top_k, rows)),
                  "int8_pooled": "int8_pooled_bits",
                  "int8_scan": "int8_dot_scores",
                  "f32_pooled": "f32_pooled_bits"}.get(route)
        return dict(route=route, kernel=kernel, pool=pool, rows=rows)

    def _auto_ivf_search(self, corpus: _Corpus, q: np.ndarray, top_k: int,
                         metric: str, quantization: str
                         ) -> Optional[List[List[SearchResult]]]:
        """Route through the auto IVF index when it applies; None falls
        back to the exact scan."""
        cfg = self.config
        angular = metric in ("angular", "geodesic")
        if not self._auto_ivf_applies(corpus, q.shape[0], metric,
                                      quantization):
            return None
        n = corpus.count()
        throughput_batch = q.shape[0] > cfg.ivf_auto_max_batch
        slab = corpus.slab
        stale_at = max(1024, cfg.ivf_auto_rebuild_frac * n)
        with corpus.lock:
            ivf = corpus._auto_ivf
        if ivf is None or slab.watch_count("auto_ivf") > stale_at:
            with corpus.build_lock:
                # another caller may have just (re)built
                with corpus.lock:
                    ivf = corpus._auto_ivf
                if ivf is None or slab.watch_count("auto_ivf") > stale_at:
                    self._build_auto_ivf(corpus)
                with corpus.lock:
                    ivf = corpus._auto_ivf

        qp = np.zeros((q.shape[0], slab.dim_pad), np.float32)
        qp[:, :corpus.dim] = q
        k_ivf = min(2 * top_k + 16, n)
        if throughput_batch:
            scores, ids = ivf.search_batched(qp, k_ivf)
        else:
            scores, ids = ivf.search(qp, k_ivf)

        dirty = slab.watched("auto_ivf")
        if dirty.size:
            # index hits on rows mutated after the build are stale: drop
            # them, rescan those rows exactly at their current values
            scores = np.where(np.isin(ids, dirty), -np.inf, scores)
            with corpus.lock:
                delta = corpus._auto_ivf_delta
                version = slab.version
            if delta is None or delta[0] != version:
                mat, valid = slab.rows_matrix(dirty)
                rows = dirty[valid]
                dmat = (torch.from_numpy(np.ascontiguousarray(mat[valid]))
                        .to(self.device) if rows.size else None)
                delta = (version, rows, dmat)
                with corpus.lock:
                    corpus._auto_ivf_delta = delta
            _, rows, dmat = delta
            if rows.size:
                ds, di = host_pull(*topk_scan(
                    dmat, torch.from_numpy(qp).to(self.device),
                    min(top_k, rows.size), "cosine"))
                dids = np.where(di >= 0, rows[np.maximum(di, 0)], -1)
                scores = np.concatenate([scores, ds], axis=1)
                ids = np.concatenate([ids, dids], axis=1)

        order = np.argsort(-scores, axis=1, kind="stable")[:, :top_k + 8]
        return self._results(
            corpus, np.take_along_axis(scores, order, axis=1),
            np.take_along_axis(ids, order, axis=1), top_k,
            (lambda s: float(-np.arccos(np.clip(s, -1.0, 1.0))))
            if angular else (lambda s: s))

    def search_similar(self, query, top_k: int) -> List[SearchResult]:
        return self._search_ns("", query, top_k, None)

    def search_similar_with_metric(self, query, top_k: int, metric: str
                                   ) -> List[SearchResult]:
        return self._search_ns("", query, top_k, metric)

    def search_similar_filtered(self, query, top_k: int,
                                filter_cond: FilterCondition,
                                metric: Optional[str] = None
                                ) -> List[SearchResult]:
        return self._search_ns("", query, top_k, metric, filter_cond)

    def search_similar_paginated(self, query, top_k: int, offset: int,
                                 metric: Optional[str] = None
                                 ) -> List[SearchResult]:
        return self._search_ns("", query, top_k + offset, metric)[offset:]

    def search_by_key(self, key: str, top_k: int,
                      metric: Optional[str] = None) -> List[SearchResult]:
        """SIMILAR 'key' TOP k — query by an already-stored embedding."""
        vec = self.get_embedding(key)
        if vec is None:
            raise VectorError(f"no embedding for key '{key}'")
        return self._search_ns("", vec, top_k, metric)

    def batch_search(self, queries, top_k: int, metric: Optional[str] = None
                     ) -> List[List[SearchResult]]:
        """Batched multi-query search: one device pass for Q queries."""
        return self.batch_search_ns(queries, top_k, metric)

    def batch_search_ns(self, queries, top_k: int,
                        metric: Optional[str] = None, ns: str = "",
                        filter_cond: Optional[FilterCondition] = None,
                        quantization: Optional[str] = None
                        ) -> List[List[SearchResult]]:
        """Batched search against any namespace ("" | "entity" |
        "col/{name}") with an optional shared metadata filter.
        Collections resolve their configured metric and quantization
        when not overridden."""
        self._flush_bulk_if_pending()
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim != 2:
            raise VectorError("batch_search expects [Q, d]")
        if top_k <= 0:
            raise VectorError("top_k must be positive")
        if ns.startswith("col/"):
            cfg = self.collection_config(ns[4:])
            metric = metric or cfg.metric
            if quantization is None:
                quantization = cfg.quantization
            if cfg.dimension and q.shape[1] != cfg.dimension:
                raise VectorError(f"dimension mismatch: expected "
                                  f"{cfg.dimension}, got {q.shape[1]}")
        metric = metric or self.config.default_metric
        if metric not in METRICS:
            raise VectorError(f"unknown metric {metric}")
        quantization = quantization or "none"
        with self._lock:
            corpus = self._corpora.get(ns, {}).get(q.shape[1])
        if corpus is None or corpus.count() == 0:
            return [[] for _ in range(q.shape[0])]
        if filter_cond is None:
            auto = self._auto_ivf_search(corpus, q, top_k, metric,
                                         quantization)
            if auto is not None:
                return auto
        extra = corpus.filter_mask(filter_cond) if filter_cond else None
        return self._device_search(corpus, q, top_k, metric, extra,
                                   quantization)

    def warmup(self, buckets: Sequence[int] = (1, 4, 16, 64, 256),
               top_ks: Sequence[int] = (10,)) -> int:
        """The JAX engine's warm-up, call for call: one synthetic
        search per (default-namespace dim, bucket, k) through
        batch_search, then each collection once per k through its
        configured metric and quantization. Returns the number of warm
        calls. On the card there is no executable to compile, but the
        first call builds the CUDA kernels, and every corpus its device
        view (and, past the threshold, its auto-IVF index), so the
        first served query pays for none of these."""
        rng = np.random.default_rng(0)
        warmed = 0
        with self._lock:
            dims = list(self._corpora.get("", {}))
            cols = list(self._collections)
        for dim in dims:
            for b in buckets:
                q = rng.standard_normal((b, dim)).astype(np.float32)
                for k in top_ks:
                    self.batch_search(q, k)
                    warmed += 1
        for name in cols:
            cfg = self.collection_config(name)
            dim = cfg.dimension
            if dim is None:
                continue
            q1 = rng.standard_normal(dim).astype(np.float32)
            for k in top_ks:
                self.search_in_collection(name, q1, k)
                warmed += 1
        return warmed

    # ------------------------------------------------------------------
    # entity embeddings
    # ------------------------------------------------------------------
    def store_entity_embedding(self, key: str, embedding) -> None:
        vec = self._validate_vec(embedding)
        data = self.store.get(ENTITY_PREFIX + key) or TensorData()
        data.set(_EMBEDDING_FIELD, TensorValue.vector(vec))
        self.store.put(ENTITY_PREFIX + key, data)

    def get_entity_embedding(self, key: str) -> Optional[np.ndarray]:
        data = self.store.get(ENTITY_PREFIX + key)
        if data is None:
            return None
        emb = data.get(_EMBEDDING_FIELD)
        return None if emb is None else emb.to_dense()

    def search_entities(self, query, top_k: int,
                        metric: Optional[str] = None,
                        mask_rows: Optional[np.ndarray] = None
                        ) -> List[SearchResult]:
        self._flush_bulk_if_pending()
        q = self._validate_vec(query)
        metric = metric or self.config.default_metric
        with self._lock:
            corpus = self._corpora.get("entity", {}).get(q.size)
        if corpus is None or corpus.count() == 0:
            return []
        return self._device_search(corpus, q, top_k, metric, mask_rows)[0]

    def entity_corpus(self, dim: int) -> Optional[_Corpus]:
        """The entity corpus of one dimension (for fused hybrid
        queries)."""
        self._flush_bulk_if_pending()
        with self._lock:
            return self._corpora.get("entity", {}).get(dim)

    # ------------------------------------------------------------------
    # collections (keys col:{name}:{key}, namespace col/{name})
    # ------------------------------------------------------------------
    def create_collection(self, name: str,
                          config: Optional[VectorCollectionConfig] = None
                          ) -> None:
        config = config or VectorCollectionConfig()
        config.validate()
        with self._lock:
            if name in self._collections:
                raise VectorError(f"collection '{name}' already exists")
            self._collections[name] = config

    def drop_collection(self, name: str) -> bool:
        with self._lock:
            if name not in self._collections:
                return False
            del self._collections[name]
            self._corpora.pop(f"col/{name}", None)
        for key in self.store.scan(f"{COLLECTION_PREFIX}{name}:"):
            self.store.delete(key)
        return True

    def list_collections(self) -> List[str]:
        with self._lock:
            return sorted(self._collections)

    def collection_config(self, name: str) -> VectorCollectionConfig:
        with self._lock:
            cfg = self._collections.get(name)
        if cfg is None:
            raise VectorError(f"unknown collection '{name}'")
        return cfg

    def collection_stats(self, name: str) -> Dict[str, object]:
        self._flush_bulk_if_pending()
        cfg = self.collection_config(name)
        with self._lock:
            corpora = list(self._corpora.get(f"col/{name}", {}).values())
        return {"name": name, "count": sum(c.count() for c in corpora),
                "dimension": cfg.dimension, "metric": cfg.metric,
                "quantization": cfg.quantization}

    def store_in_collection(self, name: str, key: str, embedding,
                            metadata: Optional[Dict[str, object]] = None
                            ) -> None:
        cfg = self.collection_config(name)
        vec = self._validate_vec(embedding, cfg.dimension)
        if cfg.dimension is None:
            with self._lock:
                self._collections[name] = replace(cfg, dimension=vec.size)
        data = TensorData()
        data.set(_EMBEDDING_FIELD, TensorValue.vector(vec))
        for n, v in (metadata or {}).items():
            data.set(n, TensorValue.scalar(v))
        self.store.put(f"{COLLECTION_PREFIX}{name}:{key}", data)

    def delete_from_collection(self, name: str, key: str) -> bool:
        self.collection_config(name)
        return self.store.delete(f"{COLLECTION_PREFIX}{name}:{key}")

    def search_in_collection(self, name: str, query, top_k: int,
                             metric: Optional[str] = None
                             ) -> List[SearchResult]:
        cfg = self.collection_config(name)
        return self._search_ns(
            f"col/{name}", query, top_k, metric or cfg.metric,
            quantization=cfg.quantization, dim_hint=cfg.dimension)

    def search_filtered_in_collection(self, name: str, query, top_k: int,
                                      filter_cond: FilterCondition,
                                      metric: Optional[str] = None
                                      ) -> List[SearchResult]:
        cfg = self.collection_config(name)
        return self._search_ns(
            f"col/{name}", query, top_k, metric or cfg.metric, filter_cond,
            quantization=cfg.quantization, dim_hint=cfg.dimension)

    def snapshot_collection(self, name: str, path) -> int:
        """Persist a collection's vectors + metadata to an .npz file, in
        the JAX package's format (either package loads the other's)."""
        self._flush_bulk_if_pending()
        self.collection_config(name)
        prefix = f"{COLLECTION_PREFIX}{name}:"
        keys, vecs, metas = [], [], []
        for full in self.store.scan(prefix):
            data = self.store.get(full)
            emb = data.get(_EMBEDDING_FIELD)
            if emb is None:
                continue
            keys.append(full[len(prefix):])
            vecs.append(emb.to_dense())
            metas.append({n: v.value for n, v in data.fields.items()
                          if n != _EMBEDDING_FIELD and v.kind == "scalar"})
        np.savez_compressed(
            path, keys=np.array(keys, dtype=object),
            vectors=np.array(vecs, dtype=np.float32) if vecs else
            np.zeros((0, 0), np.float32),
            metadata=json.dumps(metas))
        return len(keys)

    def load_collection_snapshot(self, name: str, path) -> int:
        if name not in self._collections:
            self.create_collection(name)
        blob = np.load(path, allow_pickle=True)
        keys = blob["keys"]
        metas = json.loads(str(blob["metadata"]))
        for key, vec, meta in zip(keys, blob["vectors"], metas):
            self.store_in_collection(name, str(key), vec, meta or None)
        return len(keys)

    # ------------------------------------------------------------------
    # ANN indexes (API parity with build_hnsw_index / build_ivf_index /
    # search_with_hnsw / search_with_ivf_nprobe / save_index / load_index,
    # vector_engine/src/lib.rs): the legacy IVF index on the device, the
    # HNSW graph on the host
    # ------------------------------------------------------------------
    def build_ivf_index(self, n_clusters: int = 64, nprobe: int = 8
                        ) -> int:
        """Build an IVF index over the default namespace. Returns #rows."""
        from neumann_tpu_torch.ops.ivf import IVFConfig, IVFIndex

        dim, corpus, row_map, mat = self._gather_rows()
        idx = IVFIndex(dim, IVFConfig(
            n_clusters=min(n_clusters, len(mat)), nprobe=nprobe),
            device=self.device)
        idx.train(mat[: min(len(mat), 100_000)])
        idx.add(mat)
        with self._lock:
            self._ivf = (idx, corpus, row_map)
        return len(mat)

    def _gather_rows(self):
        """(dim, corpus, row ids [n] host, matrix [n, dim] on the device)
        over the default namespace's largest corpus, in key order."""
        with self._lock:
            corpora = self._corpora.get("", {})
            if not corpora:
                raise VectorError("no embeddings to index")
            dim, corpus = max(corpora.items(),
                              key=lambda kv: kv[1].count())
        rows, mat = self._live_rows(corpus)
        if not len(rows):
            raise VectorError("no embeddings to index")
        return dim, corpus, rows, mat[:, :dim]

    def build_hnsw_index(self, m: int = 16, ef_construction: int = 200,
                         ef_search: int = 50,
                         metric: Optional[str] = None,
                         storage: str = "dense", **kw) -> int:
        """Build a genuine HNSW graph index over the default namespace.

        Parity with vector_engine/src/lib.rs build_hnsw_index /
        tensor_store/src/hnsw.rs. `storage` selects the per-node
        embedding mode: dense | quantized | binary | auto
        (EmbeddingStorage parity). The graph lives on the host (the
        native C++ core); the bulk device scan remains the default
        SIMILAR path. Extra kwargs accepted for IVF-call compatibility
        (n_clusters/nprobe are ignored).
        """
        from neumann_tpu_torch.ops.hnsw import HNSWConfig, HNSWIndex

        dim, corpus, row_map, mat = self._gather_rows()
        hnsw_metric = metric or self.config.default_metric
        # validate BEFORE HNSWConfig so engine callers get a
        # VectorError, not the kernel layer's ValueError
        if hnsw_metric not in ("cosine", "euclidean", "dot"):
            raise VectorError(
                f"HNSW supports cosine/euclidean/dot, not {hnsw_metric}")
        cfg = HNSWConfig(m=m, ef_construction=ef_construction,
                         ef_search=ef_search, metric=hnsw_metric)
        idx = HNSWIndex(dim, cfg)
        ins = {"dense": idx.insert, "quantized": idx.insert_quantized,
               "binary": idx.insert_binary,
               "auto": idx.insert_auto}.get(storage)
        if ins is None:
            raise VectorError(f"unknown HNSW storage '{storage}'")
        for v in mat.cpu().numpy():
            ins(v)
        with self._lock:
            self._hnsw = (idx, corpus, row_map)
        return len(mat)

    def _ivf_search(self, query, top_k: int, nprobe: Optional[int]
                    ) -> List[SearchResult]:
        state = self._ivf
        if state is None:
            raise VectorError("no index built (build_ivf_index first)")
        idx, corpus, row_map = state
        q = self._validate_vec(query, idx.dim)
        s, ids = idx.search(q, top_k, nprobe)
        out = []
        for score, i in zip(s[0], ids[0]):
            if i < 0:
                continue
            key = corpus.index.key_of(int(row_map[i]))
            if key is not None:
                out.append(SearchResult(key, float(score)))
        return out

    def search_with_ivf_nprobe(self, query, top_k: int, nprobe: int
                               ) -> List[SearchResult]:
        return self._ivf_search(query, top_k, nprobe)

    def search_with_hnsw(self, query, top_k: int,
                         ef: Optional[int] = None) -> List[SearchResult]:
        """Graph-walk ANN search (hnsw.rs search / search_with_ef).

        Uses the HNSW graph if built; otherwise falls through to an
        IVF index built via the compat path."""
        state = self._hnsw
        if state is None:
            return self._ivf_search(query, top_k, None)
        idx, corpus, row_map = state
        q = self._validate_vec(query, idx.dim)
        hits = (idx.search_with_ef(q, top_k, ef) if ef
                else idx.search(q, top_k))
        out = []
        for nid, score in hits:
            key = corpus.index.key_of(int(row_map[nid]))
            if key is not None:
                out.append(SearchResult(key, float(score)))
        return out

    def search_with_hnsw_ef(self, query, top_k: int, ef: int
                            ) -> List[SearchResult]:
        return self.search_with_hnsw(query, top_k, ef=ef)

    def save_index(self, path) -> None:
        """Persist whichever ANN index is built (HNSW preferred), in the
        JAX engine's ``.npz`` format (either package loads the
        other's)."""
        self._flush_bulk_if_pending()
        hnsw = self._hnsw
        if hnsw is not None:
            idx, corpus, row_map = hnsw
            np.savez_compressed(
                path, hnsw_blob=np.frombuffer(idx.to_bytes(), np.uint8),
                row_map=row_map)
            return
        state = self._ivf
        if state is None:
            raise VectorError("no index built")
        idx, corpus, row_map = state
        np.savez_compressed(
            path, centroids=idx.centroids,
            reordered=idx._reordered.cpu().numpy(),
            row_ids=idx._row_ids, stride=idx._stride, n=idx._n,
            dim=idx.dim, nprobe=idx.config.nprobe, row_map=row_map)

    def _load_hnsw_index(self, blob) -> int:
        from neumann_tpu_torch.ops.hnsw import HNSWIndex

        idx = HNSWIndex.from_bytes(blob["hnsw_blob"].tobytes())
        with self._lock:
            corpus = self._corpora.get("", {}).get(idx.dim)
        if corpus is None:
            raise VectorError(
                f"no dimension-{idx.dim} embeddings loaded to map the "
                f"index onto")
        self._hnsw = (idx, corpus, blob["row_map"])
        return len(idx)

    def load_index(self, path) -> int:
        """Load an index written by ``save_index`` (of either package);
        a corrupt or mangled file raises VectorError."""
        from neumann_tpu_torch.ops.ivf import IVFConfig, IVFIndex

        try:
            blob = np.load(path)
            files = blob.files
        except Exception as e:       # zip/crc/pickle-layer corruption
            raise VectorError(f"corrupt index file {path}: {e}") \
                from None
        try:
            if "hnsw_blob" in files:
                return self._load_hnsw_index(blob)
            dim = int(blob["dim"])
            idx = IVFIndex(dim, IVFConfig(
                n_clusters=len(blob["centroids"]),
                nprobe=int(blob["nprobe"])), device=self.device)
            idx.centroids = blob["centroids"]
            idx._reordered = torch.from_numpy(
                np.ascontiguousarray(blob["reordered"], np.float32)).to(
                self.device)
            idx._row_ids = blob["row_ids"]
            idx._stride = int(blob["stride"])
            idx._n = int(blob["n"])
            with self._lock:
                corpus = self._corpora.get("", {}).get(dim)
            if corpus is None:
                raise VectorError(
                    f"no dimension-{dim} embeddings loaded to map the "
                    f"index onto")
            self._ivf = (idx, corpus, blob["row_map"])
            return idx._n
        except VectorError:
            raise
        except Exception as e:       # missing keys / mangled arrays
            raise VectorError(f"corrupt index file {path}: {e}") \
                from None

"""LLM response cache: exact O(1) -> semantic HNSW -> embedding cache.

Capability parity with tensor_cache's three layers
(tensor_cache/src/lib.rs:17,186-226,374-430): layer 1 exact hash
lookup; layer 2 semantic similarity over cached query embeddings via
the host HNSW graph (ops/hnsw.py — same structure the reference walks;
a per-lookup device dispatch would cost more than the whole O(log n)
walk at cache sizes); layer 3 an O(1) EMBEDDING cache keyed by
(source, content) — `get()` never recomputes an embedding it has seen
(the reference's `_embedding`-prefixed keys, lib.rs:92,374-430), and
`put_embedding`/`get_embedding` expose it for external embedders. TTL
expiry via a min-heap; LRU/LFU/cost eviction; token counting and
cost-savings accounting. Deleted/re-put entries tombstone their HNSW
node; the index rebuilds itself when more than half the nodes are dead.

Embeddings come from a pluggable embedder (default: deterministic feature
hashing — the reference similarly ships a tokenizer-based default rather
than calling a model).

The port's copy of ``neumann_tpu/cache/llm_cache.py``:
only its import lines differ.
"""

from __future__ import annotations

import hashlib
import functools
import heapq
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from neumann_tpu_torch.ops.hnsw import HNSWConfig, HNSWIndex


def default_embedder(text: str, dim: int = 256) -> np.ndarray:
    """Deterministic feature-hash embedding of word 3-grams."""
    vec = np.zeros(dim, np.float32)
    words = text.lower().split()
    grams = words + [" ".join(words[i:i + 3])
                     for i in range(max(0, len(words) - 2))]
    for g in grams:
        h = int.from_bytes(hashlib.blake2b(
            g.encode(), digest_size=8).digest(), "little")
        vec[h % dim] += 1.0 if (h >> 63) else -1.0
    n = np.linalg.norm(vec)
    return vec / n if n > 0 else vec


def count_tokens(text: str) -> int:
    """Approximate BPE token count (chars/4, floor at word count)."""
    return max(len(text) // 4, len(text.split()))


@dataclass
class CacheStats:
    exact_hits: int = 0
    semantic_hits: int = 0
    embedding_hits: int = 0     # layer-3: embedder calls avoided
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    expirations: int = 0
    invalidations: int = 0
    tokens_saved: int = 0

    @property
    def hits(self) -> int:
        return self.exact_hits + self.semantic_hits

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def cost_saved_usd(self, usd_per_1k_tokens: float = 0.002) -> float:
        return self.tokens_saved / 1000.0 * usd_per_1k_tokens


@dataclass
class _Entry:
    response: str
    created: float
    expires: Optional[float]
    last_access: float
    access_count: int = 0
    cost: float = 0.0


class LLMCache:
    def __init__(self, capacity: int = 10_000,
                 default_ttl_s: Optional[float] = None,
                 semantic_threshold: float = 0.9,
                 eviction: str = "lru",
                 embedder: Callable[[str], np.ndarray] = default_embedder,
                 metric: str = "cosine",
                 auto_select_metric: bool = False,
                 sparsity_metric_threshold: float = 0.9,
                 embedding_capacity: int = 10_000):
        if eviction not in ("lru", "lfu", "cost", "hybrid"):
            raise ValueError(f"bad eviction strategy {eviction}")
        if metric not in ("cosine", "euclidean", "dot"):
            raise ValueError(f"bad cache metric {metric}")
        self.capacity = capacity
        self.default_ttl_s = default_ttl_s
        self.semantic_threshold = semantic_threshold
        self.eviction = eviction
        self.embedder = embedder
        # geometric config (reference tensor_cache CacheConfig:
        # distance_metric + auto_select_metric + sparsity threshold):
        # sparse queries auto-route to weighted Jaccard, which respects
        # shared-dimension structure that cosine washes out
        self.metric = metric
        self.auto_select_metric = auto_select_metric
        self.sparsity_metric_threshold = sparsity_metric_threshold
        self._embs: Dict[str, np.ndarray] = {}   # for jaccard re-rank
        # layer-3 embedding cache: "{source}:{content}" -> embedding,
        # LRU via dict insertion order (move-to-end on hit)
        self.embedding_capacity = embedding_capacity
        self._emb_cache: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()   # no method re-enters
        self._exact: Dict[str, _Entry] = {}
        self._ttl_heap: List[Tuple[float, str]] = []
        # semantic layer: host HNSW over query embeddings (tombstoned
        # nodes accumulate until a rebuild — see _maybe_rebuild)
        self._hnsw: Optional[HNSWIndex] = None
        self._hnsw_keys: List[str] = []      # node id -> cache key
        self._node_of: Dict[str, int] = {}   # live key -> node id
        self.stats = CacheStats()
        self._bg_stop: Optional[threading.Event] = None
        self._bg_thread: Optional[threading.Thread] = None

    # -- background eviction (reference eviction.rs background task) ----
    def start_background_eviction(self, interval_s: float = 1.0,
                                  low_watermark: float = 0.9) -> None:
        """Expire due TTLs and trim toward ``low_watermark * capacity``
        on a daemon thread, so puts on the hot path never pay a long
        eviction sweep. Idempotent; ``stop_background_eviction`` or
        garbage collection ends it."""
        if self._bg_thread is not None and self._bg_thread.is_alive():
            return
        stop = threading.Event()

        def loop() -> None:
            target = max(1, int(self.capacity * low_watermark))
            while not stop.wait(interval_s):
                with self._lock:
                    self._expire_due()
                    while len(self._exact) > target:
                        self._evict_one()

        t = threading.Thread(target=loop, name="llm-cache-evict",
                             daemon=True)
        self._bg_stop, self._bg_thread = stop, t
        t.start()

    def stop_background_eviction(self) -> None:
        if self._bg_stop is not None:
            self._bg_stop.set()
        if self._bg_thread is not None:
            self._bg_thread.join(timeout=2.0)
        self._bg_stop = self._bg_thread = None

    # -- semantic index management -------------------------------------
    def select_metric(self, emb: np.ndarray) -> str:
        """The metric a lookup with this embedding will use
        (lib.rs select_metric): weighted Jaccard for sparse queries
        when auto-selection is on, else the configured metric."""
        if self.auto_select_metric:
            from neumann_tpu_torch.store.sparse import SparseVector

            sv = SparseVector.from_dense(np.asarray(emb, np.float32))
            if sv.sparsity() >= self.sparsity_metric_threshold:
                return "jaccard"
        return self.metric

    def _index_put(self, key: str, emb: np.ndarray) -> None:
        emb = np.asarray(emb, np.float32).ravel()
        if self._hnsw is None:
            self._hnsw = HNSWIndex(len(emb),
                                   HNSWConfig(metric=self.metric))
        if len(emb) != self._hnsw.dim:
            raise ValueError(
                f"dimension mismatch: expected {self._hnsw.dim}, "
                f"got {len(emb)}")
        if key in self._node_of:             # re-put: old node dies
            del self._node_of[key]
        nid = self._hnsw.insert(emb)
        assert nid == len(self._hnsw_keys)
        self._hnsw_keys.append(key)
        self._node_of[key] = nid
        if self.auto_select_metric:
            self._embs[key] = emb
        self._maybe_rebuild()

    def _index_search(self, emb: np.ndarray, k: int = 4):
        """[(key, score)] over LIVE nodes only, best first."""
        if self._hnsw is None or not self._node_of:
            return []
        emb = np.asarray(emb, np.float32).ravel()
        if len(emb) != self._hnsw.dim:
            raise ValueError(
                f"dimension mismatch: expected {self._hnsw.dim}, "
                f"got {len(emb)}")
        jaccard = self.select_metric(emb) == "jaccard"
        out = []
        # jaccard re-rank draws from a wider HNSW candidate pool: the
        # graph walk orders by the configured metric, which only
        # approximates the sparse-overlap ordering
        for nid, score in self._hnsw.search(emb, 4 * k if jaccard else k):
            key = self._hnsw_keys[nid]
            if self._node_of.get(key) == nid:
                out.append((key, score))
        if jaccard:
            from neumann_tpu_torch.store.sparse import SparseVector

            q = SparseVector.from_dense(emb)
            out = [(key, q.weighted_jaccard(
                        SparseVector.from_dense(self._embs[key])))
                   for key, _ in out if key in self._embs]
            out.sort(key=lambda kv: -kv[1])
            del out[k:]
        return out

    def _maybe_rebuild(self) -> None:
        n = len(self._hnsw_keys)
        dead = n - len(self._node_of)
        if n >= 64 and dead * 2 > n:
            old = self._hnsw
            fresh = HNSWIndex(old.dim, old.config)
            keys = []
            node_of = {}
            for key, nid in self._node_of.items():
                vec = old.get(nid)
                node_of[key] = fresh.insert(vec)
                keys.append(key)
            self._hnsw = fresh
            self._hnsw_keys = keys
            self._node_of = node_of

    # ------------------------------------------------------------------
    @staticmethod
    @functools.lru_cache(maxsize=4096)
    def _norm(query: str) -> str:
        # memoized: cache queries repeat by definition, and the
        # lower/split/join rebuild was half the exact-hit cost
        return " ".join(query.lower().split())

    def _expire_due(self) -> None:
        now = time.time()
        while self._ttl_heap and self._ttl_heap[0][0] <= now:
            _, key = heapq.heappop(self._ttl_heap)
            e = self._exact.get(key)
            if e is not None and e.expires is not None and e.expires <= now:
                self._remove(key)
                self.stats.expirations += 1

    def _remove(self, key: str) -> None:
        self._exact.pop(key, None)
        self._node_of.pop(key, None)    # HNSW node tombstoned
        self._embs.pop(key, None)

    def _evict_one(self) -> None:
        if not self._exact:
            return
        if self.eviction == "lru":
            victim = min(self._exact, key=lambda k:
                         self._exact[k].last_access)
        elif self.eviction == "lfu":
            victim = min(self._exact, key=lambda k:
                         self._exact[k].access_count)
        elif self.eviction == "cost":
            victim = min(self._exact, key=lambda k: self._exact[k].cost)
        else:  # hybrid: recency * frequency * cost
            now = time.time()
            victim = min(self._exact, key=lambda k: (
                (self._exact[k].access_count + 1)
                * self._exact[k].cost
                / (now - self._exact[k].last_access + 1.0)))
        self._remove(victim)
        self.stats.evictions += 1

    # -- layer 3: O(1) embedding cache (lib.rs:92,374-430) --------------
    @staticmethod
    def _emb_key(source: str, content: str) -> str:
        return f"{source}:{content}"

    def _emb_cache_get(self, key: str) -> Optional[np.ndarray]:
        emb = self._emb_cache.pop(key, None)
        if emb is None:
            return None
        self._emb_cache[key] = emb          # move-to-end (LRU)
        self.stats.embedding_hits += 1
        return emb

    def _emb_cache_put(self, key: str, emb: np.ndarray) -> None:
        if self.embedding_capacity <= 0:
            return
        self._emb_cache.pop(key, None)
        while len(self._emb_cache) >= self.embedding_capacity:
            del self._emb_cache[next(iter(self._emb_cache))]
        self._emb_cache[key] = emb

    def put_embedding(self, source: str, content: str,
                      embedding) -> None:
        """Cache a computed embedding under (source, content) — the
        reference's put_embedding (tensor_cache/src/lib.rs:390)."""
        with self._lock:
            self._emb_cache_put(
                self._emb_key(source, content),
                np.asarray(embedding, np.float32).ravel())

    def get_embedding(self, source: str,
                      content: str) -> Optional[np.ndarray]:
        """O(1) cached embedding lookup (lib.rs:374); None on miss."""
        with self._lock:
            emb = self._emb_cache_get(self._emb_key(source, content))
            return None if emb is None else emb.copy()

    def _embed(self, key: str) -> np.ndarray:
        """Layer-3-cached embedder call: an embedding this cache has
        already computed (or been handed) is never recomputed."""
        ck = self._emb_key("query", key)
        emb = self._emb_cache_get(ck)
        if emb is None:
            emb = np.asarray(self.embedder(key), np.float32).ravel()
            self._emb_cache_put(ck, emb)
        return emb

    # ------------------------------------------------------------------
    def put(self, query: str, response: str,
            ttl_s: Optional[float] = None,
            embedding: Optional[np.ndarray] = None) -> None:
        key = self._norm(query)
        now = time.time()
        ttl = ttl_s if ttl_s is not None else self.default_ttl_s
        expires = now + ttl if ttl else None
        with self._lock:
            self._expire_due()
            while len(self._exact) >= self.capacity:
                self._evict_one()
            self._exact[key] = _Entry(
                response=response, created=now, expires=expires,
                last_access=now,
                cost=float(count_tokens(response)))
            if expires is not None:
                heapq.heappush(self._ttl_heap, (expires, key))
            if embedding is not None:
                emb = np.asarray(embedding, np.float32).ravel()
                # caller-computed embeddings seed layer 3 so a later
                # get() for this query skips the embedder entirely
                self._emb_cache_put(self._emb_key("query", key), emb)
            else:
                emb = self._embed(key)
            self._index_put(key, emb)
            self.stats.insertions += 1

    def get(self, query: str,
            threshold: Optional[float] = None) -> Optional[str]:
        """Exact layer first, then semantic similarity layer."""
        key = self._norm(query)
        with self._lock:
            heap = self._ttl_heap
            if heap and heap[0][0] <= time.time():
                self._expire_due()
            e = self._exact.get(key)
            if e is not None:
                e.last_access = time.time()
                e.access_count += 1
                self.stats.exact_hits += 1
                self.stats.tokens_saved += e.cost   # counted at put
                return e.response
            # semantic layer: HNSW walk over live query embeddings;
            # the embedding itself comes through layer 3 (O(1) reuse)
            emb = self._embed(key)
            results = self._index_search(emb)
            thr = threshold if threshold is not None \
                else self.semantic_threshold
            for rkey, score in results:
                if score < thr:
                    break
                hit = self._exact.get(rkey)
                if hit is not None:
                    hit.last_access = time.time()
                    hit.access_count += 1
                    self.stats.semantic_hits += 1
                    self.stats.tokens_saved += hit.cost
                    return hit.response
            self.stats.misses += 1
            return None

    def get_exact(self, query: str) -> Optional[str]:
        key = self._norm(query)
        with self._lock:
            self._expire_due()
            e = self._exact.get(key)
            if e is None:
                self.stats.misses += 1
                return None
            e.last_access = time.time()
            e.access_count += 1
            self.stats.exact_hits += 1
            self.stats.tokens_saved += e.cost       # counted at put
            return e.response

    def invalidate(self, query: str) -> bool:
        """Drop a cached entry (reference cache_invalidation path:
        callers invalidate when the underlying data a response was
        derived from changes). Semantic lookups stop returning it
        immediately — the HNSW node is tombstoned with the entry."""
        key = self._norm(query)
        with self._lock:
            if key not in self._exact:
                return False
            self._remove(key)
            self.stats.invalidations += 1
            return True

    def invalidate_prefix(self, prefix: str) -> int:
        """Invalidate every cached query starting with ``prefix``
        (normalized); returns the count removed."""
        p = self._norm(prefix)
        with self._lock:
            victims = [k for k in self._exact if k.startswith(p)]
            for k in victims:
                self._remove(k)
            self.stats.invalidations += len(victims)
            return len(victims)

    def evict(self, n: int = 1) -> int:
        with self._lock:
            before = len(self._exact)
            for _ in range(min(n, before)):
                self._evict_one()
            return before - len(self._exact)

    def clear(self) -> None:
        with self._lock:
            for key in list(self._exact):
                self._remove(key)
            self._ttl_heap.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._exact)

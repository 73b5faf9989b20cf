"""Unified engine: one entity = relational fields + graph edges + embedding.

Copy of ``neumann_tpu.engines.unified`` with its import lines changed
and the key -> node map's build split out of ``__init__`` into
``rebuild_index``, which the port's ``QueryRouter.recover`` calls after
the store recovers. The row mask goes to the port's
``VectorEngine.search_entities``, which fuses it into whichever scan its
gate picks.

Capability parity with tensor_unified::UnifiedEngine
(tensor_unified/src/lib.rs:399-1481): create_entity, connect_entities,
find_similar_connected, find_neighbors_by_similarity, find, plus entity
CRUD and batch embedding collection.

The reference's hybrid query oversamples 2x top_k candidates from the
vector scan and intersects with the neighbor set on the host afterwards
(tensor_unified/src/lib.rs:884-938). Here the graph constraint becomes a
row bitmask over the entity corpus that is fused INTO the device scan
(-inf outside the neighborhood), so results are exact for any k and the
scan cost is unchanged.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from neumann_tpu_torch.engines.condition import Condition
from neumann_tpu_torch.engines.graph import GraphEngine
from neumann_tpu_torch.engines.relational import RelationalEngine
from neumann_tpu_torch.engines.vector import SearchResult, VectorEngine
from neumann_tpu_torch.store.tensor_store import (
    TensorData,
    TensorStore,
    TensorValue,
)
from neumann_tpu_torch.utils.errors import NeumannError

ENTITY_LABEL = "entity"
_KEY_PROP = "key"


class BatchResult:
    """Per-item outcome of an error-collecting batch op
    (tensor_unified/src/lib.rs BatchResult/BatchItemError): succeeded
    keys in input order plus (index, key, cause) failures."""

    __slots__ = ("succeeded", "failed")

    def __init__(self, succeeded: List[str],
                 failed: List[Tuple[int, Optional[str], str]]):
        self.succeeded = succeeded
        self.failed = failed

    @property
    def all_succeeded(self) -> bool:
        return not self.failed

    def __len__(self) -> int:
        return len(self.succeeded)

    def __repr__(self) -> str:
        return (f"BatchResult(succeeded={len(self.succeeded)}, "
                f"failed={len(self.failed)})")


class UnifiedEngine:
    def __init__(
        self,
        store: Optional[TensorStore] = None,
        relational: Optional[RelationalEngine] = None,
        graph: Optional[GraphEngine] = None,
        vector: Optional[VectorEngine] = None,
    ):
        self.store = store if store is not None else TensorStore()
        self.relational = relational or RelationalEngine(self.store)
        self.graph = graph if graph is not None else GraphEngine(self.store)
        self.vector = vector if vector is not None else VectorEngine(self.store)
        self._lock = threading.RLock()
        self._key_to_node: Dict[str, int] = {}
        self.rebuild_index()

    def rebuild_index(self) -> None:
        """Rebuild the key -> node map from graph state (e.g. after WAL
        replay)."""
        key_to_node = {}
        for node in self.graph.find_nodes(ENTITY_LABEL):
            k = node["properties"].get(_KEY_PROP)
            if k is not None:
                key_to_node[k] = node["id"]
        with self._lock:
            self._key_to_node = key_to_node

    # ------------------------------------------------------------------
    # entity CRUD
    # ------------------------------------------------------------------
    def create_entity(self, key: str, fields: Optional[dict] = None,
                      embedding=None) -> int:
        """Create (or update) an entity; returns its graph node id."""
        fields = dict(fields or {})
        with self._lock:
            node_id = self._key_to_node.get(key)
            if node_id is None:
                node_id = self.graph.create_node(
                    ENTITY_LABEL, {_KEY_PROP: key, **fields})
                self._key_to_node[key] = node_id
            elif fields:
                self.graph.update_node(node_id, fields)
        # fields + embedding live in the entity's tensor
        data = self.store.get(f"entity:{key}") or TensorData()
        for k, v in fields.items():
            data.set(k, TensorValue.scalar(v))
        if embedding is not None:
            data.set("embedding",
                     TensorValue.vector(np.asarray(embedding, np.float32)))
        self.store.put(f"entity:{key}", data)
        return node_id

    def get_entity(self, key: str) -> Optional[dict]:
        data = self.store.get(f"entity:{key}")
        node_id = self._key_to_node.get(key)
        if data is None and node_id is None:
            return None
        fields = {}
        emb = None
        if data is not None:
            for n, v in data.fields.items():
                if n == "embedding":
                    emb = v.to_dense()
                elif v.kind == "scalar":
                    fields[n] = v.value
        return {"key": key, "node_id": node_id, "fields": fields,
                "embedding": emb}

    def update_entity(self, key: str, fields: dict) -> None:
        if key not in self._key_to_node:
            raise NeumannError(f"no entity '{key}'")
        self.create_entity(key, fields)

    def delete_entity(self, key: str) -> bool:
        with self._lock:
            node_id = self._key_to_node.pop(key, None)
        if node_id is not None:
            self.graph.delete_node(node_id)
        return self.store.delete(f"entity:{key}")

    def entity_exists(self, key: str) -> bool:
        return key in self._key_to_node or \
            self.store.exists(f"entity:{key}")

    def list_entities(self) -> List[str]:
        return sorted(self._key_to_node)

    def node_id_of(self, key: str) -> Optional[int]:
        return self._key_to_node.get(key)

    def key_of_node(self, node_id: int) -> Optional[str]:
        node = self.graph.get_node(node_id)
        if node is None or node["label"] != ENTITY_LABEL:
            return None
        return node["properties"].get(_KEY_PROP)

    # ------------------------------------------------------------------
    # relationships
    # ------------------------------------------------------------------
    def connect_entities(self, a: str, b: str, rel_type: str = "related",
                         properties: Optional[dict] = None,
                         directed: bool = True) -> int:
        na, nb = self._key_to_node.get(a), self._key_to_node.get(b)
        if na is None:
            raise NeumannError(f"no entity '{a}'")
        if nb is None:
            raise NeumannError(f"no entity '{b}'")
        return self.graph.create_edge(na, nb, rel_type, properties,
                                      directed)

    def entity_neighbors(self, key: str) -> List[str]:
        nid = self._key_to_node.get(key)
        if nid is None:
            return []
        out = []
        for nb in self.graph.get_entity_neighbors(nid):
            k = self.key_of_node(nb)
            if k is not None:
                out.append(k)
        return sorted(out)

    # ------------------------------------------------------------------
    # hybrid queries (the fused-bitmask path)
    # ------------------------------------------------------------------
    def _neighbor_key_set(self, key: str) -> Set[str]:
        nid = self._key_to_node.get(key)
        if nid is None:
            raise NeumannError(f"no entity '{key}'")
        keys = set()
        for nb in self.graph.get_entity_neighbors(nid):
            k = self.key_of_node(nb)
            if k is not None:
                keys.add(k)
        return keys

    def _keys_to_row_mask(self, keys: Set[str], dim: int
                          ) -> Optional[np.ndarray]:
        corpus = self.vector.entity_corpus(dim)
        if corpus is None:
            return None
        mask = np.zeros(corpus.slab.capacity, bool)
        for k in keys:
            row = corpus.index.lookup(k)
            if row is not None:
                mask[row] = True
        return mask

    def _resolve_query_vec(self, query) -> np.ndarray:
        if isinstance(query, str):
            vec = self.vector.get_entity_embedding(query)
            if vec is None:
                raise NeumannError(f"entity '{query}' has no embedding")
            return vec
        return np.asarray(query, np.float32)

    def find_similar_connected(self, query, top_k: int, connected_to: str,
                               metric: Optional[str] = None
                               ) -> List[SearchResult]:
        """SIMILAR ... TOP k CONNECTED TO 'key' — graph constraint fused
        into the scan as a bitmask (exact, no oversampling)."""
        vec = self._resolve_query_vec(query)
        neighbor_keys = self._neighbor_key_set(connected_to)
        if isinstance(query, str):
            neighbor_keys.discard(query)
        if not neighbor_keys:
            return []
        mask = self._keys_to_row_mask(neighbor_keys, vec.size)
        if mask is None or not mask.any():
            return []
        return self.vector.search_entities(vec, top_k, metric, mask)

    def find_neighbors_by_similarity(self, key: str, top_k: int,
                                     metric: Optional[str] = None
                                     ) -> List[SearchResult]:
        """Rank the graph neighbors of `key` by embedding similarity."""
        vec = self._resolve_query_vec(key)
        neighbor_keys = self._neighbor_key_set(key)
        neighbor_keys.discard(key)
        if not neighbor_keys:
            return []
        mask = self._keys_to_row_mask(neighbor_keys, vec.size)
        if mask is None or not mask.any():
            return []
        return self.vector.search_entities(vec, top_k, metric, mask)

    def find_similar_entities(self, query, top_k: int,
                              metric: Optional[str] = None
                              ) -> List[SearchResult]:
        vec = self._resolve_query_vec(query)
        return self.vector.search_entities(vec, top_k, metric)

    # ------------------------------------------------------------------
    # FIND: field predicates [+ similarity] [+ connectivity]
    # ------------------------------------------------------------------
    def find(self, condition: Optional[Condition] = None,
             similar_to=None, top_k: int = 10,
             connected_to: Optional[str] = None,
             metric: Optional[str] = None) -> List[dict]:
        """Unified FIND: WHERE on fields, optional SIMILAR TO ordering,
        optional CONNECTED TO constraint — all fused into one scan when a
        similarity query is present."""
        allowed: Optional[Set[str]] = None
        if condition is not None:
            allowed = set()
            for key in self.list_entities():
                ent = self.get_entity(key)
                if ent and condition.evaluate_row(ent["fields"]):
                    allowed.add(key)
        if connected_to is not None:
            nbrs = self._neighbor_key_set(connected_to)
            allowed = nbrs if allowed is None else (allowed & nbrs)

        if similar_to is not None:
            vec = self._resolve_query_vec(similar_to)
            if allowed is not None:
                if not allowed:
                    return []
                mask = self._keys_to_row_mask(allowed, vec.size)
                if mask is None or not mask.any():
                    return []
            else:
                mask = None
            results = self.vector.search_entities(vec, top_k, metric, mask)
            out = []
            for r in results:
                ent = self.get_entity(r.key)
                if ent is not None:
                    ent["score"] = r.score
                    out.append(ent)
            return out

        keys = sorted(allowed) if allowed is not None else \
            self.list_entities()
        out = []
        for key in keys[:top_k] if top_k else keys:
            ent = self.get_entity(key)
            if ent is not None:
                out.append(ent)
        return out

    # ------------------------------------------------------------------
    # batch embedding collection (embed_batch_collect parity)
    # ------------------------------------------------------------------
    def embed_batch(self, items: Sequence[Tuple[str, object]]) -> int:
        """Store embeddings for many entities in one slab flush."""
        for key, emb in items:
            if key not in self._key_to_node:
                self.create_entity(key)
            self.vector.store_entity_embedding(key, emb)
        return len(items)

    def embed_batch_collect(self, items: Sequence[Tuple[str, object]]
                            ) -> BatchResult:
        """Error-collecting variant (tensor_unified/src/lib.rs:1481):
        keeps processing after per-item failures instead of failing
        fast, returning successes and (index, key, cause) failures."""
        succeeded: List[str] = []
        failed: List[Tuple[int, Optional[str], str]] = []
        for idx, (key, emb) in enumerate(items):
            if not key:
                failed.append((idx, key, "empty key"))
                continue
            arr = np.asarray(emb, dtype=np.float32)
            if arr.ndim != 1 or arr.size == 0:
                failed.append((idx, key, "empty vector"))
                continue
            try:
                if key not in self._key_to_node:
                    self.create_entity(key)
                self.vector.store_entity_embedding(key, arr)
            except Exception as e:  # noqa: BLE001 — collect, don't abort
                failed.append((idx, key, str(e)))
                continue
            succeeded.append(key)
        return BatchResult(succeeded, failed)

    def collect_embeddings(self, keys: Sequence[str]
                           ) -> List[Optional[np.ndarray]]:
        return [self.vector.get_entity_embedding(k) for k in keys]

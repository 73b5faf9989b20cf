"""QueryRouter: parse + dispatch for the vector statements (the slice of
``neumann_tpu/router/router.py``).

Executes EMBED STORE / GET / DELETE / BATCH (default namespace or IN a
collection), SIMILAR (vector or key, TOP, METRIC, WHERE, IN a
collection), CREATE / DROP / SHOW COLLECTIONS, COUNT EMBEDDINGS and SHOW
EMBEDDINGS against the port's vector engine, on the router's ``device``
(default "cuda"). Any other statement parses but raises
``NeumannError`` naming its ROADMAP item.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

from neumann_tpu_torch.engines.condition import Condition
from neumann_tpu_torch.engines.vector import (
    FilterCondition,
    VectorCollectionConfig,
    VectorEngine,
)
from neumann_tpu_torch.lang import ast
from neumann_tpu_torch.lang.parser import parse_cached
from neumann_tpu_torch.store.tensor_store import TensorStore
from neumann_tpu_torch.utils.errors import NeumannError, VectorError
from neumann_tpu_torch.utils.observability import QueryMetrics


@dataclass
class QueryResult:
    """Tagged result, like the JAX package's QueryResult."""

    kind: str                      # rows/count/message/similar/value
    message: str = ""
    rows: List[dict] = field(default_factory=list)
    count: Optional[int] = None
    results: List[dict] = field(default_factory=list)   # similar hits
    value: object = None

    @staticmethod
    def msg(text: str) -> "QueryResult":
        return QueryResult("message", message=text)

    @staticmethod
    def of_rows(rows: List[dict]) -> "QueryResult":
        return QueryResult("rows", rows=rows, count=len(rows))

    @staticmethod
    def of_count(n: int) -> "QueryResult":
        return QueryResult("count", count=n)

    @staticmethod
    def of_value(v) -> "QueryResult":
        return QueryResult("value", value=v)


def _filter_from_condition(cond: Condition) -> FilterCondition:
    """Condition tree -> vector-engine metadata filter."""
    op = cond.op
    F = FilterCondition
    if op == "true":
        return F.true()
    if op == "and":
        return _filter_from_condition(cond.left).and_(
            _filter_from_condition(cond.right))
    if op == "or":
        return _filter_from_condition(cond.left).or_(
            _filter_from_condition(cond.right))
    if op == "not":
        raise VectorError("NOT is not supported in SIMILAR WHERE filters")
    mapping = {"=": F.eq, "!=": F.ne, "<": F.lt, "<=": F.le,
               ">": F.gt, ">=": F.ge}
    if op in mapping:
        return mapping[op](cond.column, cond.value)
    if op == "in":
        return F.in_(cond.column, cond.value)
    if op == "like":
        pat = cond.value
        if pat.endswith("%") and "%" not in pat[:-1] and "_" not in pat:
            return F.starts_with(cond.column, pat[:-1])
        raise VectorError("only 'prefix%' LIKE is supported in filters")
    if op == "is_not_null":
        return F.exists(cond.column)
    raise VectorError(f"unsupported filter op {op}")


class QueryRouter:
    def __init__(self, store: Optional[TensorStore] = None, device="cuda"):
        self.store = store if store is not None else TensorStore()
        self.vector = VectorEngine(self.store, device=device)
        self.metrics = QueryMetrics()

    def execute(self, query: str) -> QueryResult:
        t0 = time.perf_counter()
        kind = "Unparsed"
        try:
            stmt = parse_cached(query)
            kind = type(stmt).__name__
            out = self.execute_statement(stmt)
        except Exception:
            self.metrics.record(kind, (time.perf_counter() - t0) * 1e3,
                                error=True, query=query)
            raise
        self.metrics.record(kind, (time.perf_counter() - t0) * 1e3,
                            query=query)
        return out

    def execute_statement(self, stmt: ast.Statement) -> QueryResult:
        handler = getattr(self, f"_exec_{type(stmt).__name__.lower()}", None)
        if handler is None:
            raise NeumannError(
                f"statement {type(stmt).__name__} is not ported to the "
                f"PyTorch router yet (ROADMAP: router statements beyond "
                f"EMBED/SIMILAR)")
        return handler(stmt)

    # -- vector ---------------------------------------------------------------
    def _exec_embedstore(self, s: ast.EmbedStore) -> QueryResult:
        if s.collection:
            if s.collection not in self.vector.list_collections():
                self.vector.create_collection(s.collection)
            self.vector.store_in_collection(s.collection, s.key, s.vector)
        else:
            self.vector.store_embedding(s.key, s.vector)
        return QueryResult.msg(f"embedding '{s.key}' stored")

    def _exec_embedget(self, s: ast.EmbedGet) -> QueryResult:
        if s.collection:
            vec = self._collection_vector(s.collection, s.key)
        else:
            vec = self.vector.get_embedding(s.key)
        if vec is None:
            return QueryResult.msg(f"no embedding '{s.key}'")
        return QueryResult.of_value(vec.tolist())

    def _exec_embeddelete(self, s: ast.EmbedDelete) -> QueryResult:
        if s.collection:
            ok = self.vector.delete_from_collection(s.collection, s.key)
        else:
            ok = self.vector.delete_embedding(s.key)
        return QueryResult.msg(
            f"embedding '{s.key}' deleted" if ok else
            f"no embedding '{s.key}'")

    def _exec_embedbatch(self, s: ast.EmbedBatch) -> QueryResult:
        if s.collection:
            if s.collection not in self.vector.list_collections():
                self.vector.create_collection(s.collection)
            for key, vec in s.items:
                self.vector.store_in_collection(s.collection, key, vec)
        else:
            self.vector.batch_store_embeddings(s.items)
        return QueryResult.msg(f"stored {len(s.items)} embeddings")

    def _exec_similar(self, s: ast.Similar) -> QueryResult:
        if s.connected_to is not None:
            raise NeumannError("SIMILAR ... CONNECTED TO is not ported to "
                               "the PyTorch router yet (ROADMAP: graph "
                               "ops)")
        q = self._resolve_query(s, s.query_vector if s.query_vector
                                is not None else s.query_key)
        filt = (_filter_from_condition(s.where) if s.where is not None
                else None)
        if s.collection is not None:
            if filt is not None:
                res = self.vector.search_filtered_in_collection(
                    s.collection, q, s.limit, filt, s.metric)
            else:
                res = self.vector.search_in_collection(
                    s.collection, q, s.limit, s.metric)
        elif filt is not None:
            res = self.vector.search_similar_filtered(q, s.limit, filt,
                                                      s.metric)
        else:
            res = self.vector.search_similar_with_metric(
                q, s.limit, s.metric or "cosine")
        return QueryResult("similar", results=[
            {"key": r.key, "score": r.score} for r in res])

    def _collection_vector(self, name: str, key: str):
        data = self.store.get(f"col:{name}:{key}")
        if data is None or data.get("embedding") is None:
            return None
        return data.get("embedding").to_dense()

    def _resolve_query(self, s: ast.Similar, query):
        """A key names a stored embedding: the collection's row first
        (SIMILAR ... IN c), then the default namespace."""
        if isinstance(query, str):
            if s.collection is not None:
                vec = self._collection_vector(s.collection, query)
                if vec is not None:
                    return vec
            vec = self.vector.get_embedding(query)
            if vec is None:
                raise VectorError(f"no embedding for '{query}'")
            return vec
        return query

    def _exec_showembeddings(self, s: ast.ShowEmbeddings) -> QueryResult:
        keys = self.vector.list_embeddings(s.limit)
        return QueryResult.of_rows([{"key": k} for k in keys])

    def _exec_countembeddings(self, s) -> QueryResult:
        return QueryResult.of_count(self.vector.count_embeddings())

    def _exec_showcollections(self, s) -> QueryResult:
        return QueryResult.of_rows([
            self.vector.collection_stats(n)
            for n in self.vector.list_collections()])

    def _exec_createcollection(self, s: ast.CreateCollection) -> QueryResult:
        self.vector.create_collection(s.name, VectorCollectionConfig(
            dimension=s.dimension, metric=s.metric,
            quantization=s.quantization))
        return QueryResult.msg(f"collection '{s.name}' created")

    def _exec_dropcollection(self, s: ast.DropCollection) -> QueryResult:
        ok = self.vector.drop_collection(s.name)
        return QueryResult.msg(
            f"collection '{s.name}' dropped" if ok else
            f"no collection '{s.name}'")

    def _exec_empty(self, s) -> QueryResult:
        return QueryResult.msg("")

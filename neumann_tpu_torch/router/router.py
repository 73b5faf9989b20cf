"""QueryRouter: parse + dispatch (port of
``neumann_tpu/router/router.py``).

Executes, against the port's engines on the router's ``device``
(default "cuda"):

* SQL: CREATE / DROP TABLE and INDEX, INSERT, SELECT (joins, GROUP BY,
  subqueries), UPDATE, DELETE, SHOW TABLES, DESCRIBE;
* graph: NODE / EDGE, NEIGHBORS (``BY SIMILARITY`` too), PATH, PAGERANK,
  GRAPH ALGORITHM / CONSTRAINT / INDEX / PATTERN / BATCH / AGGREGATE, and
  Cypher (MATCH / CREATE / MERGE / DELETE / SET);
* vector: EMBED, SIMILAR (TOP, METRIC, WHERE, IN a collection,
  ``CONNECTED TO``), CREATE / DROP / SHOW COLLECTIONS, COUNT and SHOW
  EMBEDDINGS;
* unified: ENTITY CREATE / GET / DELETE / CONNECT / BATCH CREATE, FIND;
* the extended modules, once attached (``init_vault``, ``init_cache``,
  ``init_blob``, ``init_checkpoints``; each imports its module at the
  call, so the router imports without ``cryptography``): VAULT, CACHE,
  BLOB, BLOBS, CHECKPOINT, CHECKPOINTS and ROLLBACK; with a checkpoint
  manager, destructive statements take an automatic checkpoint first;
* the chain (``init_chain``, or the first BEGIN CHAIN TRANSACTION):
  chain transactions journaled at the store, COMMIT / ROLLBACK CHAIN and
  the chain's views; CLUSTER CONNECT makes the router a gateway to a
  ``chain/node.py`` cluster, CLUSTER STATUS / NODES / LEADER read an
  attached ``cluster``;
* EXPLAIN: the plan of a statement without running it;
* ``execute_many`` and cursor pagination (``execute_paginated``);
* serving: ``warmup`` and, once a caller enables it, batched serving
  (``server/batcher.QueryBatcher`` coalesces concurrent SIMILARs), and
  the query cache (``enable_query_cache``).

The handlers are the JAX router's, with three differences. EXPLAIN
SIMILAR names the route and kernel the port's engine takes for the
statement (``VectorEngine.search_route``), where the JAX text describes
TPU hardware. The query cache is a dict of the router's (statement text
-> result) that answers only the same text and is emptied at the store's
next write, where the JAX cache keeps results in the LLM cache, answers
from its semantic layer and keeps them across writes. ROLLBACK reloads
each corpus from row 0 (``VectorEngine.restoring``) and rebuilds the
unified engine's key -> node map, as ``recover`` does.

``attach_planner`` wires the distributed planner
(``parallel/distributed.py``) into ``execute``, as the JAX router does:
a statement the plan scatters runs on the shards' executors (routers in
the process, or shard servers through ``NeumannClient``) and their
results merge; a statement the plan keeps local runs here.
"""

from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from neumann_tpu_torch.engines.condition import Condition
from neumann_tpu_torch.engines.graph import GraphEngine
from neumann_tpu_torch.engines.relational import (
    Column,
    ForeignKey,
    RelationalEngine,
)
from neumann_tpu_torch.engines.unified import UnifiedEngine
from neumann_tpu_torch.engines.vector import (
    FilterCondition,
    VectorCollectionConfig,
    VectorEngine,
)
from neumann_tpu_torch.lang import ast
from neumann_tpu_torch.lang.cypher import (
    CypherExecutor,
    looks_like_cypher,
    parse_cypher,
)
from neumann_tpu_torch.lang.parser import parse_cached, parse_many
from neumann_tpu_torch.router.cursor_store import CursorError, CursorStore
from neumann_tpu_torch.store.tensor_store import TensorStore
from neumann_tpu_torch.utils.errors import NeumannError, VectorError
from neumann_tpu_torch.utils.observability import QueryMetrics

def _agg_alias(item) -> str:
    """Canonical output column for an un-aliased aggregate item,
    sqlite-style: count(x) / count(DISTINCT x)."""
    inner = f"DISTINCT {item.expr}" if item.distinct else item.expr
    return f"{item.agg}({inner})"

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


def _as_id(value, what: str = "id") -> int:
    """User-supplied node/edge ids must coerce cleanly to ints."""
    try:
        if isinstance(value, bool):
            raise ValueError
        return int(value)
    except (TypeError, ValueError):
        raise NeumannError(f"invalid {what}: {value!r}") from None


class QueryRouter:
    def __init__(self, store: Optional[TensorStore] = None, device="cuda"):
        self.store = store if store is not None else TensorStore()
        self.device = device
        self.relational = RelationalEngine(self.store)
        self.graph = GraphEngine(self.store, device=device)
        self.vector = VectorEngine(self.store, device=device)
        self.unified = UnifiedEngine(self.store, self.relational,
                                     self.graph, self.vector)
        self.vault = None        # attach via init_vault
        self.cache = None        # attach via init_cache
        self.blob = None         # attach via init_blob
        self.checkpoints = None  # attach via init_checkpoints
        self.cursor_store = CursorStore()
        self._lock = threading.RLock()
        self.metrics = QueryMetrics()
        # the query cache (enable_query_cache; None while off): statement
        # text -> result, all computed at ``_cache_writes`` store writes
        # (``VectorEngine.writes``)
        self._query_cache: Optional[dict] = None
        self._cache_writes = 0
        self._cache_lock = threading.Lock()
        # serving-side query coalescing (server/batcher.py): off for
        # embedded use (adds max_wait_ms to single-caller latency),
        # enabled by a server before it takes traffic
        self._batchers = None
        self._batcher_wait_ms = 2.0
        # the chain (init_chain) and its open statement-level transaction
        self.chain = None
        self._chain_tx = None
        self._tx_undo: list = []
        self._tx_ops: list = []
        # CLUSTER CONNECT's client, and a cluster a caller attaches for
        # CLUSTER STATUS / NODES / LEADER
        self.cluster_client = None
        self.cluster = None
        self.cluster_read_mode = "forward"
        # the distributed planner (attach_planner); None while detached
        self._dist = None
        self._dist_nprobe = None

    def recover(self, wal_path, snapshot_path=None) -> int:
        """Recover the store from a snapshot + WAL (``TensorStore.
        recover``; the engines follow through its hooks), then rebuild
        the unified engine's key -> node map from the recovered graph.
        Returns the number of WAL records applied."""
        n = self.store.recover(wal_path, snapshot_path=snapshot_path)
        self.unified.rebuild_index()
        return n

    # -- serving ----------------------------------------------------------------
    def enable_batched_serving(self, max_wait_ms: float = 2.0) -> None:
        """Coalesce concurrent SIMILAR queries into one device call per
        cohort (server/batcher.QueryBatcher). Under concurrent load
        callers share one batch_search instead of one device call each;
        a lone caller pays at most ``max_wait_ms`` extra. Idempotent."""
        with self._lock:
            if self._batchers is None:
                self._batchers = {}
            self._batcher_wait_ms = max_wait_ms

    def disable_batched_serving(self) -> None:
        # swap-out under the lock so a concurrent _batcher_for either
        # sees the live dict or None — never a half-closed batcher
        with self._lock:
            batchers, self._batchers = self._batchers, None
        if batchers:
            for b in batchers.values():
                b.close()

    def _batcher_for(self, dim: int, metric: str = "cosine",
                     ns: str = ""):
        """Serving batcher for a (namespace, dim, metric) bucket;
        filters ride as cohort keys inside the batcher."""
        batchers = self._batchers   # snapshot: disable may race us
        if batchers is None:
            return None
        key = (ns, dim, metric)
        b = batchers.get(key)
        if b is None:
            from neumann_tpu_torch.server.batcher import QueryBatcher

            with self._lock:
                if self._batchers is not batchers:
                    return None     # disabled (or swapped) concurrently
                b = batchers.get(key)
                if b is None:
                    b = batchers[key] = QueryBatcher(
                        self.vector, dim, ns=ns, metric=metric,
                        max_wait_ms=self._batcher_wait_ms)
        return b

    def warmup(self, buckets=(1, 4, 16, 64, 256),
               top_ks=(5, 10)) -> int:
        """Warm every loaded corpus at every query bucket and k
        (``VectorEngine.warmup``): servers call this before taking
        traffic, so the first SIMILAR pays neither the kernels' build
        nor a device view's or auto-IVF index's. Returns the number of
        warm calls."""
        return self.vector.warmup(buckets=buckets, top_ks=top_ks)

    # -- module attachment ---------------------------------------------------
    def init_vault(self, master_password: str, **kw) -> None:
        from neumann_tpu_torch.vault import TensorVault

        self.vault = TensorVault(self.store, master_password, **kw)

    def init_cache(self, **kw) -> None:
        from neumann_tpu_torch.cache import LLMCache

        self.cache = LLMCache(**kw)

    def init_blob(self) -> None:
        from neumann_tpu_torch.blob import BlobStore

        self.blob = BlobStore(self.store)

    def init_checkpoints(self, directory: str, **kw) -> None:
        from neumann_tpu_torch.checkpoint import CheckpointManager

        self.checkpoints = CheckpointManager(self.store, directory, **kw)

    def init_chain(self, embedding_dim: int = 64, **kw) -> None:
        from neumann_tpu_torch.chain import TensorChain

        kw.setdefault("device", self.device)
        self.chain = TensorChain(self.store, embedding_dim, **kw)

    def attach_planner(self, planner, executors: Dict[str, object],
                       nprobe: Optional[int] = None) -> None:
        """Wire distributed planning into execute() itself (parity
        with try_execute_distributed, query_router/src/lib.rs:
        1751-1773 + distributed.rs:126-208): every statement is
        classified local / scatter-gather / routed before it runs,
        shard results merge by TopK/Aggregate/Concat/FirstNonEmpty,
        and SIMILAR with a vector literal routes semantically (probe
        the nearest shards only) when the planner has a
        SemanticPartitioner. ``executors`` maps shard name ->
        callable(query) -> QueryResult; the local shard defaults to
        direct in-process execution.
        """
        from neumann_tpu_torch.parallel.distributed import (
            DistributedExecutor,
        )

        executors = dict(executors)
        executors.setdefault(
            planner.local,
            lambda q: self.execute_statement(parse_cached(q)))
        self._dist = DistributedExecutor(planner, executors)
        self._dist_nprobe = nprobe

    def detach_planner(self) -> None:
        self._dist = None

    def _try_execute_distributed(self, query: str, stmt
                                 ) -> Optional[QueryResult]:
        """None = the plan says local; caller falls through to normal
        execution (writes replicate via Raft, not via the planner)."""
        dist = self._dist
        if dist is None or isinstance(stmt, (ast.Cluster, ast.Empty,
                                             ast.Explain)):
            return None
        emb = None
        if isinstance(stmt, ast.Similar) and stmt.query_vector:
            emb = np.asarray(stmt.query_vector, np.float32)
        planner = dist.planner
        plan = (planner.plan_with_embedding(query, emb, self._dist_nprobe)
                if emb is not None else planner.plan(query))
        if plan.kind == "local":
            return None
        return dist.execute(query, embedding=emb, nprobe=self._dist_nprobe,
                            plan=plan)

    # -- entry points ---------------------------------------------------------
    def execute(self, query: str) -> QueryResult:
        t0 = time.perf_counter()
        kind = "Unparsed"
        try:
            if looks_like_cypher(query):
                kind = "Cypher"
                out = self._execute_cypher(query)
            else:
                stmt = parse_cached(query)
                kind = type(stmt).__name__
                out = self._try_execute_distributed(query, stmt)
                cc = self.cluster_client
                if out is None and cc is not None and \
                        not self._reads_stay_local(stmt) and \
                        not isinstance(stmt, (ast.Cluster, ast.Empty)):
                    return self._execute_remote(cc, query, kind, t0)
                if out is None:
                    out = self._try_cache_get(kind, query)
                if out is None:
                    writes = self.vector.writes
                    out = self.execute_statement(stmt)
                    self._try_cache_put(kind, query, out, writes)
        except Exception:
            self.metrics.record(kind, (time.perf_counter() - t0) * 1e3,
                                error=True, query=query)
            raise
        self.metrics.record(kind, (time.perf_counter() - t0) * 1e3,
                            query=query)
        return out

    # -- the query cache: results of SIMILAR, SELECT and FIND by their
    # statement text. Off by default; enable_query_cache()
    _CACHEABLE = ("Similar", "Select", "Find")
    # the most statements it holds (the oldest go first): the LLM cache's
    # default capacity, which the JAX router's query cache takes
    _QUERY_CACHE_CAPACITY = 10_000

    def enable_query_cache(self) -> None:
        """Serve a repeated SIMILAR, SELECT or FIND from a dict of the
        router's, up to ``_QUERY_CACHE_CAPACITY`` statements.
        Only a statement of the same text is answered, each time with a
        copy. The dict is emptied at the store's next write, which the
        vector engine counts (``VectorEngine.writes``: every put and
        delete through its store hooks, engine calls and ROLLBACK too,
        and each ``ingest_matrix``), and a result computed across a
        write is not kept."""
        with self._cache_lock:
            if self._query_cache is None:
                self._query_cache = {}

    def _try_cache_get(self, kind: str, query: str):
        if self._query_cache is None or kind not in self._CACHEABLE:
            return None
        with self._cache_lock:
            if self._cache_writes != self.vector.writes:
                self._query_cache.clear()
                self._cache_writes = self.vector.writes
            out = self._query_cache.get(query)
        return None if out is None else copy.deepcopy(out)

    def _try_cache_put(self, kind: str, query: str, result,
                       writes: int) -> None:
        if self._query_cache is None or kind not in self._CACHEABLE:
            return
        with self._cache_lock:
            if writes != self.vector.writes:
                return            # a write landed while it ran
            cache = self._query_cache
            if self._cache_writes != writes:
                cache.clear()
                self._cache_writes = writes
            if len(cache) >= self._QUERY_CACHE_CAPACITY:
                del cache[next(iter(cache))]
            cache[query] = copy.deepcopy(result)

    def _execute_remote(self, cc, query: str, kind: str,
                        t0: float) -> QueryResult:
        """Under CLUSTER CONNECT: the statement runs on the cluster."""
        remote = cc.execute(query, strong=True)
        self.metrics.record(kind, (time.perf_counter() - t0) * 1e3,
                            query=query)
        return QueryResult(
            kind=remote.get("kind", "message"),
            message=remote.get("message") or "",
            rows=remote.get("rows") or [],
            count=remote.get("count"),
            results=remote.get("hits") or [],
            value=remote.get("value"))

    # statements with no write side anywhere in their execution path —
    # safe to serve from local replicated state under CLUSTER CONNECT
    _READ_ONLY_STMTS = (
        ast.Select, ast.ShowTables, ast.Describe, ast.NodeGet,
        ast.NodeList, ast.EdgeGet, ast.EdgeList, ast.Neighbors,
        ast.Path, ast.PageRank, ast.GraphAlgorithm, ast.GraphPattern,
        ast.GraphAggregate, ast.EmbedGet, ast.Similar,
        ast.ShowEmbeddings, ast.CountEmbeddings, ast.ShowCollections,
        ast.Find, ast.EntityGet, ast.Blobs, ast.Checkpoints,
        ast.Explain)

    def _reads_stay_local(self, stmt) -> bool:
        """Gateway read policy. ``cluster_read_mode``:
        - "forward" (default): everything ships to the cluster — right
          for thin clients whose local store is empty;
        - "local": read-only statements execute against local state —
          right for routers embedded in a cluster NODE, where the
          store is Raft-replicated (eventual consistency on
          followers, like the reference's follower reads)."""
        return (self.cluster_read_mode == "local"
                and isinstance(stmt, self._READ_ONLY_STMTS))

    def _execute_cypher(self, query: str) -> QueryResult:
        q = parse_cypher(query)
        if q.kind in ("create", "merge") or q.delete_vars:
            self._auto_ckpt("update", "cypher")
        rows = CypherExecutor(self.graph).execute(q)
        return QueryResult.of_rows(rows)

    def execute_many(self, query: str) -> List[QueryResult]:
        return [self.execute_statement(s) for s in parse_many(query)]

    def execute_paginated(self, query: str, page_size: int,
                          cursor: Optional[str] = None,
                          ttl: Optional[float] = None):
        """Returns (rows, next_cursor). Cursor survives across calls.

        Cursors live in a bounded, TTL-expiring store (LRU-evicted at
        capacity); resuming an expired or evicted cursor raises
        NeumannError.
        """
        with self._lock:
            try:
                if cursor is not None:
                    state = self.cursor_store.get(cursor)
                else:
                    result = self.execute(query)
                    rows = result.rows or result.results
                    state = self.cursor_store.new_cursor(
                        query, rows, page_size, ttl=ttl)
            except CursorError as e:
                raise NeumannError(str(e)) from e
            page = state.rows[state.pos: state.pos + page_size]
            state.pos += len(page)
            if not state.has_more():
                self.cursor_store.remove(state.id)
                return page, None
            return page, state.id

    def close_cursor(self, cursor: str) -> bool:
        return self.cursor_store.remove(cursor)

    # -- auto checkpoint -------------------------------------------------------
    def _auto_ckpt(self, op: str, detail: str = "") -> None:
        if self.checkpoints is not None:
            self.checkpoints.auto_checkpoint(op, detail)

    def execute_statement(self, stmt: ast.Statement) -> QueryResult:
        name = type(stmt).__name__
        handler = getattr(self, f"_exec_{name.lower()}", None)
        if handler is None:
            raise NeumannError(f"statement {name} not yet executable")
        return handler(stmt)

    def _exec_createtable(self, s: ast.CreateTable) -> QueryResult:
        if s.if_not_exists and self.relational.table_exists(s.table):
            return QueryResult.msg(f"table '{s.table}' already exists")
        cols = []
        for c in s.columns:
            fk = None
            if c.references:
                fk = ForeignKey(*c.references)
            cols.append(Column(c.name, c.ctype, nullable=c.nullable,
                               unique=c.unique, primary_key=c.primary_key,
                               default=c.default, references=fk,
                               check=c.check))
        self.relational.create_table(s.table, cols, checks=s.checks,
                                     uniques=s.uniques)
        return QueryResult.msg(f"table '{s.table}' created")

    def _exec_droptable(self, s: ast.DropTable) -> QueryResult:
        if s.if_exists and not self.relational.table_exists(s.table):
            return QueryResult.msg(f"table '{s.table}' does not exist")
        self._auto_ckpt("drop_table", s.table)
        self.relational.drop_table(s.table)
        return QueryResult.msg(f"table '{s.table}' dropped")

    def _exec_createindex(self, s: ast.CreateIndex) -> QueryResult:
        for col in s.columns:
            if s.btree:
                self.relational.create_btree_index(s.table, col)
            else:
                self.relational.create_index(s.table, col)
        return QueryResult.msg(
            f"index created on {s.table}({', '.join(s.columns)})")

    def _exec_dropindex(self, s: ast.DropIndex) -> QueryResult:
        if s.table and s.column:
            ok = self.relational.drop_index(s.table, s.column)
            return QueryResult.msg("index dropped" if ok
                                   else "no such index")
        return QueryResult.msg("named indexes are addressed as "
                               "DROP INDEX ON table(column)")

    # -- subquery resolution (IN / EXISTS / scalar comparisons) ------------
    def _resolve_subqueries(self, cond: Optional[Condition]
                            ) -> Optional[Condition]:
        """Replace ast.Subquery values with concrete results before the
        condition reaches the engines (non-correlated subqueries)."""
        if cond is None:
            return None
        from dataclasses import replace as _replace

        if cond.op == "exists":
            rows = self._subquery_rows(cond.value)
            t = Condition.true()
            return t if rows else t.not_()
        changed = {}
        if isinstance(cond.value, ast.Subquery):
            rows = self._subquery_rows(cond.value)
            vals = [next(iter(r.values()), None) for r in rows]
            if cond.op == "in":
                changed["value"] = tuple(v for v in vals
                                         if v is not None)
            else:                       # scalar comparison
                if len(vals) > 1:
                    raise NeumannError(
                        "scalar subquery returned more than one row")
                if not vals or vals[0] is None:
                    return Condition.true().not_()  # NULL -> no match
                changed["value"] = vals[0]
        left = self._resolve_subqueries(cond.left)
        right = self._resolve_subqueries(cond.right)
        if changed or left is not cond.left or right is not cond.right:
            return _replace(cond, left=left, right=right, **changed)
        return cond

    def _subquery_rows(self, sub: "ast.Subquery") -> List[dict]:
        return self._exec_select(sub.select).rows

    # shared ORDER BY: specs are (col, desc) or (col, desc, nulls_first);
    # the 2-tuple default matches SQL (NULLS LAST asc, NULLS FIRST desc)
    @staticmethod
    def _sort_rows(rows: List[dict], order_by) -> None:
        for spec in reversed(list(order_by)):
            col, desc = spec[0], spec[1]
            nf = spec[2] if len(spec) > 2 else desc
            rows.sort(
                key=lambda r: ((r.get(col) is None) ^ nf ^ desc,
                               r.get(col) is None, r.get(col)),
                reverse=desc)

    @staticmethod
    def _project_items(rows, items, unq=None):
        """Project select items onto fetched rows: plain columns,
        AS aliases, and expression trees (arith/CASE/CAST)."""
        if all(i.expr == "*" and i.tree is None for i in items):
            return rows
        u = unq or (lambda n: n)
        plan = []
        for it in items:
            if it.expr == "*" and it.tree is None:
                plan.append(("star", None, None))
            elif it.tree is not None:
                tree = it.tree.map_cols(u) if unq is not None else it.tree
                plan.append(("expr", it.alias or it.expr, tree))
            else:
                name = u(it.expr)
                plan.append(("col", it.alias or name, name))
        out = []
        for r in rows:
            rec = {}
            for kind, key, arg in plan:
                if kind == "star":
                    rec.update(r)
                elif kind == "col":
                    rec[key] = r.get(arg)
                else:
                    rec[key] = arg.evaluate(r)
            out.append(rec)
        return out

    def _exec_insert(self, s: ast.Insert) -> QueryResult:
        if s.select is not None:          # INSERT INTO t ... SELECT ...
            src = self._exec_select(s.select).rows
            if s.columns is not None:
                rows = []
                for r in src:
                    vals = list(r.values())
                    if len(vals) != len(s.columns):
                        raise NeumannError(
                            "column/value count mismatch")
                    rows.append(dict(zip(s.columns, vals)))
            else:
                schema = self.relational.describe(s.table)
                names = [c["name"] for c in schema]
                rows = []
                for r in src:
                    vals = list(r.values())
                    if len(vals) != len(names):
                        raise NeumannError(
                            "column/value count mismatch")
                    rows.append(dict(zip(names, vals)))
            ids = self.relational.insert_many(s.table, rows)
            return QueryResult("count", count=len(ids),
                               message=f"inserted {len(ids)} row(s)",
                               value=ids)
        rows = []
        for values in s.rows:
            if s.columns is not None:
                if len(values) != len(s.columns):
                    raise NeumannError("column/value count mismatch")
                rows.append(dict(zip(s.columns, values)))
            else:
                schema = self.relational.describe(s.table)
                names = [c["name"] for c in schema]
                if len(values) != len(names):
                    raise NeumannError("column/value count mismatch")
                rows.append(dict(zip(names, values)))
        ids = self.relational.insert_many(s.table, rows)
        return QueryResult("count", count=len(ids),
                           message=f"inserted {len(ids)} row(s)",
                           value=ids)

    @staticmethod
    def _agg_over_rows(aggs, rows) -> dict:
        """Aggregate select items over materialized row dicts (the
        joined-rows path; plain-table aggregates stay on the engine's
        columnar fast path). SQL NULL rules: COUNT(col) skips NULLs,
        SUM/AVG/MIN/MAX of an empty set are NULL."""
        out = {}
        for item in aggs:
            alias = item.alias or _agg_alias(item)
            if item.agg == "count" and item.expr in ("*", ""):
                out[alias] = len(rows)
                continue
            vals = [r.get(item.expr) for r in rows]
            vals = [v for v in vals if v is not None]
            if item.distinct:
                vals = list(dict.fromkeys(vals))
            if item.agg == "count":
                out[alias] = len(vals)
            elif not vals:
                out[alias] = None
            elif item.agg == "sum":
                # int inputs keep an integral (overflow-proof) sum
                tot = sum(vals)
                out[alias] = tot.item() if hasattr(tot, "item") else tot
            elif item.agg == "avg":
                out[alias] = float(sum(vals)) / len(vals)
            elif item.agg == "min":
                out[alias] = min(vals)
            elif item.agg == "max":
                out[alias] = max(vals)
        return out

    def _group_over_rows(self, s, rows, having) -> list:
        """GROUP BY over materialized (joined) row dicts."""
        groups: dict = {}
        for r in rows:
            key = tuple(r.get(g) for g in s.group_by)
            groups.setdefault(key, []).append(r)
        aggs = [i for i in s.items if i.agg]
        out = []
        for key, members in groups.items():
            rec = dict(zip(s.group_by, key))
            rec.update(self._agg_over_rows(aggs, members))
            out.append(rec)
        if having is not None:
            import re as _re

            # HAVING refs canonical agg names (count(*), sum(col)...):
            # alias them from select items, or compute hidden ones
            canon = [(f"{i.agg}({i.expr})", i.alias)
                     for i in aggs if i.alias]
            hidden = []
            present = {c for c, _ in canon} | {
                f"{i.agg}({i.expr})" for i in aggs}
            for col in having.columns():
                m = _re.fullmatch(r"(count|sum|avg|min|max)\((.*)\)",
                                  col)
                if m and col not in present:
                    hidden.append((col, m.group(1),
                                   m.group(2)))
            kept = []
            for rec, members in zip(out, groups.values()):
                probe = dict(rec)
                for cname, alias in canon:
                    probe.setdefault(cname, rec.get(alias))
                for cname, fn, arg in hidden:
                    item = ast.SelectItem(arg, agg=fn)
                    probe[cname] = self._agg_over_rows(
                        [item], members)[cname]
                if having.evaluate_row(probe):
                    kept.append(rec)
            out = kept
        return out

    def _joined_rows(self, s, where) -> list:
        """Materialize the FROM ... JOIN ... chain, WHERE-filtered."""
        rows = None
        base = s.table
        for j in s.joins:
            if j.how == "natural":
                rows = self.relational.natural_join(base, j.table)
            elif j.how == "cross":
                rows = self.relational.join(base, j.table, "_id",
                                            "_id", "cross")
            else:
                rows = self.relational.join(base, j.table, j.left_col,
                                            j.right_col, j.how)
            if j.using and len(j.using) > 1:
                # USING (a, b, ...): equality on every listed column
                rows = [r for r in rows
                        if all(r.get(f"{base}.{c}") is not None
                               and r.get(f"{base}.{c}")
                               == r.get(f"{j.table}.{c}")
                               for c in j.using[1:])]
        if where is not None:
            rows = [r for r in rows if where.evaluate_row(r)]
        return rows

    def _exec_select(self, s: ast.Select) -> QueryResult:
        if s.limit is not None and s.limit < 0:
            # sqlite semantics: a negative LIMIT means no limit (the
            # raw slice rows[:-1] would silently DROP the last row)
            s.limit = None
        where = self._resolve_subqueries(s.where)
        having = self._resolve_subqueries(s.having)
        # aggregates without GROUP BY
        aggs = [i for i in s.items if i.agg]
        if s.joins and (aggs or s.group_by):
            # aggregate/group over the JOINED rows, not the base table
            rows = self._joined_rows(s, where)
            if s.group_by:
                out = self._group_over_rows(s, rows, having)
                if s.order_by:
                    self._sort_rows(out, s.order_by)
                if s.offset:
                    out = out[s.offset:]
                if s.limit is not None:
                    out = out[: s.limit]
                return QueryResult.of_rows(out)
            return QueryResult.of_rows([self._agg_over_rows(aggs, rows)])
        if aggs and not s.group_by:
            out = {}
            for item in aggs:
                alias = item.alias or _agg_alias(item)
                if item.distinct:
                    vals = [v.item() if hasattr(v, "item") else v
                            for v in self.relational.distinct_values(
                                s.table, item.expr, where)]
                    if item.agg == "count":
                        out[alias] = len(vals)
                    elif not vals:
                        out[alias] = None
                    else:
                        try:
                            if item.agg == "sum":
                                # Python sum keeps ints integral
                                out[alias] = sum(
                                    v if isinstance(v, (int, float))
                                    else float(v) for v in vals)
                            elif item.agg == "avg":
                                out[alias] = float(
                                    sum(float(v) for v in vals)
                                ) / len(vals)
                            elif item.agg == "min":
                                out[alias] = min(vals)
                            else:
                                out[alias] = max(vals)
                        except (TypeError, ValueError):
                            raise NeumannError(
                                "aggregate on non-numeric column "
                                f"{item.expr}") from None
                elif item.agg == "count":
                    # COUNT(*) counts rows; COUNT(col) non-null values
                    out[alias] = (
                        self.relational.count(s.table, where)
                        if item.expr in ("*", "")
                        else self.relational.count_column(
                            s.table, item.expr, where))
                else:
                    fn = getattr(self.relational, f"{item.agg}_column")
                    out[alias] = fn(s.table, item.expr, where)
            return QueryResult.of_rows([out])
        if s.group_by:
            agg_spec = [
                (f"{i.agg}-distinct" if i.distinct else (i.agg or "count"),
                 i.expr if i.expr != "*" else "",
                 i.alias or _agg_alias(i))
                for i in s.items if i.agg]
            # HAVING may reference aggregates not in the select list:
            # compute them under their canonical alias, strip after
            hidden = []
            if having is not None:
                import re as _re

                present = {a[2] for a in agg_spec}
                for col in having.columns():
                    m = _re.fullmatch(
                        r"(count|sum|avg|min|max)\((.*)\)", col)
                    if m and col not in present:
                        fn, arg = m.group(1), m.group(2)
                        agg_spec.append(
                            (fn, "" if arg == "*" else arg, col))
                        hidden.append(col)
            rows = self.relational.group_by(s.table, s.group_by, agg_spec,
                                            where, having)
            if hidden:
                rows = [{k: v for k, v in r.items() if k not in hidden}
                        for r in rows]
            if s.order_by:
                self._sort_rows(rows, s.order_by)
            if s.offset:
                rows = rows[s.offset:]
            if s.limit is not None:
                rows = rows[: s.limit]
            return QueryResult.of_rows(rows)
        if s.joins:
            rows = self._joined_rows(s, where)
            # ORDER BY may name a select-list alias (or an expression's
            # label) — those keys only exist after projection, so sort
            # late in that case (SQL gives aliases precedence here)
            aliases = {i.alias for i in s.items if i.alias} | {
                i.expr for i in s.items
                if i.tree is not None and not i.alias}
            late = bool(s.order_by) and any(
                sp[0] in aliases for sp in s.order_by)
            if late:
                rows = self._project_items(rows, s.items)
            if s.order_by:
                self._sort_rows(rows, s.order_by)
            if s.limit is not None:
                rows = rows[s.offset: s.offset + s.limit]
            elif s.offset:
                rows = rows[s.offset:]
            if not late:
                rows = self._project_items(rows, s.items)
            return QueryResult.of_rows(rows)
        def _unqualify(name):
            # single-table queries may still alias-qualify columns
            return name[len(s.table) + 1:] \
                if name.startswith(s.table + ".") else name

        def _unqualify_cond(c):
            if c is None:
                return None
            from dataclasses import replace as _replace

            kw = {}
            if c.column is not None:
                kw["column"] = _unqualify(c.column)
            return _replace(c, left=_unqualify_cond(c.left),
                            right=_unqualify_cond(c.right), **kw)

        needs_project = any(i.tree is not None or i.alias
                            for i in s.items)
        cols = None
        if not needs_project and not any(i.expr == "*"
                                         for i in s.items):
            cols = [_unqualify(i.expr) for i in s.items]
        # an ORDER BY naming a select-list alias (or an expression's
        # label) can only be sorted AFTER projection — the engine sees
        # table columns only, so sorting there silently no-ops and
        # LIMIT/OFFSET would slice unsorted rows
        aliases = {i.alias for i in s.items if i.alias} | {
            i.expr for i in s.items if i.tree is not None and not i.alias}
        specs = [(_unqualify(sp[0]), *sp[1:]) for sp in s.order_by]
        late = any(sp[0] in aliases for sp in specs)
        rows = self.relational.select(
            s.table, _unqualify_cond(where), columns=cols,
            order_by=None if late else (specs or None),
            limit=None if late else s.limit,
            offset=0 if late else s.offset)
        if needs_project:
            rows = self._project_items(rows, s.items, unq=_unqualify)
        if late:
            self._sort_rows(rows, specs)
            if s.offset:
                rows = rows[s.offset:]
            if s.limit is not None:
                rows = rows[: s.limit]
        if s.distinct:
            seen = set()
            uniq = []
            for r in rows:
                key = tuple(sorted((k, repr(v)) for k, v in r.items()))
                if key not in seen:
                    seen.add(key)
                    uniq.append(r)
            rows = uniq
        return QueryResult.of_rows(rows)

    def _exec_update(self, s: ast.Update) -> QueryResult:
        self._auto_ckpt("update", s.table)
        n = self.relational.update(s.table,
                                   self._resolve_subqueries(s.where),
                                   s.updates)
        return QueryResult("count", count=n, message=f"updated {n} row(s)")

    def _exec_delete(self, s: ast.Delete) -> QueryResult:
        self._auto_ckpt("delete", s.table)
        n = self.relational.delete(s.table,
                                   self._resolve_subqueries(s.where))
        return QueryResult("count", count=n, message=f"deleted {n} row(s)")

    def _exec_showtables(self, s) -> QueryResult:
        return QueryResult.of_rows(
            [{"table": t, "rows": self.relational.row_count(t)}
             for t in self.relational.list_tables()])

    def _exec_describe(self, s: ast.Describe) -> QueryResult:
        if s.target == "table":
            return QueryResult.of_rows(self.relational.describe(s.name))
        if s.target == "node":
            nodes = self.graph.find_nodes(s.name, limit=100)
            props = sorted({p for n in nodes for p in n["properties"]})
            return QueryResult.of_rows(
                [{"label": s.name, "count": len(nodes),
                  "properties": ", ".join(props)}])
        with self.graph._lock:
            n = sum(1 for e in self.graph._edges.values()
                    if e["type"] == s.name)
        return QueryResult.of_rows([{"type": s.name, "count": n}])

    # -- graph -----------------------------------------------------------------
    def _exec_nodecreate(self, s: ast.NodeCreate) -> QueryResult:
        nid = self.graph.create_node(s.label, s.properties)
        return QueryResult("value", value=nid,
                           message=f"node {nid} created")

    def _exec_nodeget(self, s: ast.NodeGet) -> QueryResult:
        node = self.graph.get_node(_as_id(s.node_id, "node id"))
        if node is None:
            return QueryResult.msg(f"no node {s.node_id}")
        return QueryResult.of_rows([{
            "id": node["id"], "label": node["label"],
            **node["properties"]}])

    def _exec_nodedelete(self, s: ast.NodeDelete) -> QueryResult:
        self._auto_ckpt("delete", f"node {s.node_id}")
        ok = self.graph.delete_node(_as_id(s.node_id, "node id"))
        return QueryResult.msg(
            f"node {s.node_id} deleted" if ok else f"no node {s.node_id}")

    def _exec_nodelist(self, s: ast.NodeList) -> QueryResult:
        nodes = self.graph.find_nodes(s.label, limit=s.limit,
                                      offset=s.offset)
        return QueryResult.of_rows([
            {"id": n["id"], "label": n["label"], **n["properties"]}
            for n in nodes])

    def _exec_edgecreate(self, s: ast.EdgeCreate) -> QueryResult:
        eid = self.graph.create_edge(_as_id(s.src, "node id"), _as_id(s.dst, "node id"), s.edge_type,
                                     s.properties or None)
        return QueryResult("value", value=eid,
                           message=f"edge {eid} created")

    def _exec_edgeget(self, s: ast.EdgeGet) -> QueryResult:
        e = self.graph.get_edge(_as_id(s.edge_id, "edge id"))
        if e is None:
            return QueryResult.msg(f"no edge {s.edge_id}")
        return QueryResult.of_rows([{
            "id": e["id"], "src": e["src"], "dst": e["dst"],
            "type": e["type"], **e["properties"]}])

    def _exec_edgedelete(self, s: ast.EdgeDelete) -> QueryResult:
        ok = self.graph.delete_edge(_as_id(s.edge_id, "edge id"))
        return QueryResult.msg(
            f"edge {s.edge_id} deleted" if ok else f"no edge {s.edge_id}")

    def _exec_edgelist(self, s: ast.EdgeList) -> QueryResult:
        with self.graph._lock:
            edges = [{"id": eid, "src": e["src"], "dst": e["dst"],
                      "type": e["type"]}
                     for eid, e in sorted(self.graph._edges.items())
                     if s.edge_type is None or e["type"] == s.edge_type]
        edges = edges[s.offset:]
        if s.limit is not None:
            edges = edges[: s.limit]
        return QueryResult.of_rows(edges)

    def _exec_neighbors(self, s: ast.Neighbors) -> QueryResult:
        nid = _as_id(s.node_id, "node id")
        if s.by_similarity is not None:
            # cross-engine: rank neighbors by embedding similarity
            key = self.unified.key_of_node(nid)
            limit = s.limit or 10
            if s.by_similarity:
                query = np.asarray(s.by_similarity, np.float32)
            elif key is not None:
                query = key
            else:
                raise NeumannError(
                    "BY SIMILARITY needs a vector or an entity node")
            if key is not None and not len(s.by_similarity or []):
                res = self.unified.find_neighbors_by_similarity(key, limit)
            else:
                neighbor_ids = self.graph.neighbors(nid, s.direction,
                                                    s.edge_type)
                keys = {self.unified.key_of_node(x) for x in neighbor_ids}
                keys.discard(None)
                if not keys:
                    return QueryResult("similar", results=[])
                vecq = self.unified._resolve_query_vec(query)
                mask = self.unified._keys_to_row_mask(keys, vecq.size)
                res = self.vector.search_entities(vecq, limit,
                                                  mask_rows=mask)
            return QueryResult("similar", results=[
                {"key": r.key, "score": r.score} for r in res])
        ids = self.graph.neighbors(nid, s.direction, s.edge_type)
        if s.limit:
            ids = ids[: s.limit]
        return QueryResult.of_rows([{"id": i} for i in ids])

    def _exec_path(self, s: ast.Path) -> QueryResult:
        a, b = _as_id(s.src, "node id"), _as_id(s.dst, "node id")
        if s.mode == "shortest":
            p = self.graph.find_path(a, b, s.max_depth or 0)
            return QueryResult("value", value=p,
                               message="no path" if p is None else
                               " -> ".join(map(str, p)))
        if s.mode == "weighted":
            r = self.graph.find_weighted_path(a, b, s.weight or "weight")
            if r is None:
                return QueryResult("value", value=None, message="no path")
            path, cost = r
            return QueryResult("value", value={"path": path, "cost": cost},
                               message=f"cost {cost}: " +
                               " -> ".join(map(str, path)))
        if s.mode == "variable":
            paths = self.graph.find_variable_paths(
                a, b, s.min_depth or 1, s.max_depth or 10)
        else:
            paths = self.graph.find_all_paths(a, b, s.max_depth or 10)
            if s.min_depth:
                paths = [p for p in paths if len(p) - 1 >= s.min_depth]
        return QueryResult("value", value=paths,
                           message=f"{len(paths)} path(s)")

    def _exec_pagerank(self, s: ast.PageRank) -> QueryResult:
        pr = self.graph.pagerank(s.damping, s.max_iterations)
        rows = [{"id": k, "rank": v}
                for k, v in sorted(pr.items(), key=lambda kv: -kv[1])]
        return QueryResult.of_rows(rows)

    def _exec_graphalgorithm(self, s: ast.GraphAlgorithm) -> QueryResult:
        params = dict(s.params)
        params.pop("edge_type", None)  # algorithms run over all edges
        if s.name == "betweenness":
            params.pop("direction", None)
            out = self.graph.betweenness_centrality(**params)
            key = "betweenness"
        elif s.name == "closeness":
            out = self.graph.closeness_centrality(
                direction=params.get("direction", "both"))
            key = "closeness"
        elif s.name == "eigenvector":
            params.pop("direction", None)
            out = self.graph.eigenvector_centrality(**params)
            key = "centrality"
        elif s.name == "louvain":
            params.pop("direction", None)
            out = self.graph.louvain(**params)
            key = "community"
        elif s.name == "label_propagation":
            params.pop("direction", None)
            out = self.graph.label_propagation(**params)
            key = "community"
        else:
            raise NeumannError(f"unknown graph algorithm {s.name}")
        rows = [{"id": nid, key: val}
                for nid, val in sorted(out.items(),
                                       key=lambda kv: (-kv[1]
                                                       if isinstance(
                                                           kv[1], float)
                                                       else kv[1], kv[0]))]
        return QueryResult.of_rows(rows)

    def _exec_graphconstraint(self, s: ast.GraphConstraint) -> QueryResult:
        if s.action == "create":
            self.graph.create_constraint(s.name, s.target, s.prop,
                                         s.kind, s.label, vtype=s.vtype)
            return QueryResult.msg(f"constraint '{s.name}' created")
        if s.action == "drop":
            ok = self.graph.drop_constraint(s.name)
            return QueryResult.msg("dropped" if ok
                                   else f"no constraint '{s.name}'")
        if s.action == "get":
            spec = self.graph.get_constraint(s.name)
            return QueryResult.of_rows([spec] if spec else [])
        return QueryResult.of_rows(self.graph.list_constraints())

    def _exec_graphindex(self, s: ast.GraphIndex) -> QueryResult:
        if s.action == "create":
            if s.target == "node" and s.prop:
                self.graph.create_property_index(s.prop)
                return QueryResult.msg(f"node property index on "
                                       f"'{s.prop}' created")
            return QueryResult.msg(
                "label/edge-type lookups are always indexed")
        if s.action == "drop":
            ok = self.graph.drop_property_index(s.prop) if s.prop \
                else False
            return QueryResult.msg("dropped" if ok else "no such index")
        return QueryResult.of_rows(
            [{"property": p} for p in sorted(self.graph._prop_indexes)])

    def _exec_graphpattern(self, s: ast.GraphPattern) -> QueryResult:
        from neumann_tpu_torch.lang.cypher import (
            CypherExecutor,
            _CypherParser,
        )

        parser = _CypherParser(s.pattern)
        pattern = parser.pattern()
        execu = CypherExecutor(self.graph)
        bindings = execu._match_pattern(pattern)
        if s.mode == "count":
            return QueryResult.of_count(len(bindings))
        if s.mode == "exists":
            return QueryResult.of_value(bool(bindings))
        rows = [execu._row_view(b) for b in bindings]
        if s.limit is not None:
            rows = rows[: s.limit]
        return QueryResult.of_rows(rows)

    def _exec_graphbatch(self, s: ast.GraphBatch) -> QueryResult:
        if s.action == "create_nodes":
            ids = self.graph.batch_create_nodes(s.items)
            return QueryResult("value", value=ids,
                               message=f"created {len(ids)} nodes")
        if s.action == "create_edges":
            ids = [self.graph.create_edge(_as_id(a), _as_id(b), t, p or None)
                   for a, b, t, p in s.items]
            return QueryResult("value", value=ids,
                               message=f"created {len(ids)} edges")
        if s.action == "update_nodes":
            for nid, props in s.items:
                self.graph.update_node(_as_id(nid), props)
            return QueryResult.msg(f"updated {len(s.items)} nodes")
        if s.action == "delete_nodes":
            self._auto_ckpt("delete", "graph batch")
            n = sum(1 for nid in s.items
                    if self.graph.delete_node(_as_id(nid)))
            return QueryResult.msg(f"deleted {n} nodes")
        if s.action == "delete_edges":
            n = sum(1 for eid in s.items
                    if self.graph.delete_edge(_as_id(eid)))
            return QueryResult.msg(f"deleted {n} edges")
        raise NeumannError(f"graph batch action {s.action} unsupported")

    def _exec_graphaggregate(self, s: ast.GraphAggregate) -> QueryResult:
        if s.prop is None:
            if s.target == "nodes":
                n = len(self.graph.find_nodes(s.label, s.where)) \
                    if (s.label or s.where is not None) \
                    else self.graph.node_count()
            elif s.label or s.where is not None:
                with self.graph._lock:
                    n = sum(1 for e in self.graph._edges.values()
                            if (s.label is None or e["type"] == s.label)
                            and (s.where is None
                                 or s.where.evaluate_row(e["props"])))
            else:
                n = self.graph.edge_count()
            return QueryResult.of_count(n)
        values = []
        if s.target == "nodes":
            for node in self.graph.find_nodes(s.label, s.where):
                v = node["properties"].get(s.prop)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    values.append(float(v))
        else:
            with self.graph._lock:
                edges = list(self.graph._edges.values())
            for e in edges:
                if s.label and e["type"] != s.label:
                    continue
                props = e["props"]
                if s.where is not None and \
                        not s.where.evaluate_row(props):
                    continue
                v = props.get(s.prop)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    values.append(float(v))
        if s.func == "count":
            return QueryResult.of_count(len(values))
        if not values:
            return QueryResult.of_value(None)
        fn = {"sum": sum, "avg": lambda v: sum(v) / len(v),
              "min": min, "max": max}[s.func]
        return QueryResult.of_value(fn(values))

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
        query = s.query_vector if s.query_vector is not None \
            else s.query_key
        if s.connected_to is not None:
            # a key names an entity first, then a default-namespace row
            if isinstance(query, str) and \
                    self.vector.get_entity_embedding(query) is None:
                vec = self.vector.get_embedding(query)
                if vec is None:
                    raise VectorError(f"no embedding for '{query}'")
                query = vec
            res = self.unified.find_similar_connected(
                query, s.limit, s.connected_to, s.metric)
            return QueryResult("similar", results=[
                {"key": r.key, "score": r.score} for r in res])
        q = self._resolve_query(s, query)
        filt = (_filter_from_condition(s.where) if s.where is not None
                else None)
        if s.collection is not None:
            batcher = self._batcher_for(
                len(q), s.metric or self.vector.collection_config(
                    s.collection).metric, f"col/{s.collection}")
        else:
            batcher = self._batcher_for(len(q), s.metric or "cosine")
        if batcher is not None:
            res = batcher.search(q, s.limit, filter_cond=filt)
        elif s.collection is not None:
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
        self._auto_ckpt("drop_collection", s.name)
        ok = self.vector.drop_collection(s.name)
        return QueryResult.msg(
            f"collection '{s.name}' dropped" if ok else
            f"no collection '{s.name}'")

    # -- unified -----------------------------------------------------------------
    def _exec_entitycreate(self, s: ast.EntityCreate) -> QueryResult:
        if s.update and not self.unified.entity_exists(s.key):
            raise NeumannError(f"no entity '{s.key}'")
        nid = self.unified.create_entity(s.key, s.properties, s.embedding)
        return QueryResult("value", value=nid,
                           message=f"entity '{s.key}' "
                           f"{'updated' if s.update else 'created'}")

    def _exec_entityget(self, s: ast.EntityGet) -> QueryResult:
        ent = self.unified.get_entity(s.key)
        if ent is None:
            return QueryResult.msg(f"no entity '{s.key}'")
        row = {"key": ent["key"], "node_id": ent["node_id"],
               **ent["fields"]}
        if ent["embedding"] is not None:
            row["embedding_dim"] = len(ent["embedding"])
        return QueryResult.of_rows([row])

    def _exec_entitydelete(self, s: ast.EntityDelete) -> QueryResult:
        self._auto_ckpt("delete", f"entity {s.key}")
        ok = self.unified.delete_entity(s.key)
        return QueryResult.msg(
            f"entity '{s.key}' deleted" if ok else f"no entity '{s.key}'")

    def _exec_entityconnect(self, s: ast.EntityConnect) -> QueryResult:
        eid = self.unified.connect_entities(s.src, s.dst, s.edge_type)
        return QueryResult("value", value=eid,
                           message=f"'{s.src}' -> '{s.dst}' connected")

    def _exec_entitybatchcreate(self, s: ast.EntityBatchCreate
                                ) -> QueryResult:
        # all-or-nothing: validate first (reference embed_batch
        # semantics, tensor_unified/src/lib.rs batch operations)
        for i, item in enumerate(s.items):
            if not item.get("key"):
                raise NeumannError(f"batch entity {i} missing key")
        ids = []
        for item in s.items:
            props = {k: v for k, v in item.items() if k != "key"}
            ids.append(self.unified.create_entity(str(item["key"]),
                                                  props, None))
        return QueryResult("value", value=ids,
                           message=f"created {len(ids)} entities")

    def _find_paths(self, s: ast.Find) -> QueryResult:
        """FIND PATH from -[edge]-> to: shortest paths between nodes
        of the endpoint labels, every hop matching the edge type
        (tensor_unified/src/lib.rs find_paths)."""
        limit = min(s.limit or 100, 1000)

        def ids_of(label):
            return [n["id"] for n in self.graph.find_nodes(label,
                                                           limit=None)]

        def hops_ok(path):
            if s.path_edge is None:
                return True
            return all(
                bool(self.graph.edges_between(a, b, s.path_edge))
                for a, b in zip(path, path[1:]))

        rows = []
        if s.path_from and s.path_to:
            for a in ids_of(s.path_from):
                for b in ids_of(s.path_to):
                    if len(rows) >= limit:
                        break
                    if a == b:
                        continue
                    path = self.graph.find_path(a, b)
                    if path and hops_ok(path):
                        rows.append({"from": a, "to": b, "path": path,
                                     "length": len(path) - 1})
        else:
            # single-ended: direct connections from/to the given label
            want = s.path_from or s.path_to
            end = "src" if s.path_from else "dst"
            with self.graph._lock:
                items = sorted(self.graph._edges.items())
                labels = {nid: n["label"]
                          for nid, n in self.graph._nodes.items()}
            for eid, e in items:
                if s.path_edge and e["type"] != s.path_edge:
                    continue
                if want is not None and labels.get(e[end]) != want:
                    continue
                rows.append({"from": e["src"], "to": e["dst"],
                             "path": [e["src"], e["dst"]],
                             "length": 1})
                if len(rows) >= limit:
                    break
        return QueryResult.of_rows(rows[:limit])

    def _exec_find(self, s: ast.Find) -> QueryResult:
        res = self._exec_find_inner(s)
        if s.return_items and res.kind == "rows":
            rows = [{alias: r.get(col) for col, alias in s.return_items}
                    for r in res.rows]
            return QueryResult.of_rows(rows)
        return res

    def _exec_find_inner(self, s: ast.Find) -> QueryResult:
        if s.target == "path":
            return self._find_paths(s)
        if s.target == "rows":
            rows = self.relational.select(s.label, s.where, limit=s.limit)
            return QueryResult.of_rows(rows)
        if s.target == "edge":
            out = []
            with self.graph._lock:
                items = sorted(self.graph._edges.items())
            for eid, e in items:
                if s.label and e["type"] != s.label:
                    continue
                if s.where is not None and \
                        not s.where.evaluate_row(e["props"]):
                    continue
                out.append({"id": eid, "src": e["src"],
                            "dst": e["dst"], "type": e["type"]})
                if s.limit and len(out) >= s.limit:
                    break
            return QueryResult.of_rows(out)
        # FIND NODE / FIND ENTITY
        if s.similar_to is not None or s.connected_to is not None:
            ents = self.unified.find(
                condition=s.where, similar_to=s.similar_to,
                top_k=s.limit or 10, connected_to=s.connected_to)
            rows = []
            for ent in ents:
                row = {"key": ent["key"], **ent["fields"]}
                if "score" in ent:
                    row["score"] = ent["score"]
                rows.append(row)
            return QueryResult.of_rows(rows)
        nodes = self.graph.find_nodes(s.label, s.where, limit=s.limit)
        return QueryResult.of_rows([
            {"id": n["id"], "label": n["label"], **n["properties"]}
            for n in nodes])

    def _exec_empty(self, s) -> QueryResult:
        return QueryResult.msg("")

    # -- vault ---------------------------------------------------------------
    def _need(self, attr: str, hint: str):
        mod = getattr(self, attr)
        if mod is None:
            raise NeumannError(f"{attr} not initialized — {hint}")
        return mod

    def _exec_vault(self, s: ast.Vault) -> QueryResult:
        vault = self._need("vault", "run init_vault(master_password)")
        act = s.action
        # VAULT statements act as the shell-selected identity
        # (reference: VAULT IDENTITY builtin); default is root
        actor = getattr(self, "vault_actor", None) or vault.ROOT
        if act == "set":
            vault.set(s.key, s.value, actor=actor)
            return QueryResult.msg(f"secret '{s.key}' stored")
        if act == "get":
            return QueryResult.of_value(vault.get(s.key, actor=actor))
        if act == "delete":
            ok = vault.delete(s.key, actor=actor)
            return QueryResult.msg("deleted" if ok else "no such secret")
        if act == "list":
            return QueryResult.of_rows(
                [{"key": k} for k in vault.list(s.pattern, actor=actor)])
        if act == "rotate":
            vault.rotate(s.key, s.value, actor=actor)
            return QueryResult.msg(f"secret '{s.key}' rotated")
        if act == "grant":
            vault.grant(s.entity, s.key)
            return QueryResult.msg(f"granted '{s.entity}' on '{s.key}'")
        if act == "revoke":
            vault.revoke(s.entity, s.key)
            return QueryResult.msg(f"revoked '{s.entity}' on '{s.key}'")
        if act == "seal":
            vault.seal(actor=actor)
            return QueryResult.msg("vault sealed")
        if act == "unseal":
            vault.unseal(s.value, actor=actor)
            return QueryResult.msg("vault unsealed")
        if act == "rotate_master":
            n = vault.rotate_master_key(s.value, actor=actor)
            return QueryResult.msg(
                f"master key rotated ({n} ciphertexts re-encrypted)")
        if act == "history":
            n = vault.versions(s.key, actor=actor)
            return QueryResult.of_rows([{"key": s.key,
                                         "prior_versions": n}])
        if act == "rollback":
            vault.rollback_version(s.key, actor=actor)
            return QueryResult.msg(
                f"secret '{s.key}' rolled back one version")
        if act == "audit":
            limit = int(s.pattern) if s.pattern else 100
            return QueryResult.of_rows(vault.audit_log(limit))
        raise NeumannError(f"vault action {act} unsupported")

    def _exec_cache(self, s: ast.Cache) -> QueryResult:
        if s.action == "init":
            if self.cache is None:
                self.init_cache()
            return QueryResult.msg("cache initialized")
        cache = self._need("cache", "run CACHE INIT first")
        if s.action == "stats":
            st = cache.stats
            return QueryResult.of_rows([{
                "exact_hits": st.exact_hits,
                "semantic_hits": st.semantic_hits, "misses": st.misses,
                "hit_rate": round(st.hit_rate(), 4),
                "tokens_saved": st.tokens_saved,
                "entries": len(cache)}])
        if s.action == "clear":
            cache.clear()
            return QueryResult.msg("cache cleared")
        if s.action == "evict":
            n = cache.evict(s.count or 1)
            return QueryResult.msg(f"evicted {n} entries")
        if s.action == "get":
            v = cache.get_exact(s.key)
            return QueryResult.of_value(v) if v is not None else \
                QueryResult.msg("cache miss")
        if s.action == "put":
            cache.put(s.key, s.value)
            return QueryResult.msg("cached")
        if s.action == "semantic_get":
            v = cache.get(s.key, threshold=s.threshold)
            return QueryResult.of_value(v) if v is not None else \
                QueryResult.msg("cache miss")
        if s.action == "semantic_put":
            cache.put(s.key, s.value, embedding=np.asarray(
                s.embedding, np.float32) if s.embedding else None)
            return QueryResult.msg("cached")
        raise NeumannError(f"cache action {s.action} unsupported")

    def _exec_blob(self, s: ast.Blob) -> QueryResult:
        if s.action == "init":
            if self.blob is None:
                self.init_blob()
            return QueryResult.msg("blob storage initialized")
        blob = self._need("blob", "run BLOB INIT first")
        act = s.action
        if act == "put":
            if s.data is not None:
                data = s.data.encode("utf-8")
            elif s.path is not None:
                with open(s.path, "rb") as fh:
                    data = fh.read()
            else:
                raise NeumannError("BLOB PUT needs DATA or FROM")
            aid = blob.put(s.name, data, s.content_type, s.creator)
            if s.entity:
                blob.link(aid, s.entity)
            if s.tag:
                blob.tag(aid, s.tag)
            return QueryResult("value", value=aid,
                               message=f"blob {aid} stored")
        if act == "get":
            data = blob.get(s.name)
            if s.path:
                with open(s.path, "wb") as fh:
                    fh.write(data)
                return QueryResult.msg(
                    f"{len(data)} bytes written to {s.path}")
            return QueryResult.of_value(data)
        if act == "delete":
            ok = blob.delete(s.name)
            return QueryResult.msg("deleted" if ok else "no such blob")
        if act == "info":
            return QueryResult.of_rows([blob.info(s.name)])
        if act == "link":
            blob.link(s.name, s.entity)
            return QueryResult.msg("linked")
        if act == "unlink":
            blob.unlink(s.name, s.entity)
            return QueryResult.msg("unlinked")
        if act == "links":
            return QueryResult.of_rows(
                [{"entity": e} for e in blob.links(s.name)])
        if act == "tag":
            blob.tag(s.name, s.tag)
            return QueryResult.msg("tagged")
        if act == "untag":
            blob.untag(s.name, s.tag)
            return QueryResult.msg("untagged")
        if act == "verify":
            ok = blob.verify(s.name)
            return QueryResult.msg("OK" if ok else "CORRUPT")
        if act == "gc":
            n = blob.gc(full=s.full)
            return QueryResult.msg(f"collected {n} chunks")
        if act == "repair":
            bad = blob.repair()
            return QueryResult.msg(
                "all blobs OK" if not bad else
                f"corrupt: {', '.join(bad)}")
        if act == "stats":
            return QueryResult.of_rows([blob.stats()])
        if act == "meta_set":
            blob.meta_set(s.name, s.meta_key, s.meta_value)
            return QueryResult.msg("meta set")
        if act == "meta_get":
            return QueryResult.of_value(blob.meta_get(s.name, s.meta_key))
        raise NeumannError(f"blob action {act} unsupported")

    def _exec_blobs(self, s: ast.Blobs) -> QueryResult:
        blob = self._need("blob", "run BLOB INIT first")
        if s.mode == "for":
            ids = blob.for_entity(s.entity)
        elif s.mode == "by_tag":
            ids = blob.by_tag(s.tag)
        elif s.mode == "where_type":
            ids = blob.by_type(s.content_type)
        elif s.mode == "similar":
            ids = [i for i in blob.list() if i != s.artifact][: s.limit or 10]
        else:
            ids = blob.list(s.pattern)
        return QueryResult.of_rows([blob.info(i) for i in ids])

    # -- checkpoints ---------------------------------------------------------------
    def _exec_checkpoint(self, s: ast.Checkpoint) -> QueryResult:
        ck = self._need("checkpoints", "init_checkpoints(dir) first")
        cid = ck.create(name=s.name)
        return QueryResult("value", value=cid,
                           message=f"checkpoint {cid} created")

    def _exec_checkpoints(self, s: ast.Checkpoints) -> QueryResult:
        ck = self._need("checkpoints", "init_checkpoints(dir) first")
        return QueryResult.of_rows([
            {"id": c["id"], "name": c["name"], "auto": c["auto"],
             "reason": c["reason"], "entries": c["entries"]}
            for c in ck.list(s.limit)])

    def _exec_rollback(self, s: ast.Rollback) -> QueryResult:
        ck = self._need("checkpoints", "init_checkpoints(dir) first")
        with self.vector.restoring():
            c = ck.rollback(s.target)
        # as recover() does: the unified engine's key -> node map follows
        # the restored graph (an entity deleted after the checkpoint is
        # an entity again)
        self.unified.rebuild_index()
        return QueryResult.msg(f"rolled back to {c['id']}")

    # -- statement-level chain transactions ----------------------------
    # Statements between BEGIN CHAIN TRANSACTION and COMMIT/ROLLBACK
    # write through the engines as usual, but every store mutation is
    # journaled with its prior value (the store is the authoritative
    # state; engine device slabs resync through the store's hooks), so
    # ROLLBACK CHAIN restores the pre-transaction state and COMMIT
    # CHAIN records the touched keys in the block. Parity:
    # tensor_chain/src/transaction.rs workspace semantics at the
    # query-router level. The journal is router-scoped, like the
    # transaction itself.

    def _tx_journal_start(self) -> None:
        store = self.store
        undo: list = []
        self._tx_undo = undo
        self._tx_ops: list = []
        orig_put, orig_delete = store.put, store.delete

        def tx_put(key, data, _p=orig_put, _s=store):
            undo.append(("put", key, _s.get(key)))
            self._tx_ops.append({"op": "put", "key": key})
            _p(key, data)

        def tx_delete(key, _d=orig_delete, _s=store):
            old = _s.get(key)
            ok = _d(key)
            if ok:
                undo.append(("delete", key, old))
                self._tx_ops.append({"op": "delete", "key": key})
            return ok

        store.put = tx_put
        store.delete = tx_delete
        self._tx_orig = (orig_put, orig_delete)

    def _tx_journal_detach(self) -> None:
        store = self.store
        for attr in ("put", "delete"):
            store.__dict__.pop(attr, None)
        self._tx_orig = None

    def _tx_journal_stop(self, commit_into=None) -> None:
        self._tx_journal_detach()
        if commit_into is not None:
            commit_into.ops.extend(self._tx_ops)
        self._tx_undo = []
        self._tx_ops = []

    def _tx_journal_abort(self) -> None:
        self._tx_journal_detach()
        store = self.store
        for kind, key, old in reversed(self._tx_undo):
            if kind == "put":
                if old is None:
                    store.delete(key)
                else:
                    store.put(key, old)
            else:                          # a delete: restore the row
                store.put(key, old)
        self._tx_undo = []
        self._tx_ops = []

    def _exec_chain(self, s: ast.Chain) -> QueryResult:
        chain = self.chain
        if s.action == "begin":
            if chain is None:
                self.init_chain()
                chain = self.chain
            self._chain_tx = chain.begin()
            self._tx_journal_start()
            return QueryResult.msg(
                f"chain transaction {self._chain_tx.tx_id} started")
        if chain is None:
            raise NeumannError("chain not initialized — "
                               "BEGIN CHAIN TRANSACTION first")
        if s.action == "commit":
            tx = self._chain_tx
            if tx is None:
                raise NeumannError("no open chain transaction")
            self._tx_journal_stop(commit_into=tx)
            h = chain.commit(tx)
            self._chain_tx = None
            return QueryResult.msg(f"committed block {h - 1} "
                                   f"(height {h})")
        if s.action == "abort":
            tx = self._chain_tx
            if tx is None:
                raise NeumannError("no open chain transaction")
            self._tx_journal_abort()
            chain.rollback(tx)
            self._chain_tx = None
            return QueryResult.msg(f"chain transaction {tx.tx_id} "
                                   f"aborted")
        if s.action == "rollback":
            n = chain.rollback_to(s.height or 0)
            return QueryResult.msg(f"chain rolled back {n} block(s)")
        if s.action == "height":
            return QueryResult.of_count(chain.height)
        if s.action == "tip":
            tip = chain.tip()
            return QueryResult.of_rows([tip.to_dict()] if tip else [])
        if s.action == "block":
            blk = chain.get_block(s.height)
            if blk is None:
                return QueryResult.msg(f"no block {s.height}")
            return QueryResult.of_rows([blk.to_dict()])
        if s.action == "verify":
            return QueryResult.msg(
                "chain OK" if chain.verify() else "chain CORRUPT")
        if s.action == "history":
            return QueryResult.of_rows(chain.history(s.key))
        if s.action == "similar":
            return QueryResult.of_rows(
                chain.similar_blocks(s.embedding, s.limit or 5))
        if s.action == "drift":
            return QueryResult.of_rows(
                [chain.drift(s.from_height, s.to_height)])
        if s.action == "stats":
            return QueryResult.of_rows([chain.metrics.snapshot()])
        if s.action == "show_codebook_global":
            return QueryResult.of_rows([chain.codebooks.info("global")])
        if s.action == "show_codebook_local":
            return QueryResult.of_rows(
                [chain.codebooks.info("local", s.key)])
        if s.action == "analyze_transitions":
            return QueryResult.of_rows(
                [chain.codebooks.analyze_transitions()])
        raise NeumannError(f"chain action {s.action} unsupported")

    def _exec_cluster(self, s: ast.Cluster) -> QueryResult:
        cluster = self.cluster
        if s.action == "connect":
            # become a gateway: subsequent statements forward to the
            # cluster node at this address (reference: shell CLUSTER
            # CONNECT routes queries through the cluster)
            from neumann_tpu_torch.chain.node import ClusterClient

            addr = (s.address or "").rpartition("@")[2]  # drop 'id@'
            host, _, port = addr.rpartition(":")
            if not host or not port.isdigit():
                raise NeumannError(
                    f"CLUSTER CONNECT expects '[id@]host:port', got "
                    f"{s.address!r}")
            try:
                self.cluster_client = ClusterClient((host, int(port)))
            except OSError as e:
                raise NeumannError(
                    f"cannot reach cluster node at {addr}: {e}") from e
            return QueryResult.msg(
                f"connected to cluster node at {s.address}; statements "
                "now execute on the cluster (CLUSTER DISCONNECT to "
                "detach)")
        if s.action == "disconnect":
            cc = self.cluster_client
            if cc is not None:
                cc.close()
                self.cluster_client = None
            was = cluster is not None or cc is not None
            self.cluster = None
            return QueryResult.msg("disconnected" if was
                                   else "not connected to a cluster")
        if cluster is None:
            return QueryResult.msg("not connected to a cluster")
        if s.action == "status":
            statuses = {
                nid: n.gossip.partition_status()
                for nid, n in cluster.nodes.items()
                if getattr(n, "gossip", None) is not None}
            row = {"leader": cluster.leader(),
                   "nodes": len(cluster.nodes)}
            if statuses:
                # membership.rs PartitionStatus: any node seeing quorum
                # makes the cluster writable
                vals = set(statuses.values())
                row["partition"] = (
                    "quorum_reachable" if "quorum_reachable" in vals
                    else "stalemate" if "stalemate" in vals
                    else "quorum_lost" if "quorum_lost" in vals
                    else "unknown")
            return QueryResult.of_rows([row])
        if s.action == "nodes":
            return QueryResult.of_rows([
                {"id": nid, "state": n.raft.state, "term": n.raft.term}
                for nid, n in cluster.nodes.items()])
        if s.action == "leader":
            return QueryResult.of_value(cluster.leader())
        raise NeumannError(f"cluster action {s.action} unsupported")

    def _exec_explain(self, s: ast.Explain) -> QueryResult:
        """EXPLAIN <statement>: the execution plan, without executing.

        For SELECT: access path (index vs full scan), join strategy,
        post-steps. For SIMILAR: the route the port's engine takes for
        the statement (``_similar_route``) and its kernel — corpus size,
        metric, quantization, selection, mask fusion. Other statements
        report their target engine.
        """
        inner = s.inner
        kind = type(inner).__name__
        rows: List[dict] = []

        def step(op: str, detail: str) -> None:
            rows.append({"step": len(rows) + 1, "operation": op,
                         "detail": detail})

        if isinstance(inner, ast.Select):
            tbl = self.relational._table(inner.table)  # validates
            access = "full scan (vectorized bitmap)"
            if inner.where is not None:
                def _cond_cols(c):
                    if c is None:
                        return []
                    out = [c.column] if c.column else []
                    return out + _cond_cols(c.left) + _cond_cols(c.right)

                for c in _cond_cols(inner.where):
                    if c in tbl.hash_indexes:
                        access = f"hash index on {c}"
                        break
                    if c in tbl.btree_indexes:
                        access = f"btree index on {c}"
                        break
            step("scan", f"table '{inner.table}' "
                 f"({self.relational.row_count(inner.table)} rows), "
                 f"{access}")
            for j in inner.joins or []:
                on = (f"using ({', '.join(j.using)})" if j.using
                      else f"on {j.left_col} = {j.right_col}")
                step("join", f"{j.how} join {j.table} {on} "
                     f"(hash build on smaller side)")
            if inner.group_by:
                step("aggregate", f"group by {', '.join(inner.group_by)}")
            if inner.order_by:
                step("sort", f"order by {inner.order_by}")
            if inner.limit is not None:
                step("limit", f"limit {inner.limit} "
                     f"offset {inner.offset or 0}")
        elif isinstance(inner, ast.Similar):
            if inner.collection:
                cfg = self.vector.collection_config(inner.collection)
                quant = cfg.quantization
                n = self.vector.collection_stats(
                    inner.collection)["count"]
                where = f"collection '{inner.collection}'"
            else:
                quant = "none"
                n = self.vector.count_embeddings()
                where = "default corpus"
            scan, select = _route_text(self._similar_route(inner),
                                       inner.connected_to is not None)
            step("scan", f"{scan} over {where} ({n} vectors, "
                 f"quantization={quant}, "
                 f"metric={inner.metric or 'cosine'})")
            masks = []
            if inner.where is not None:
                masks.append("metadata predicate")
            if inner.connected_to is not None:
                masks.append(f"CONNECTED TO '{inner.connected_to}' "
                             f"graph neighborhood")
            if masks:
                step("mask", " + ".join(masks)
                     + " fused into scan as -inf (exact for any k)")
            step("select", f"top-{inner.limit} ({select})")
        else:
            engine = {
                "Insert": "relational", "Update": "relational",
                "Delete": "relational", "NodeCreate": "graph",
                "EdgeCreate": "graph", "Neighbors": "graph",
                "Path": "graph", "EmbedStore": "vector",
                "Find": "unified", "Vault": "vault", "Cache": "cache",
                "Blob": "blob", "Checkpoint": "checkpoint",
            }.get(kind, "router")
            step("execute", f"{kind} via {engine} engine")
        return QueryResult.of_rows(rows)

    def _similar_route(self, s: ast.Similar) -> Optional[dict]:
        """``VectorEngine.search_route`` for the search ``_exec_similar``
        runs for ``s`` (None: CONNECTED TO, which the unified engine
        routes, or no rows to scan)."""
        if s.connected_to is not None:
            return None
        query = s.query_vector if s.query_vector is not None \
            else s.query_key
        try:
            dim = len(self._resolve_query(s, query))
        except VectorError:
            return None
        filt = (_filter_from_condition(s.where) if s.where is not None
                else None)
        if s.collection is not None:
            cfg = self.vector.collection_config(s.collection)
            return self.vector.search_route(
                f"col/{s.collection}", dim, s.limit, s.metric or cfg.metric,
                filt, cfg.quantization)
        return self.vector.search_route(
            "", dim, s.limit, s.metric or (None if filt else "cosine"),
            filt)


# EXPLAIN SIMILAR's scan and select text for each route of the engine
_ROUTE_SCAN = {
    "auto_ivf": "auto-IVF probe of the nearest int8 windows",
    "f32_pooled": "f32 pooled-bits scan, one winner a pool of {pool} rows",
    "int8_pooled": "int8 pooled-bits scan, one winner a pool of {pool} rows",
    "int8_scan": "int8 scores over every row",
    "binary": "hamming distances over sign bits",
    "pq": "PQ ADC scan over the codes",
    "tt": "tensor-train reconstruction, then the exact f32 scan",
    "exact": "exact f32 scan",
    "mesh": "a top-k on each shard of the mesh",
    "mesh_ivf": "cluster-sharded IVF probe on each shard of the mesh",
}
_ROUTE_SELECT = {
    "auto_ivf": "exact f32 rerank of the probed candidates",
    "f32_pooled": "best pools, then an exact f32 rerank of their rows",
    "int8_pooled": "best pools, then an exact f32 rerank of their rows",
    "int8_scan": "exact keyed merge, equal scores by row",
    "hamming_topk": "inside the kernel, equal distances by row",
    "hamming_scores": "keyed merge of the distances, equal ones by row",
    "pq_adc_select": "inside the kernel",
    "pq_adc": "stable top-k of the ADC scores",
    "tt": "exact top-k",
    "exact": "exact top-k",
    "mesh": "exact f32 rerank on each shard where int8, then the "
            "shards' top-k merged",
    "mesh_ivf": "exact f32 rerank on each shard, then the shards' top-k "
                "merged",
}


def _route_text(route: Optional[dict], connected: bool):
    """(scan, select) detail of EXPLAIN SIMILAR for a ``search_route``
    (``connected``: a CONNECTED TO search, routed by the unified
    engine)."""
    if connected:
        return ("unified engine: the neighbourhood as a row mask over the "
                "entity corpus, scanned by its own gate",
                "top-k of the masked scan")
    if route is None:
        return "no rows to scan", "empty result"
    scan = _ROUTE_SCAN[route["route"]].format(pool=route["pool"])
    kernel = route["kernel"]
    if kernel is not None:
        scan += f" (kernel {kernel})"
    select = _ROUTE_SELECT.get(kernel, _ROUTE_SELECT.get(route["route"]))
    return f"route {route['route']}: {scan}", select

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
* ``execute_many`` and cursor pagination (``execute_paginated``);
* serving: ``warmup`` and, once a caller enables it, batched serving
  (``server/batcher.QueryBatcher`` coalesces concurrent SIMILARs).

The handlers are the JAX router's, with the auto-checkpoint hook left
out (no checkpoint manager is ported, and the JAX router's hook does
nothing without one). VAULT, CACHE, BLOB(S), CHECKPOINT(S), ROLLBACK,
CHAIN, CLUSTER and EXPLAIN parse but raise ``NeumannError`` naming their
ROADMAP item, and so do the planner and the module attachments.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

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

# statements that parse but have no handler yet -> their ROADMAP item
_UNPORTED = {
    "Vault": "6, vault / blob / checkpoint / cache",
    "Cache": "6, vault / blob / checkpoint / cache",
    "Blob": "6, vault / blob / checkpoint / cache",
    "Blobs": "6, vault / blob / checkpoint / cache",
    "Checkpoint": "6, vault / blob / checkpoint / cache",
    "Checkpoints": "6, vault / blob / checkpoint / cache",
    "Rollback": "6, vault / blob / checkpoint / cache",
    "Explain": "6, vault / blob / checkpoint / cache, with EXPLAIN",
    "Chain": "11, chain",
    "Cluster": "11, chain",
}


def _not_ported(what: str, item: str):
    raise NeumannError(
        f"{what} is not ported to the PyTorch router yet (ROADMAP: {item})")


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
        self.relational = RelationalEngine(self.store)
        self.graph = GraphEngine(self.store, device=device)
        self.vector = VectorEngine(self.store, device=device)
        self.unified = UnifiedEngine(self.store, self.relational,
                                     self.graph, self.vector)
        self.cursor_store = CursorStore()
        self._lock = threading.RLock()
        self.metrics = QueryMetrics()
        # serving-side query coalescing (server/batcher.py): off for
        # embedded use (adds max_wait_ms to single-caller latency),
        # enabled by a server before it takes traffic
        self._batchers = None
        self._batcher_wait_ms = 2.0

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

    # -- not ported yet ------------------------------------------------------
    def attach_planner(self, *args, **kwargs):
        _not_ported("distributed planning", "12, mesh")

    def init_vault(self, *args, **kwargs):
        _not_ported("the vault", "6, vault / blob / checkpoint / cache")

    def init_cache(self, *args, **kwargs):
        _not_ported("the LLM cache", "6, vault / blob / checkpoint / cache")

    def init_blob(self, *args, **kwargs):
        _not_ported("blob storage", "6, vault / blob / checkpoint / cache")

    def init_checkpoints(self, *args, **kwargs):
        _not_ported("checkpoints", "6, vault / blob / checkpoint / cache")

    def init_chain(self, *args, **kwargs):
        _not_ported("the chain", "11, chain")

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
                out = self.execute_statement(stmt)
        except Exception:
            self.metrics.record(kind, (time.perf_counter() - t0) * 1e3,
                                error=True, query=query)
            raise
        self.metrics.record(kind, (time.perf_counter() - t0) * 1e3,
                            query=query)
        return out

    def _execute_cypher(self, query: str) -> QueryResult:
        rows = CypherExecutor(self.graph).execute(parse_cypher(query))
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

    def execute_statement(self, stmt: ast.Statement) -> QueryResult:
        name = type(stmt).__name__
        handler = getattr(self, f"_exec_{name.lower()}", None)
        if handler is None:
            _not_ported(f"statement {name}",
                        _UNPORTED.get(name, "router statements"))
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
        n = self.relational.update(s.table,
                                   self._resolve_subqueries(s.where),
                                   s.updates)
        return QueryResult("count", count=n, message=f"updated {n} row(s)")

    def _exec_delete(self, s: ast.Delete) -> QueryResult:
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

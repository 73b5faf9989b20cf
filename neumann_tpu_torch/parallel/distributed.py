"""Distributed query planning: Local / Remote / ScatterGather + merge.

Parity with query_router/src/distributed.rs (QueryPlan:20-31,
QueryPlanner::plan/plan_with_embedding:126-208, MergeStrategy,
ResultMerger::merge:342-351): decide where a statement runs, fan it out,
and merge shard results. Embedding-aware planning routes SIMILAR queries
to the semantically-nearest shards via the SemanticPartitioner's
archetype centroids (probing fewer shards when locality allows).

The executor is pluggable: in-process shard routers for tests (the
MemoryTransport pattern), cluster nodes over any transport in
deployment. On-mesh corpora bypass this entirely — ShardedCorpus merges
over ICI; this planner is for corpus shards living on *different hosts*.

The port's copy of ``neumann_tpu/parallel/distributed.py``: only its
import lines differ. Every shard here is a router: in the process, or a
server reached through ``NeumannClient``; a corpus on the mesh
(``parallel/sharded_search.py``) is merged inside the vector engine.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from neumann_tpu_torch.parallel.partitioner import SemanticPartitioner


@dataclass
class QueryPlan:
    kind: str                      # local | remote | scatter_gather
    shards: List[str] = field(default_factory=list)
    merge: str = "union"           # union | top_k | aggregate |
    #                                first_non_empty | concat
    k: int = 10


class QueryPlanner:
    """Maps statements to plans over named shards."""

    def __init__(self, local_shard: str, shards: Sequence[str],
                 semantic: Optional[SemanticPartitioner] = None):
        self.local = local_shard
        self.shards = list(shards)
        self.semantic = semantic

    def plan(self, query: str) -> QueryPlan:
        q = query.lstrip().upper()
        if q.startswith("SIMILAR"):
            k = self._extract_k(q)
            return QueryPlan("scatter_gather", list(self.shards),
                             merge="top_k", k=k)
        if q.startswith(("SELECT COUNT(", "SELECT SUM(")):
            # single-aggregate selects sum across shards
            return QueryPlan("scatter_gather", list(self.shards),
                             merge="aggregate")
        if q.startswith(("SELECT", "FIND", "MATCH", "NODE LIST",
                         "EDGE LIST", "SHOW")):
            return QueryPlan("scatter_gather", list(self.shards),
                            merge="concat")
        if q.startswith(("COUNT", "GRAPH AGGREGATE")):
            return QueryPlan("scatter_gather", list(self.shards),
                            merge="aggregate")
        if q.startswith(("EMBED GET", "ENTITY GET", "NODE GET",
                         "EDGE GET", "VAULT GET", "CACHE GET")):
            return QueryPlan("scatter_gather", list(self.shards),
                            merge="first_non_empty")
        # writes default to local (the caller replicates via Raft)
        return QueryPlan("local", [self.local])

    def plan_with_embedding(self, query: str, embedding: np.ndarray,
                            nprobe: Optional[int] = None) -> QueryPlan:
        """Semantic routing: probe only the nearest shards."""
        base = self.plan(query)
        if base.kind != "scatter_gather" or self.semantic is None:
            return base
        idx = self.semantic.query_shards(
            embedding, nprobe or len(self.shards))
        base.shards = [self.shards[i] for i in idx
                       if i < len(self.shards)]
        return base

    @staticmethod
    def _extract_k(q: str) -> int:
        for marker in (" TOP ", " LIMIT "):
            if marker in q:
                tail = q.split(marker, 1)[1].strip().split()
                if tail and tail[0].isdigit():
                    return int(tail[0])
        return 10


class ResultMerger:
    """Merge shard QueryResults per strategy."""

    @staticmethod
    def merge(plan: QueryPlan, results: List):
        from neumann_tpu_torch.router import QueryResult

        results = [r for r in results if r is not None]
        if not results:
            return QueryResult.msg("no shard results")
        if plan.merge == "first_non_empty":
            for r in results:
                if r.rows or r.results or r.value is not None:
                    return r
            return results[0]
        if plan.merge == "top_k":
            hits = [h for r in results for h in r.results]
            hits.sort(key=lambda h: -h["score"])
            return QueryResult("similar", results=hits[: plan.k])
        if plan.merge == "aggregate":
            total = 0
            for r in results:
                if r.rows and len(r.rows) == 1 and len(r.rows[0]) == 1:
                    # SELECT COUNT(*)/SUM(col): one single-value row
                    total += next(iter(r.rows[0].values())) or 0
                else:
                    total += r.count or 0
            return QueryResult.of_count(total)
        if plan.merge in ("concat", "union"):
            rows = [row for r in results for row in r.rows]
            if plan.merge == "union":
                seen = set()
                uniq = []
                for row in rows:
                    key = tuple(sorted(
                        (k, repr(v)) for k, v in row.items()))
                    if key not in seen:
                        seen.add(key)
                        uniq.append(row)
                rows = uniq
            return QueryResult.of_rows(rows)
        raise ValueError(f"unknown merge strategy {plan.merge}")


class DistributedExecutor:
    """Fan a plan out to shard executors and merge.

    `executors` maps shard name -> callable(query) -> QueryResult.
    In-process routers in tests; RPC stubs in deployment.
    """

    def __init__(self, planner: QueryPlanner,
                 executors: Dict[str, Callable]):
        self.planner = planner
        self.executors = executors

    def execute(self, query: str,
                embedding: Optional[np.ndarray] = None,
                nprobe: Optional[int] = None, plan=None):
        """``plan``: pass a plan already computed (e.g. by the router's
        local/remote classification) to skip re-planning — SIMILAR
        planning includes the semantic-partitioner nearest-shard
        matmul, which is worth not paying twice per query."""
        if plan is None:
            plan = (self.planner.plan_with_embedding(query, embedding,
                                                     nprobe)
                    if embedding is not None
                    else self.planner.plan(query))
        results = []
        for shard in plan.shards:
            ex = self.executors.get(shard)
            if ex is None:
                continue
            try:
                results.append(ex(query))
            except Exception:  # shard failure: degrade, don't die
                results.append(None)
        if plan.kind == "local":
            return results[0] if results else None
        return ResultMerger.merge(plan, results)

"""Scatter-gather SIMILAR on the port: ``QueryRouter.attach_planner`` and
``neumann_tpu_torch/parallel/distributed.py`` against the JAX package's,
on the CPU.

tests/test_distributed_search.py runs on both packages
(tests/torch_twins.py): three gRPC shard servers in the process, the
executor and the router's planner over ``NeumannClient`` connections,
shard failures, semantic routing. Its two ``ShardedIVFCorpus`` tests
are twinned with the mesh's, in tests/test_torch_mesh.py.
tests/test_multihost_search.py runs on both packages too: two shard
server processes, one SIGKILLed. Its worker script asks JAX for its
backend; the port's twin asks the router for its device instead, and
starts its server on the CPU (``port_patch``).

Then three in-process shard routers for each package, with the same
rows, behind a coordinator's ``attach_planner``: SIMILAR (top-k merge;
keys equal, scores within 1e-5), COUNT EMBEDDINGS and SELECT COUNT(*)
(aggregate), SELECT (concat), EMBED GET (first non-empty), semantic
routing at nprobe 1 and 2, a failed shard, local writes and
``detach_planner`` give equal results, and the merge is exactly the
merge of the shards' own answers.
"""

import numpy as np
import pytest

from neumann_tpu.parallel.distributed import QueryPlanner as JPlanner
from neumann_tpu.parallel.partitioner import SemanticPartitioner as JSem
from neumann_tpu.router import QueryRouter as JRouter
from neumann_tpu_torch.parallel.distributed import (
    QueryPlan,
    QueryPlanner,
    ResultMerger,
)
from neumann_tpu_torch.parallel.partitioner import SemanticPartitioner
from neumann_tpu_torch.router import QueryResult
from neumann_tpu_torch.router import QueryRouter as TRouter
from tests.test_torch_relational import run_both, same
from tests.torch_twins import twin_tests

globals().update(twin_tests("test_distributed_search", (
    "test_scatter_gather_similar", "test_scatter_gather_aggregate_and_concat",
    "test_shard_failure_degrades",
    "test_router_execute_scatter_gather_similar",
    "test_router_execute_aggregate_concat_and_local_writes",
    "test_router_execute_shard_failure_degrades",
    "test_router_semantic_probe_routing", "test_cluster_read_mode_local")))

_WORKER_READY = ('import jax\nprint(f"READY {srv.port} '
                 '{jax.default_backend()}", flush=True)')
globals().update(twin_tests("test_multihost_search", port_patch={
    "srv = _cpu(NeumannServer)(router=router, port=0)":
        'srv = NeumannServer(router=router, port=0, device="cpu")',
    _WORKER_READY:
        'print(f"READY {srv.port} {router.vector.device.type}", flush=True)',
}))


N, D, SHARDS = 240, 24, ("s0", "s1", "s2")


def _rows():
    rng = np.random.default_rng(16)
    cents = rng.standard_normal((3, D)).astype(np.float32) * 4
    v = (cents[np.arange(N) % 3]
         + rng.standard_normal((N, D))).astype(np.float32)
    return cents, v


def _vec(v):
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


def _shards(router_cls):
    """Three shard routers: row i on shard i % 3 (centre i % 3), a table
    t with one row a shard; ``sN_only`` on shard N alone."""
    _, v = _rows()
    shards = {}
    for s, name in enumerate(SHARDS):
        r = router_cls()
        for i in range(s, N, 3):
            r.vector.store_embedding(f"v{i}", v[i])
        r.vector.store_embedding(f"{name}_only", v[s])
        r.execute("CREATE TABLE t (shard TEXT, n INT)")
        r.execute(f"INSERT INTO t VALUES ('{name}', {s + 1})")
        shards[name] = r
    return shards


@pytest.fixture
def planned():
    """A JAX and a port coordinator, each with ``attach_planner`` over its
    own package's three shard routers."""
    shards = {"jax": _shards(JRouter),
              "port": _shards(lambda: TRouter(device="cpu"))}
    coords = {"jax": JRouter(), "port": TRouter(device="cpu")}
    planners = {"jax": JPlanner, "port": QueryPlanner}
    for pkg, coord in coords.items():
        coord.attach_planner(planners[pkg]("coord", list(SHARDS)),
                             {n: r.execute for n, r in shards[pkg].items()})
    return coords, shards


def test_planned_statements_answer_alike(planned):
    coords, _ = planned
    _, v = _rows()
    q = v[7] + 0.05
    for stmt in (f"SIMILAR {_vec(q)} TOP 5", f"SIMILAR {_vec(q)} LIMIT 12",
                 "SIMILAR 'v10' TOP 4"):
        run_both(coords["jax"], coords["port"], stmt, rtol=1e-5,
                 fields=("kind", "message", "count"))
        got = coords["port"].execute(stmt).results
        want = coords["jax"].execute(stmt).results
        assert [h["key"] for h in got] == [h["key"] for h in want], stmt
        same([h["score"] for h in want], [h["score"] for h in got],
             atol=1e-5)
    for stmt in ("COUNT EMBEDDINGS", "SELECT COUNT(*) FROM t",
                 "SELECT SUM(n) FROM t", "SELECT * FROM t",
                 "EMBED GET 's2_only'", "EMBED GET 'nowhere'",
                 "SHOW TABLES"):
        run_both(coords["jax"], coords["port"], stmt, rtol=1e-6)
    assert coords["port"].execute("COUNT EMBEDDINGS").count == N + 3
    assert coords["port"].execute("SELECT SUM(n) FROM t").count == 6


def test_merge_is_the_shards_own_merge(planned):
    """The port's top-k merge over its shards equals its shards' answers
    to the same statement, asked directly, merged by score with ties in
    shard order; SIMILAR scatters even on the coordinator's own key."""
    coords, shards = planned
    _, v = _rows()
    for i in (0, 5, 77):
        stmt = f"SIMILAR {_vec(v[i] + 0.01)} TOP 6"
        own = [h for n in SHARDS for h in shards["port"][n].execute(
            stmt).results]
        own.sort(key=lambda h: -h["score"])
        got = coords["port"].execute(stmt).results
        assert got == own[:6]
        merged = ResultMerger.merge(QueryPlan("scatter_gather", list(SHARDS),
                                              merge="top_k", k=6),
                                    [shards["port"][n].execute(stmt)
                                     for n in SHARDS])
        assert merged.results == got


def test_semantic_routing_alike():
    """A semantic planner probes the nearest shards by the partitioner's
    centroids: equal hits at nprobe 1 and 2, and only the probed shards
    are asked."""
    cents, v = _rows()
    coords = {"jax": JRouter(), "port": TRouter(device="cpu")}
    sems = {"jax": JSem(3), "port": SemanticPartitioner(3, device="cpu")}
    planners = {"jax": JPlanner, "port": QueryPlanner}
    asked = {pkg: [] for pkg in coords}
    for pkg, coord in coords.items():
        sems[pkg].centroids = cents
        shards = _shards(JRouter if pkg == "jax"
                         else lambda: TRouter(device="cpu"))

        def counted(name, r, pkg=pkg):
            def run(q):
                asked[pkg].append(name)
                return r.execute(q)
            return run

        coord.attach_planner(
            planners[pkg]("coord", list(SHARDS), semantic=sems[pkg]),
            {n: counted(n, r) for n, r in shards.items()}, nprobe=1)
    q = v[4] + 0.02                       # centre 1: shard s1
    stmt = f"SIMILAR {_vec(q)} TOP 5"
    got, want = (coords[p].execute(stmt).results for p in ("port", "jax"))
    assert [h["key"] for h in got] == [h["key"] for h in want]
    assert asked["port"] == asked["jax"] == ["s1"]
    assert all(int(h["key"][1:]) % 3 == 1 for h in got if
               h["key"].startswith("v"))
    for pkg, coord in coords.items():
        coord._dist_nprobe = 2
        asked[pkg].clear()
    got, want = (coords[p].execute(stmt).results for p in ("port", "jax"))
    assert [h["key"] for h in got] == [h["key"] for h in want]
    assert asked["port"] == asked["jax"] and len(asked["port"]) == 2


def test_failed_shard_and_local_writes_alike(planned):
    coords, shards = planned
    _, v = _rows()

    def down(_q):
        raise ConnectionError("shard down")

    for pkg, coord in coords.items():
        coord._dist.executors["s2"] = down
    stmt = f"SIMILAR {_vec(v[2])} TOP 5"
    got, want = (coords[p].execute(stmt).results for p in ("port", "jax"))
    assert [h["key"] for h in got] == [h["key"] for h in want]
    assert all(int(h["key"][1:]) % 3 != 2 for h in got
               if h["key"].startswith("v"))
    run_both(coords["jax"], coords["port"], "COUNT EMBEDDINGS")
    assert coords["port"].execute("COUNT EMBEDDINGS").count == 2 * N // 3 + 2
    # writes plan local: they land on the coordinator, not the shards
    for stmt in ("CREATE TABLE w (x INT)", "INSERT INTO w VALUES (1)",
                 f"EMBED STORE 'local' {_vec(v[0])}"):
        run_both(coords["jax"], coords["port"], stmt)
    assert "w" not in shards["port"]["s0"].relational.list_tables()
    assert "w" in coords["port"].relational.list_tables()
    for pkg, coord in coords.items():
        coord.detach_planner()
    for stmt in ("COUNT EMBEDDINGS", "SELECT * FROM w", "SHOW TABLES"):
        run_both(coords["jax"], coords["port"], stmt)
    assert coords["port"].execute("COUNT EMBEDDINGS").count == 1


def test_planner_errors_record_metrics(planned):
    """A shard planner whose executor raises outside the executor's
    guard (a merge of a bad result) fails the statement, recorded as an
    error under its kind, in both routers."""
    coords, _ = planned

    class Bad:
        rows, results, value, count = None, None, None, None

    for pkg, coord in coords.items():
        for name in SHARDS:
            coord._dist.executors[name] = lambda q: Bad()
    run_both(coords["jax"], coords["port"], "SIMILAR 'v1' TOP 3")
    snap = coords["port"].metrics.snapshot()
    assert snap["Similar"]["errors"] == 1
    assert coords["jax"].metrics.snapshot()["Similar"]["errors"] == 1


def test_plans_alike():
    """The port's planner plans every statement class as the JAX one."""
    j = JPlanner("l", ["a", "b"])
    t = QueryPlanner("l", ["a", "b"])
    for stmt in ("SIMILAR [1, 2] TOP 7", "similar 'k' limit 3",
                 "SIMILAR 'k'", "SELECT COUNT(*) FROM t", "SELECT a FROM t",
                 "FIND NODE", "MATCH (a) RETURN a", "NODE LIST", "SHOW TABLES",
                 "COUNT EMBEDDINGS", "GRAPH AGGREGATE COUNT NODES",
                 "EMBED GET 'x'", "ENTITY GET 'x'", "VAULT GET 'x'",
                 "CACHE GET 'x'", "INSERT INTO t VALUES (1)",
                 "EMBED STORE 'k' [1]", "  select sum(x) from t"):
        pj, pt = j.plan(stmt), t.plan(stmt)
        assert (pt.kind, pt.shards, pt.merge, pt.k) == \
            (pj.kind, pj.shards, pj.merge, pj.k), stmt
    with pytest.raises(ValueError, match="unknown merge"):
        ResultMerger.merge(QueryPlan("scatter_gather", merge="zip"),
                           [QueryResult.msg("x")])
    assert ResultMerger.merge(QueryPlan("scatter_gather"),
                              [None]).message == "no shard results"

"""The port's unified engine and hybrid statements
(neumann_tpu_torch/engines/unified.py and the router's ``SIMILAR …
CONNECTED TO``, ``NEIGHBORS … BY SIMILARITY``, ``FIND`` and ENTITY
statements) against the JAX package's, on the CPU.

8,192 entities of 64-d clustered embeddings with ``{"tier": i % 16}``,
four random out-edges each and two kinds of hub: sparse hubs (40
out-neighbours: the graph mask fills a few pools, so both packages take
the exact flat scan) and one dense hub (an edge to every fourth entity:
every pool holds neighbours, so the f32 pooled-bits route runs). With
NEUMANN_POOLED_MIN_ROWS=1024 and NEUMANN_POOLED_MIN_POOLS=64 (monkeypatch,
read at search time by both packages) the corpus has 512 pools of 16
rows, as 262,144 rows have 2,048 pools of 128 by default; ``WHERE tier =
3`` leaves one row in every pool, so FIND takes the pooled route too.
Which route ran is checked by a spy on the port's pooled rerank.

Tolerances: scores within 1e-5 of the JAX package's and of a float64
numpy scan over the masked rows; keys equal wherever the scores are
more than 2e-5 from their neighbours' (the test says which near-ties it
lets swap).

Also the carry-over of state: a WAL and a snapshot written by the JAX
router load into a port router (``convert.router_from_files``), which
then answers SELECT, NEIGHBORS, PATH, FIND and ``SIMILAR … CONNECTED
TO`` as the JAX router that wrote them does.
"""

import numpy as np
import pytest

from neumann_tpu.router import QueryRouter as JRouter
from neumann_tpu.store.tensor_store import TensorStore as JStore
from neumann_tpu_torch.convert import router_from_files
from neumann_tpu_torch.engines import vector as tvec
from tests.test_torch_relational import routers, run_both, same

N, D, TIERS = 8192, 64, 16
SPARSE_HUBS = (3, 4100, 8000)
DENSE_HUB = 17
TOL = 1e-5


def _vec(v):
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(5)
    cents = rng.standard_normal((48, D)).astype(np.float32) * 2
    v = (cents[rng.integers(0, 48, N)]
         + 0.5 * rng.standard_normal((N, D))).astype(np.float32)
    qs = (v[rng.choice(N, 6)]
          + 0.05 * rng.standard_normal((6, D))).astype(np.float32)
    src = np.repeat(np.arange(N), 4)
    dst = rng.integers(0, N, src.size)
    hub_src = [np.full(40, h) for h in SPARSE_HUBS]
    hub_dst = [rng.choice(N, 40, replace=False) for _ in SPARSE_HUBS]
    src = np.concatenate([src, *hub_src, np.full(N // 4, DENSE_HUB)])
    dst = np.concatenate([dst, *hub_dst, np.arange(0, N, 4)])
    jr, tr = routers()
    for r in (jr, tr):
        with r.vector.bulk_ingest():
            for i in range(N):
                r.unified.create_entity(f"e{i}", {"tier": i % TIERS}, v[i])
        r.graph.batch_create_edges(
            [(int(a), int(b), "rel") for a, b in zip(src, dst)])
    return jr, tr, v, qs, src, dst


@pytest.fixture
def pooled_env(monkeypatch):
    monkeypatch.setenv("NEUMANN_POOLED_MIN_ROWS", "1024")
    monkeypatch.setenv("NEUMANN_POOLED_MIN_POOLS", "64")


@pytest.fixture
def pooled_calls(monkeypatch):
    calls = []
    orig = tvec.f32_pooled_rerank_topk

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(tvec, "f32_pooled_rerank_topk", spy)
    return calls


def _neighbours(src, dst, node):
    return set(dst[src == node].tolist()) | set(src[dst == node].tolist())


def _exact(v, q, rows, k):
    """float64 cosine over the masked rows: [(key, score)] best first."""
    rows = np.array(sorted(rows))
    vv = v[rows].astype(np.float64)
    s = vv @ q.astype(np.float64) / (np.linalg.norm(vv, axis=1)
                                     * np.linalg.norm(q))
    order = np.lexsort((rows, -s))[:k]
    return [(f"e{rows[j]}", float(s[j])) for j in order]


def _assert_hits(got, want):
    """Scores within TOL; keys equal except among near-ties (scores
    within 2 TOL of another hit's)."""
    assert len(got) == len(want)
    gs = np.array([g[1] for g in got])
    ws = np.array([w[1] for w in want])
    np.testing.assert_allclose(gs, ws, rtol=0, atol=TOL)
    for j in range(len(want)):
        if (np.abs(ws - ws[j]) <= 2 * TOL).sum() == 1:
            assert got[j][0] == want[j][0], j


def _pairs(result):
    if result.kind == "similar":
        return [(h["key"], h["score"]) for h in result.results]
    return [(r["key"], r["score"]) for r in result.rows]


@pytest.mark.parametrize("hub", [*SPARSE_HUBS, DENSE_HUB])
def test_similar_connected_to(world, pooled_env, pooled_calls, hub):
    jr, tr, v, qs, src, dst = world
    for q in qs[:3]:
        stmt = f"SIMILAR {_vec(q)} TOP 10 CONNECTED TO 'e{hub}'"
        want, got = jr.execute(stmt), tr.execute(stmt)
        _assert_hits(_pairs(got), _pairs(want))
        _assert_hits(_pairs(got), _exact(v, q, _neighbours(src, dst, hub),
                                         10))
    assert len(pooled_calls) == (3 if hub == DENSE_HUB else 0)


@pytest.mark.parametrize("hub", [*SPARSE_HUBS, DENSE_HUB])
def test_neighbors_by_similarity(world, pooled_env, hub):
    jr, tr, v, qs, src, dst = world
    nbrs = _neighbours(src, dst, hub) - {hub}
    stmt = f"NEIGHBORS {hub} BOTH BY SIMILARITY LIMIT 10"
    got = tr.execute(stmt)
    _assert_hits(_pairs(got), _pairs(jr.execute(stmt)))
    _assert_hits(_pairs(got), _exact(v, v[hub], nbrs, 10))
    stmt = f"NEIGHBORS {hub} OUT BY SIMILARITY {_vec(qs[0])} LIMIT 7"
    got = tr.execute(stmt)
    _assert_hits(_pairs(got), _pairs(jr.execute(stmt)))
    _assert_hits(_pairs(got),
                 _exact(v, qs[0], set(dst[src == hub].tolist()), 7))


@pytest.mark.parametrize("connected", [None, SPARSE_HUBS[0], DENSE_HUB])
def test_find_where_similar_connected(world, pooled_env, pooled_calls,
                                      connected):
    jr, tr, v, qs, src, dst = world
    rows = set(range(3, N, TIERS))
    tail = ""
    if connected is not None:
        rows &= _neighbours(src, dst, connected)
        tail = f" CONNECTED TO 'e{connected}'"
    for q in qs[3:]:
        stmt = (f"FIND NODE entity WHERE tier = 3 SIMILAR TO {_vec(q)}"
                f"{tail} LIMIT 10")
        want, got = jr.execute(stmt), tr.execute(stmt)
        assert all(r["tier"] == 3 for r in got.rows)
        _assert_hits(_pairs(got), _pairs(want))
        _assert_hits(_pairs(got), _exact(v, q, rows, 10))
    # the tier filter alone leaves a row in every pool: pooled route;
    # with a connection constraint too few pools stay
    assert len(pooled_calls) == (3 if connected is None else 0)


def test_entity_statements():
    jr, tr = routers()
    rng = np.random.default_rng(2)
    for stmt in [f"ENTITY CREATE 'e{i}' {{ tier: {i % 4} }} EMBEDDING "
                 f"{_vec(rng.standard_normal(8))}" for i in range(12)] + [
            f"ENTITY CONNECT 'e{i}' -> 'e{(3 * i + 1) % 12}' : rel"
            for i in range(12)] + [
            "ENTITY GET 'e5'", "ENTITY GET 'ghost'",
            "FIND NODE entity WHERE tier = 3 LIMIT 4",
            "FIND ENTITY WHERE tier > 1 LIMIT 3",
            "ENTITY CREATE 'new1' { tier: 99 } EMBEDDING " + _vec(np.ones(8)),
            "ENTITY CONNECT 'new1' -> 'e5' : rel",
            "ENTITY CONNECT 'new1' -> 'ghost' : rel",
            "ENTITY UPDATE 'new1' { tier: 98 }",
            "ENTITY UPDATE 'ghost' { }",
            "ENTITY BATCH CREATE [{ key: 'k1', a: 1 }, { key: 'k2', a: 2 }]",
            "ENTITY BATCH CREATE [{ a: 1 }]",
            "ENTITY GET 'new1'", "ENTITY GET 'k2'",
            "ENTITY DELETE 'new1'", "ENTITY DELETE 'new1'",
            "SIMILAR 'e5' TOP 3 CONNECTED TO 'ghost'"]:
        run_both(jr, tr, stmt)
    for stmt in ("SIMILAR 'e1' TOP 3 CONNECTED TO 'e1'",
                 "SIMILAR 'e4' TOP 5 CONNECTED TO 'e1'",
                 "NEIGHBORS 4 BOTH BY SIMILARITY LIMIT 2",
                 "FIND NODE entity WHERE tier = 3 SIMILAR TO 'e0' "
                 "CONNECTED TO 'e2' LIMIT 5"):
        want, got = jr.execute(stmt), tr.execute(stmt)
        assert _pairs(want), stmt
        _assert_hits(_pairs(got), _pairs(want))


def test_state_carries_over_from_the_jax_router(tmp_path):
    """A JAX router writes a snapshot, then more through its WAL; the
    port loads both and answers as the writer does."""
    rng = np.random.default_rng(9)
    vecs = rng.standard_normal((40, 8)).astype(np.float32)
    store = JStore()
    jr = JRouter(store)
    store.open_durable(tmp_path / "j.wal", sync_mode="immediate")
    jr.execute("CREATE TABLE t (id INT PRIMARY KEY, name TEXT, v INT)")
    jr.execute("INSERT INTO t VALUES (1, 'a', 10), (2, 'b', 20), "
               "(3, 'c', 30)")
    for i in range(20):
        jr.execute(f"ENTITY CREATE 'n{i}' {{ tier: {i % 3} }} EMBEDDING "
                   f"{_vec(vecs[i])}")
    for i in range(19):
        jr.execute(f"ENTITY CONNECT 'n{i}' -> 'n{(i * 7 + 3) % 20}' : rel")
    store.checkpoint(tmp_path / "j.snap")
    jr.execute("INSERT INTO t VALUES (4, 'd', 40)")
    jr.execute("UPDATE t SET v = 25 WHERE id = 2")
    for i in range(20, 40):
        jr.execute(f"ENTITY CREATE 'n{i}' {{ tier: {i % 3} }} EMBEDDING "
                   f"{_vec(vecs[i])}")
        jr.execute(f"ENTITY CONNECT 'n{i}' -> 'n{i - 20}' : rel")
    jr.execute("ENTITY DELETE 'n7'")
    store.wal_flush()
    tr = router_from_files(tmp_path / "j.wal", tmp_path / "j.snap",
                           device="cpu")
    for stmt in ("SELECT * FROM t ORDER BY id",
                 "SELECT name FROM t WHERE v > 15",
                 "NEIGHBORS 3 BOTH", "NEIGHBORS 25 OUT",
                 "PATH SHORTEST 20 TO 3",
                 "FIND NODE entity WHERE tier = 1 LIMIT 50",
                 "SIMILAR 'n3' TOP 5 CONNECTED TO 'n3'",
                 f"SIMILAR {_vec(vecs[30])} TOP 4 CONNECTED TO 'n10'",
                 f"FIND NODE entity WHERE tier = 2 SIMILAR TO "
                 f"{_vec(vecs[5])} LIMIT 5",
                 "ENTITY GET 'n7'", "ENTITY GET 'n21'"):
        want, got = jr.execute(stmt), tr.execute(stmt)
        if want.kind == "similar" or (want.rows and "score" in want.rows[0]):
            _assert_hits(_pairs(got), _pairs(want))
            assert _pairs(want), stmt
        else:
            for f in ("kind", "rows", "count", "message", "value"):
                same(getattr(want, f), getattr(got, f), path=f"{stmt}.{f}")


def test_recover_applies_logged_deletes_to_the_engines(tmp_path):
    """A node deleted through the WAL after the snapshot stays deleted
    in the recovered port router, as in the router that wrote it (the
    JAX package's ``recover`` keeps it: its store runs no delete hook
    for a replayed delete)."""
    store = JStore()
    jr = JRouter(store)
    store.open_durable(tmp_path / "w.wal", sync_mode="immediate")
    jr.execute("NODE CREATE n { i: 0 }")
    jr.execute("NODE CREATE n { i: 1 }")
    store.checkpoint(tmp_path / "w.snap")
    jr.execute("NODE DELETE 0")
    store.wal_flush()
    tr = router_from_files(tmp_path / "w.wal", tmp_path / "w.snap",
                           device="cpu")
    assert tr.execute("NODE LIST").rows == jr.execute("NODE LIST").rows \
        == [{"id": 1, "label": "n", "i": 1}]

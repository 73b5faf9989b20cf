"""The port's checkpoints (neumann_tpu_torch/checkpoint/, a copy of the
JAX package's manager) and the routers' CHECKPOINT, CHECKPOINTS and
ROLLBACK statements and automatic checkpoints, against the JAX
package's, on the CPU.

The checkpoint cases of tests/test_extended_modules.py (create, list,
rollback, retention, persistence, no automatic checkpoint for a
non-destructive operation) run on both packages as one test each
(tests/torch_twins.py). Through a JAX and a port router (``run_both``):
each destructive statement takes one automatic checkpoint first, and no
read takes one; CHECKPOINTS lists the same rows; ROLLBACK restores
tables, graph and embeddings.

Then a rollback under every SIMILAR route: 4,096 x 64 clustered rows in
the default namespace (the f32 pooled route, with the pooled gate
lowered through monkeypatch as in tests/test_torch_collections.py) and
in int8, binary, pq and tt collections. After re-embedding and deleting
rows, ROLLBACK gives the port the hits it gave before the checkpoint,
keys and scores equal, and the JAX router's within the tolerance of
tests/test_torch_pq.py (keys may trade places only at scores within
1e-5). On rows that tie, the JAX router's restored corpus breaks ties
in another order than before the checkpoint (its row ids come back
from the free list in reverse); the port's emptied corpus hands out
rows from 0 again, so a corpus whose rows were in put order breaks ties
as before (ROADMAP §3), which the tie-heavy binary case holds. Where a
delete freed rows that later keys took before the checkpoint, the
snapshot does not keep the rows, and only the scores and the hits off
the last tied score are held.

A JAX manager's checkpoint directory is rolled back by a port manager
(``index.json`` and the snapshots are the same bytes in both).
"""

import shutil

import numpy as np
import pytest

from neumann_tpu.checkpoint import CheckpointManager as JManager
from neumann_tpu.store.tensor_store import TensorData as JData
from neumann_tpu.store.tensor_store import TensorStore as JStore
from neumann_tpu.store.tensor_store import TensorValue as JValue
from neumann_tpu_torch.checkpoint import CheckpointManager as TManager
from neumann_tpu_torch.router import QueryRouter as TRouter
from neumann_tpu_torch.store.tensor_store import (
    TensorData,
    TensorStore,
    TensorValue,
)
from tests.test_torch_pq import _data, _hits, _lit, _same
from tests.test_torch_relational import routers, run_both
from tests.torch_twins import twin_tests

globals().update(twin_tests("test_extended_modules", (
    "test_checkpoint_create_list_rollback", "test_checkpoint_retention",
    "test_checkpoint_persistence",
    "test_auto_checkpoint_ignores_nondestructive")))

SETUP = [
    "CREATE TABLE t (id INT PRIMARY KEY, v INT)",
    "INSERT INTO t VALUES (1, 10), (2, 20), (3, 30), (4, 40)",
    "CREATE TABLE gone (a INT)",
    "NODE CREATE person { name: 'a' }", "NODE CREATE person { name: 'b' }",
    "NODE CREATE person { name: 'c' }", "NODE CREATE person { name: 'd' }",
    "EDGE CREATE 0 -> 1 : knows", "EDGE CREATE 1 -> 2 : knows",
    "ENTITY CREATE 'e1' { tier: 1 } EMBEDDING [1.0, 0.0, 0.0]",
    "ENTITY CREATE 'e2' { tier: 2 } EMBEDDING [0.0, 1.0, 0.0]",
    "CREATE COLLECTION c DIM 3",
    "EMBED STORE 'x' [1.0, 2.0, 3.0] IN c",
    "EMBED STORE 'k1' [1.0, 0.0, 0.0]", "EMBED STORE 'k2' [0.0, 1.0, 0.0]",
]
READS = [
    "SELECT * FROM t WHERE v > 15", "SHOW TABLES", "NEIGHBORS 0 OUTGOING",
    "SIMILAR [1.0, 0.1, 0.0] TOP 2", "ENTITY GET 'e1'", "COUNT EMBEDDINGS",
    "SHOW COLLECTIONS", "MATCH (a)-[:knows]->(b) RETURN COUNT(*) AS n",
    "CHECKPOINTS", "EXPLAIN DELETE FROM t WHERE id = 1",
]
# each destructive site of the router, and the reason it records
DESTRUCTIVE = [
    ("DROP TABLE gone", "drop_table gone"),
    ("UPDATE t SET v = 11 WHERE id = 1", "update t"),
    ("DELETE FROM t WHERE id = 2", "delete t"),
    ("NODE DELETE 3", "delete node 3"),
    ("GRAPH BATCH DELETE NODES [2]", "delete graph batch"),
    ("DROP COLLECTION c", "drop_collection c"),
    ("ENTITY DELETE 'e2'", "delete entity e2"),
    ("CREATE (n:person {name: 'z'})", "update cypher"),
    ("MERGE (n:person {name: 'a'})", "update cypher"),
    ("MATCH (n:person {name: 'z'}) DELETE n", "update cypher"),
]


def _ckpt_routers(tmp_path):
    jr, tr = routers()
    for r, name in ((jr, "jax"), (tr, "port")):
        r.init_checkpoints(str(tmp_path / name))
    return jr, tr


def test_statements_need_a_manager():
    jr, tr = routers()
    for stmt in ("CHECKPOINT", "CHECKPOINTS", "ROLLBACK TO 'x'"):
        run_both(jr, tr, stmt, rtol=1e-6)


def test_checkpoint_statements_match_jax(tmp_path):
    jr, tr = _ckpt_routers(tmp_path)
    for stmt in SETUP + ["CHECKPOINT 'base'", "CHECKPOINT", "CHECKPOINTS",
                         "CHECKPOINTS LIMIT 1", "ROLLBACK TO 'nope'",
                         "ROLLBACK TO 'ckpt-2'", "CHECKPOINTS"]:
        run_both(jr, tr, stmt, rtol=1e-6)


def test_reads_take_no_automatic_checkpoint(tmp_path):
    jr, tr = _ckpt_routers(tmp_path)
    for stmt in SETUP + READS:
        run_both(jr, tr, stmt, rtol=1e-6)
    assert tr.checkpoints.list() == [] and jr.checkpoints.list() == []


@pytest.mark.parametrize("stmt,reason", DESTRUCTIVE)
def test_each_destructive_statement_checkpoints_first(tmp_path, stmt,
                                                     reason):
    """One automatic checkpoint, taken before the statement ran: rolling
    back to it undoes the statement on both routers."""
    jr, tr = _ckpt_routers(tmp_path)
    for s in SETUP:
        run_both(jr, tr, s, rtol=1e-6)
    before = [r.store.snapshot_bytes(compressed=False) for r in (jr, tr)]
    run_both(jr, tr, stmt, rtol=1e-6)
    for r in (jr, tr):
        (auto,) = r.checkpoints.list()
        assert auto["auto"] and auto["reason"] == reason
    run_both(jr, tr, "CHECKPOINTS")
    run_both(jr, tr, "ROLLBACK TO 'ckpt-1'")
    after = [r.store.snapshot_bytes(compressed=False) for r in (jr, tr)]
    assert after == before
    for s in READS[:8]:
        run_both(jr, tr, s, rtol=1e-6)


def test_a_jax_directory_rolls_back_on_the_port(tmp_path):
    """The port's manager reads a JAX manager's index.json and snapshot,
    lists its checkpoints and rolls a port router back to it."""
    jr, _ = routers()
    jr.init_checkpoints(str(tmp_path))
    for s in SETUP:
        jr.execute(s)
    jr.execute("CHECKPOINT 'from_jax'")
    jr.execute("DELETE FROM t WHERE id = 1")     # a second, automatic one
    shutil.copytree(tmp_path, tmp_path.parent / "jax_copy")
    tr = TRouter(device="cpu")
    tr.init_checkpoints(str(tmp_path))
    assert tr.execute("CHECKPOINTS").rows == jr.execute("CHECKPOINTS").rows
    tr.execute("ROLLBACK TO 'from_jax'")
    # a fresh JAX router rolled back from the same files (a copy: each
    # manager writes its own automatic checkpoint into its index)
    jr2, _ = routers()
    jr2.init_checkpoints(str(tmp_path.parent / "jax_copy"))
    jr2.execute("ROLLBACK TO 'from_jax'")
    for s in READS[:8]:
        if s.startswith("ENTITY GET"):
            # the port's ROLLBACK rebuilds the unified engine's map
            assert tr.execute(s).rows == jr.execute(s).rows
        else:
            run_both(jr2, tr, s, rtol=1e-6)
    # and the reverse: a JAX manager rolls back from the port's files
    tr.execute("CHECKPOINT 'from_port'")
    back = JManager(JStore(), str(tmp_path))
    assert back.rollback("from_port")["entries"] == len(tr.store)


def test_port_manager_matches_jax_on_a_plain_store(tmp_path):
    """The copy's bookkeeping: ids, names, reasons, retention, previews
    and deletes equal the JAX manager's on the same sequence."""
    stores = (JStore(), TensorStore())
    mgrs = (JManager(stores[0], tmp_path / "j", retention=2),
            TManager(stores[1], tmp_path / "t", retention=2))
    for i in range(5):
        stores[0].put(f"k{i}", JData({"v": JValue.scalar(i)}))
        stores[1].put(f"k{i}", TensorData({"v": TensorValue.scalar(i)}))
        for m in mgrs:
            m.create(name=f"n{i}" if i % 2 else None)
            m.auto_checkpoint("delete", f"row {i}")
            m.auto_checkpoint("select")
    strip = [[{k: v for k, v in c.items() if k not in ("created", "path")}
              for c in m.list()] for m in mgrs]
    assert strip[0] == strip[1]
    for m, st in zip(mgrs, stores):
        m.rollback("n3")
        assert sorted(st.keys()) == [f"k{i}" for i in range(4)]
    previews = [m.preview("n1") for m in mgrs]
    assert [{k: v for k, v in p.items() if k != "created"}
            for p in previews] == [{k: v for k, v in previews[0].items()
                                    if k != "created"}] * 2
    assert mgrs[0].delete("n1") and mgrs[1].delete("n1")
    assert not mgrs[1].delete("n1") and not mgrs[0].delete("n1")


# ---------------------------------------------------------------------------
# rollback under every SIMILAR route
# ---------------------------------------------------------------------------

ROUTES = {"pooled": "", "int8": " IN q8", "binary": " IN bits",
          "pq": " IN pq", "tt": " IN tt"}


def _route_routers(tmp_path, x):
    jr, tr = _ckpt_routers(tmp_path)
    for r in (jr, tr):
        for name, quant in (("q8", "int8"), ("bits", "binary"),
                            ("pq", "pq"), ("tt", "tt")):
            r.execute(f"CREATE COLLECTION {name} DIM {x.shape[1]} "
                      f"QUANTIZATION {quant}")
        with r.vector.bulk_ingest():
            for i, v in enumerate(x):
                r.vector.store_embedding(f"k{i}", v, {"cat": i % 4})
                for name in ("q8", "bits", "pq", "tt"):
                    r.vector.store_in_collection(name, f"k{i}", v,
                                                 {"cat": i % 4})
    return jr, tr


def _route_stmts(q):
    out = {}
    for route, where in ROUTES.items():
        out[route] = [f"SIMILAR {_lit(v)}{where} TOP 10" for v in q[:3]]
        out[route].append(f"SIMILAR {_lit(q[3])}{where} WHERE cat = 1 "
                          f"TOP 7")
    return out


@pytest.fixture
def pooled_env(monkeypatch):
    monkeypatch.setenv("NEUMANN_POOLED_MIN_ROWS", "1024")
    monkeypatch.setenv("NEUMANN_POOLED_MIN_POOLS", "64")


def test_rollback_restores_every_route(tmp_path, pooled_env):
    x, q = _data(4096, 64, 5)
    jr, tr = _route_routers(tmp_path, x)
    stmts = _route_stmts(q)
    assert tr.vector.search_route("", 64, 10)["route"] == "f32_pooled"
    assert tr.vector.search_route("col/q8", 64, 10, "cosine", None,
                                  "int8")["route"] == "int8_pooled"
    before = {r: [_hits(tr.execute(s)) for s in ss]
              for r, ss in stmts.items()}
    for r in (jr, tr):
        r.execute("CHECKPOINT 'pre'")
        for i in range(0, 4096, 9):
            v = _lit(-x[i])
            r.execute(f"EMBED STORE 'k{i}' {v}")
            for name in ("q8", "bits", "pq", "tt"):
                r.execute(f"EMBED STORE 'k{i}' {v} IN {name}")
        r.execute("ENTITY CREATE 'e' { a: 1 }")
        r.execute("ENTITY DELETE 'e'")           # an automatic checkpoint
        assert len(r.checkpoints.list()) == 2
        r.execute(f"SIMILAR {_lit(q[0])} TOP 10")
        r.execute("ROLLBACK TO 'pre'")
    for route, ss in stmts.items():
        for s, want in zip(ss, before[route]):
            got = _hits(tr.execute(s))
            assert got == want, (route, s[-40:])
            _same(_hits(jr.execute(s)), got)


def test_rollback_keeps_the_order_of_tied_rows(tmp_path):
    """Binary codes of 32 bits over 2,048 rows tie on nearly every
    distance: after ROLLBACK the port returns the same rows in the same
    order as before the checkpoint (rows in put order, reloaded so)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2048, 32)).astype(np.float32)
    tr = TRouter(device="cpu")
    tr.init_checkpoints(str(tmp_path))
    tr.execute("CREATE COLLECTION bits DIM 32 QUANTIZATION binary")
    for i, v in enumerate(x):
        tr.vector.store_in_collection("bits", f"k{i}", v)
    stmts = [f"SIMILAR {_lit(v)} IN bits TOP 20" for v in x[:8]]
    before = [_hits(tr.execute(s)) for s in stmts]
    ties = sum(len({s for _, s in h}) < len(h) for h in before)
    assert ties == len(stmts)
    tr.execute("CHECKPOINT 'pre'")
    tr.execute(f"EMBED STORE 'k0' {_lit(-x[0])} IN bits")
    tr.execute("ROLLBACK TO 'pre'")
    assert [_hits(tr.execute(s)) for s in stmts] == before


def test_a_deleted_entity_is_an_entity_again_after_rollback(tmp_path):
    """The port's ROLLBACK rebuilds the unified engine's key -> node map
    (ROADMAP §3): ENTITY GET, NEIGHBORS and CONNECTED TO answer as before
    the checkpoint."""
    _, tr = _ckpt_routers(tmp_path)
    for s in SETUP + ["ENTITY CONNECT 'e1' -> 'e2' : rel"]:
        tr.execute(s)
    stmts = ("ENTITY GET 'e2'", "ENTITY GET 'e1'",
             "SIMILAR [0.0, 1.0, 0.0] TOP 2 CONNECTED TO 'e1'",
             "FIND NODE entity WHERE tier = 2")
    before = [tr.execute(s) for s in stmts]
    tr.execute("CHECKPOINT 'pre'")
    tr.execute("ENTITY DELETE 'e2'")
    tr.execute("ROLLBACK TO 'pre'")
    for s, want in zip(stmts, before):
        got = tr.execute(s)
        assert (got.rows, got.results) == (want.rows, want.results), s


def test_rollback_after_reused_rows_keeps_scores(tmp_path):
    """The limit of the tie order's repair: keys that took rows a delete
    freed before the checkpoint come back at rows in the snapshot's
    order, so equal scores may break in another order. The scores stay
    equal, and so do the hits above the last tied score."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2048, 32)).astype(np.float32)
    tr = TRouter(device="cpu")
    tr.init_checkpoints(str(tmp_path))
    tr.execute("CREATE COLLECTION bits DIM 32 QUANTIZATION binary")
    for i, v in enumerate(x):
        tr.vector.store_in_collection("bits", f"k{i}", v)
    for i in range(0, 2048, 16):            # free rows, then reuse them
        tr.vector.delete_from_collection("bits", f"k{i}")
    for i in range(0, 2048, 16):
        tr.vector.store_in_collection("bits", f"n{i}", x[i])
    corpus = tr.vector._corpora["col/bits"][32]
    assert corpus.index.lookup("n0") != corpus.index.capacity - 1
    stmts = [f"SIMILAR {_lit(v)} IN bits TOP 20" for v in x[:8]]
    before = [_hits(tr.execute(s)) for s in stmts]
    assert all(len({s for _, s in h}) < len(h) for h in before)
    tr.execute("CHECKPOINT 'pre'")
    tr.execute(f"EMBED STORE 'k1' {_lit(-x[1])} IN bits")
    tr.execute("ROLLBACK TO 'pre'")
    for s, want in zip(stmts, before):
        got = _hits(tr.execute(s))
        assert [sc for _, sc in got] == [sc for _, sc in want], s[-30:]
        last = want[-1][1]
        assert sorted(h for h in got if h[1] != last) == \
            sorted(h for h in want if h[1] != last), s[-30:]

"""EXPLAIN on the port's router against the JAX router's, on the CPU.

EXPLAIN SELECT (full scan, hash and btree index, joins, GROUP BY, ORDER
BY, LIMIT) and EXPLAIN of other statements give the JAX rows exactly
(``run_both``). EXPLAIN SIMILAR gives the JAX package's steps (scan,
mask, select) with its corpus size, quantization, metric and masks; the
text that describes the TPU's work ("MXU matmul", "blockwise
approx_max_k") names instead the route the port's engine takes for the
statement and the kernel that route launches on the card
(``VectorEngine.search_route``, the engine's own gates). Each route's
case then runs the statement and holds the route to the kernel wrapper
it calls (on the CPU the wrapper runs its plain version): f32 pooled,
int8 pooled and int8 scan, binary top-k and distances, PQ select and
scores, TT, the exact scan, auto-IVF, filters and CONNECTED TO.
"""

import re

import numpy as np
import pytest

from neumann_tpu_torch.engines.vector import VectorEngineConfig as TConfig
from neumann_tpu_torch.ops import kernels as tk
from tests.test_torch_pq import _data, _lit
from tests.test_torch_relational import routers, run_both

SQL = [
    "CREATE TABLE u (id INT PRIMARY KEY, name TEXT, age INT, city TEXT)",
    "CREATE TABLE o (oid INT, uid INT, total FLOAT)",
    "INSERT INTO u VALUES (1, 'a', 30, 'x'), (2, 'b', 40, 'y'), "
    "(3, 'c', 50, 'x')",
    "INSERT INTO o VALUES (1, 1, 9.5), (2, 1, 3.0), (3, 3, 7.25)",
    "CREATE INDEX ON u (city)",
]
EXPLAINS = [
    "EXPLAIN SELECT * FROM u",
    "EXPLAIN SELECT * FROM u WHERE age > 35",
    "EXPLAIN SELECT * FROM u WHERE city = 'x'",
    "EXPLAIN SELECT * FROM u WHERE id = 2",
    "EXPLAIN SELECT u.name, o.total FROM u JOIN o ON u.id = o.uid",
    "EXPLAIN SELECT u.name FROM u LEFT JOIN o ON u.id = o.uid "
    "WHERE o.total > 5",
    "EXPLAIN SELECT city, COUNT(*) FROM u GROUP BY city",
    "EXPLAIN SELECT * FROM u ORDER BY age DESC LIMIT 2 OFFSET 1",
    "EXPLAIN SELECT * FROM nope",
    "EXPLAIN INSERT INTO u VALUES (4, 'd', 20, 'z')",
    "EXPLAIN UPDATE u SET age = 1", "EXPLAIN DELETE FROM u",
    "EXPLAIN NODE CREATE p { a: 1 }", "EXPLAIN NEIGHBORS 0 OUTGOING",
    "EXPLAIN EMBED STORE 'k' [1.0, 2.0]", "EXPLAIN FIND NODE entity",
    "EXPLAIN VAULT GET 'k'", "EXPLAIN CACHE STATS", "EXPLAIN BLOB STATS",
    "EXPLAIN CHECKPOINT", "EXPLAIN SHOW TABLES",
]


def test_explain_statements_match_jax():
    jr, tr = routers()
    for stmt in SQL + EXPLAINS:
        run_both(jr, tr, stmt)


# kernel name (kernels.LAUNCHES) -> its wrapper in ops/kernels.py
WRAPPERS = {"f32_pooled_bits": "f32_pooled_bits",
            "int8_pooled_bits": "int8_pooled_bits",
            "int8_dot_scores": "int8_dot_scores",
            "hamming_topk": "hamming_topk", "hamming_scores": "hamming_scores",
            "pq_adc_select": "pq_adc_topk", "pq_adc": "pq_adc_scores",
            "ivf_probe": "ivf_probe_scores"}


@pytest.fixture(scope="module")
def loaded():
    """A JAX and a port router: 4,096 x 64 rows {"cat": i % 4} in the
    default namespace and in int8 and binary collections, 2,048 in a pq
    and 1,024 in a tt collection, an entity with a neighbour."""
    x, q = _data(4096, 64, 7)
    jr, tr = routers()
    for r in (jr, tr):
        for name, quant, n in (("q8", "int8", 4096), ("bits", "binary", 4096),
                               ("pq", "pq", 2048), ("tt", "tt", 1024)):
            r.execute(f"CREATE COLLECTION {name} DIM 64 QUANTIZATION "
                      f"{quant}")
            with r.vector.bulk_ingest():
                for i in range(n):
                    r.vector.store_in_collection(name, f"k{i}", x[i],
                                                 {"cat": i % 4})
        with r.vector.bulk_ingest():
            for i in range(4096):
                r.vector.store_embedding(f"k{i}", x[i], {"cat": i % 4})
        r.execute(f"ENTITY CREATE 'e0' {{ t: 1 }} EMBEDDING {_lit(x[0])}")
        r.execute(f"ENTITY CREATE 'e1' {{ t: 2 }} EMBEDDING {_lit(x[1])}")
        r.execute("ENTITY CONNECT 'e0' -> 'e1' : rel")
    return jr, tr, q


CASES = [
    # (suffix of the SIMILAR, pooled gate lowered, route, kernel)
    ("TOP 10", True, "f32_pooled", "f32_pooled_bits"),
    ("WHERE cat = 1 TOP 10", True, "f32_pooled", "f32_pooled_bits"),
    ("TOP 10", False, "exact", None),
    ("METRIC euclidean TOP 10", True, "exact", None),
    ("IN q8 TOP 10", True, "int8_pooled", "int8_pooled_bits"),
    ("IN q8 TOP 10", False, "int8_scan", "int8_dot_scores"),
    ("IN q8 METRIC euclidean TOP 5", True, "int8_scan", "int8_dot_scores"),
    ("IN bits TOP 10", False, "binary", "hamming_topk"),
    ("IN bits TOP 65", False, "binary", "hamming_scores"),
    ("IN pq TOP 10", False, "pq", "pq_adc_select"),
    ("IN pq WHERE cat = 2 TOP 65", False, "pq", "pq_adc"),
    ("IN tt TOP 10", False, "tt", None),
]


def _spy(monkeypatch):
    called = []
    for name, fn in WRAPPERS.items():
        orig = getattr(tk, fn)

        def wrap(*a, _orig=orig, _name=name, **kw):
            called.append(_name)
            return _orig(*a, **kw)
        monkeypatch.setattr(tk, fn, wrap)
    return called


def _check_similar(jr, tr, stmt):
    """The JAX rows but for the route text; returns the port's rows."""
    want, got = jr.execute(stmt).rows, tr.execute(stmt).rows
    assert [r["operation"] for r in got] == [r["operation"] for r in want]
    assert want[0]["detail"].startswith("MXU matmul over ")
    assert got[0]["detail"].endswith(
        want[0]["detail"][len("MXU matmul"):])
    assert got[1:-1] == want[1:-1]                 # the mask step
    limit = re.match(r"top-\d+ ", want[-1]["detail"]).group(0)
    assert got[-1]["detail"].startswith(limit)
    return got


@pytest.mark.parametrize("suffix,gate,route,kernel", CASES)
def test_explain_similar_names_the_route_taken(loaded, monkeypatch, suffix,
                                               gate, route, kernel):
    jr, tr, q = loaded
    if gate:
        monkeypatch.setenv("NEUMANN_POOLED_MIN_ROWS", "1024")
        monkeypatch.setenv("NEUMANN_POOLED_MIN_POOLS", "64")
    stmt = f"SIMILAR {_lit(q[0])} {suffix}"
    rows = _check_similar(jr, tr, f"EXPLAIN {stmt}")
    assert rows[0]["detail"].startswith(f"route {route}: "), rows
    if kernel is not None:
        assert f"(kernel {kernel})" in rows[0]["detail"], rows
    called = _spy(monkeypatch)
    assert tr.execute(stmt).results
    assert (called[0] if called else None) == kernel, called


def test_explain_similar_on_the_auto_ivf_route(loaded, monkeypatch):
    jr, tr, q = loaded
    monkeypatch.setattr(tr.vector, "config", TConfig(
        ivf_auto_threshold=4096, ivf_auto_clusters=16, ivf_auto_nprobe=4))
    stmt = f"SIMILAR {_lit(q[1])} TOP 10"
    rows = tr.execute(f"EXPLAIN {stmt}").rows
    assert rows[0]["detail"].startswith("route auto_ivf: ") and \
        "(kernel ivf_probe)" in rows[0]["detail"], rows
    called = _spy(monkeypatch)
    assert tr.execute(stmt).results
    assert called and set(called) == {"ivf_probe"}, called
    # a filter takes the brute-force route, as the search does
    rows = tr.execute(f"EXPLAIN {stmt[:-7]} WHERE cat = 1 TOP 10").rows
    assert not rows[0]["detail"].startswith("route auto_ivf"), rows


def test_explain_similar_by_key_connected_and_empty(loaded):
    jr, tr, _ = loaded
    rows = _check_similar(jr, tr, "EXPLAIN SIMILAR 'k3' IN bits TOP 3")
    assert rows[0]["detail"].startswith("route binary: ")
    rows = _check_similar(jr, tr, "EXPLAIN SIMILAR 'e1' TOP 2 CONNECTED "
                                  "TO 'e0'")
    assert rows[0]["detail"].startswith("unified engine: ")
    assert len(rows) == 3                          # the neighbourhood mask
    rows = _check_similar(jr, tr, "EXPLAIN SIMILAR [1.0, 2.0] TOP 2")
    assert rows[0]["detail"].startswith("no rows to scan")
    for stmt in ("EXPLAIN SIMILAR 'missing' TOP 2",
                 "EXPLAIN SIMILAR [1.0] IN nope TOP 2"):
        run_both(jr, tr, stmt, fields=("kind",))


def test_search_route_follows_the_engine_gates(loaded, monkeypatch):
    """``search_route`` is None where no rows of the dimension exist,
    and follows the pooled gate's environment overrides."""
    _, tr, _ = loaded
    assert tr.vector.search_route("", 3, 10) is None
    assert tr.vector.search_route("col/nope", 64, 10) is None
    assert tr.vector.search_route("", 64, 10)["route"] == "exact"
    monkeypatch.setenv("NEUMANN_POOLED_MIN_ROWS", "1024")
    monkeypatch.setenv("NEUMANN_POOLED_MIN_POOLS", "64")
    got = tr.vector.search_route("", 64, 10)
    assert got == dict(route="f32_pooled", kernel="f32_pooled_bits",
                       pool=got["pool"], rows=4096) and got["pool"] >= 8
    assert np.log2(got["pool"]).is_integer()

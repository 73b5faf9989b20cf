"""The port's LLM cache (neumann_tpu_torch/cache/llm_cache.py, a copy
of the JAX package's on the port's host HNSW) and the routers' CACHE
statements and query cache, against the JAX package's, on the CPU.

The cache cases of tests/test_extended_modules.py (exact and semantic
layers, the embedding layer, TTL, LRU capacity, clear, the HNSW rebuild
and the dimension check) run on both packages as one test each
(tests/torch_twins.py). ``convert.llm_cache_from_jax`` carries a JAX
cache to the port with equal answers. CACHE statements through a JAX
and a port router give equal results (``run_both``).

The JAX router's query cache (``enable_query_cache``) serves stale and
foreign results: a cached SELECT or SIMILAR survives the UPDATE, DELETE,
INSERT or EMBED STORE that changes its answer, and a different SELECT
of similar text is answered from the semantic layer. The port keeps
results in a dict of its own, answers only the same text and forgets
every result at the store's next write (ROADMAP §3); its answers equal
an uncached router's, and a CACHE PUT under a statement's text does not
reach them.

``docs_cli`` (the default embedder over the unified engine) indexes the
same sections and finds the same hits on both packages.
"""

import numpy as np
import pytest

from neumann_tpu.cache import LLMCache as JCache
from neumann_tpu_torch import convert
from neumann_tpu_torch.cache import LLMCache as TCache
from tests.test_torch_relational import routers, run_both, same
from tests.torch_twins import twin_tests

globals().update(twin_tests("test_extended_modules", (
    "test_cache_exact_and_semantic", "test_cache_embedding_layer",
    "test_cache_ttl_expiry", "test_cache_capacity_eviction_lru",
    "test_cache_clear", "test_cache_semantic_hnsw_rebuild",
    "test_cache_semantic_dim_mismatch")))

WORDS = ("what how why is are the a of machine learning vector search "
         "index graph table store cache blob query token model train "
         "cost rollback checkpoint").split()


def _prompts(n, seed=0, words=12):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, words)) for _ in range(n)]


@pytest.mark.parametrize("eviction", ["lru", "lfu", "cost", "hybrid"])
def test_llm_cache_from_jax_answers_alike(eviction):
    """Entries, TTLs, statistics, the embedding layer and the HNSW graph
    carry over: the same lookups then give the same answers, counts and
    evictions on both."""
    jc = JCache(capacity=48, semantic_threshold=0.8, eviction=eviction,
                default_ttl_s=3600.0)
    prompts = _prompts(64)
    for i, p in enumerate(prompts[:56]):
        jc.put(p, f"answer {i} " * (1 + i % 5))
    jc.invalidate(prompts[50])
    jc.get(prompts[3])
    jc.put_embedding("ext", "doc", np.ones(256, np.float32))
    tc = convert.llm_cache_from_jax(jc)
    assert type(tc) is TCache and len(tc) == len(jc)
    assert tc._hnsw.to_bytes() == jc._hnsw.to_bytes()
    np.testing.assert_array_equal(tc.get_embedding("ext", "doc"),
                                  jc.get_embedding("ext", "doc"))
    lookups = prompts + [p + " please" for p in prompts[:20]]
    for q in lookups:
        assert tc.get(q) == jc.get(q), q
        assert tc.get_exact(q) == jc.get_exact(q), q
    for i, p in enumerate(_prompts(16, seed=1)):
        jc.put(p, f"late {i}")
        tc.put(p, f"late {i}")
    assert sorted(tc._exact) == sorted(jc._exact)
    assert vars(tc.stats) == vars(jc.stats)


def test_cache_statements_match_jax():
    jr, tr = routers()
    run_both(jr, tr, "CACHE STATS")                 # not initialised
    for stmt in ("CACHE INIT", "CACHE PUT 'what is a vector' 'an array'",
                 "CACHE GET 'what is a vector'", "CACHE GET 'nothing'",
                 "CACHE SEMANTIC PUT 'how do graphs work' 'edges'",
                 "CACHE SEMANTIC GET 'how do graphs work'",
                 "CACHE SEMANTIC GET 'how do the graphs work' THRESHOLD 0.5",
                 "CACHE SEMANTIC GET 'unrelated turtles' THRESHOLD 0.99",
                 "CACHE SEMANTIC PUT 'seeded' 'x' EMBEDDING [1.0, 0.0, 0.0]",
                 "CACHE STATS", "CACHE EVICT 1", "CACHE STATS",
                 "CACHE CLEAR", "CACHE STATS", "CACHE INIT"):
        run_both(jr, tr, stmt)


def _query_cache_script(r):
    """Results of a cached router across writes that change them."""
    r.execute("CREATE TABLE users (id INT PRIMARY KEY, name TEXT, "
              "city TEXT, age INT)")
    r.execute("INSERT INTO users VALUES (1, 'ann', 'oslo', 30), "
              "(2, 'bob', 'rome', 40), (3, 'cid', 'oslo', 50)")
    sel = "SELECT name, age FROM users WHERE city = 'oslo' ORDER BY name"
    out = {"select": r.execute(sel).rows}
    r.execute("UPDATE users SET age = 31 WHERE id = 1")
    out["after_update"] = r.execute(sel).rows
    r.execute("DELETE FROM users WHERE id = 3")
    out["after_delete"] = r.execute(sel).rows
    r.execute("INSERT INTO users VALUES (4, 'dag', 'oslo', 20)")
    out["after_insert"] = r.execute(sel).rows
    r.execute("EMBED STORE 'x' [1.0, 0.0, 0.0]")
    r.execute("EMBED STORE 'y' [0.0, 1.0, 0.0]")
    sim = "SIMILAR [1.0, 0.2, 0.0] TOP 1"
    out["similar"] = r.execute(sim).results
    r.execute("EMBED STORE 'y' [1.0, 0.2, 0.0]")
    out["after_embed"] = r.execute(sim).results
    long = ("SELECT name, city, age FROM users WHERE age > 10 AND city = "
            "'{}' AND name != 'zed' ORDER BY name LIMIT 5")
    out["oslo"] = r.execute(long.format("oslo")).rows
    out["rome"] = r.execute(long.format("rome")).rows
    out["case"] = r.execute(sel.replace("'oslo'", "'OSLO'")).rows
    return out


def test_reference_query_cache_serves_stale_and_near_results():
    """The fault, on the JAX router alone: every cached answer outlives
    the write that changes it, and a different statement of similar
    text gets another's result."""
    jr, _ = routers()
    fresh = _query_cache_script(jr)
    jr, _ = routers()
    jr.enable_query_cache()
    cached = _query_cache_script(jr)
    for key in ("after_update", "after_delete", "after_insert"):
        assert fresh[key] != fresh["select"]
        assert cached[key] == cached["select"], key
    assert fresh["after_embed"] != fresh["similar"]
    assert cached["after_embed"] == cached["similar"]
    assert fresh["rome"] != fresh["oslo"]
    assert cached["rome"] == cached["oslo"]
    assert cached["case"] == cached["select"] != fresh["case"]


def test_port_query_cache_answers_as_an_uncached_router():
    """The repair: the port's cached router answers every step as an
    uncached one (and as the uncached JAX router), and serves a repeat
    of the same text from the cache."""
    jr, tr = routers()
    want = _query_cache_script(jr)
    _, tr = routers()
    tr.enable_query_cache()
    got = _query_cache_script(tr)
    same(got, want, rtol=1e-6)
    stmt = "SIMILAR [1.0, 0.2, 0.0] TOP 1"
    runs = _count_runs(tr)
    assert tr.execute(stmt).results == got["after_embed"]
    assert runs == []
    # an engine call writes too: the next repeat is searched again
    tr.vector.store_embedding("z", np.array([0.0, 0.0, 1.0], np.float32))
    assert tr.execute(stmt).results == got["after_embed"]
    assert len(runs) == 1
    # so does a columnar ingest, which keeps its fast path (the cache
    # adds no store hook)
    assert {h.__func__.__qualname__ for h in tr.store._put_hooks} <= \
        tr.vector._INGEST_SAFE_HOOKS
    far = "SIMILAR [0.0, -1.0, 0.0] TOP 1"
    assert tr.execute(far).results[0]["key"] != "w"
    tr.vector.ingest_matrix(["w"], np.array([[0.0, -1.0, 0.0]], np.float32))
    assert tr.execute(far).results[0]["key"] == "w"
    assert len(runs) == 3


def _count_runs(router):
    """The statements ``router`` runs from now on (not served from its
    query cache)."""
    runs, run = [], router.execute_statement

    def counted(stmt):
        runs.append(stmt)
        return run(stmt)

    router.execute_statement = counted
    return runs


def test_port_query_cache_answers_with_a_copy_and_ignores_cache_put():
    """A caller that changes a result it was given does not change the
    next answer, and CACHE PUT under a statement's text (any value, hex
    or not) reaches only the LLM cache, never the query cache."""
    _, tr = routers()
    tr.enable_query_cache()
    tr.execute("CREATE TABLE t (id INT PRIMARY KEY, v INT)")
    tr.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
    stmt = "SELECT * FROM t"
    want = tr.execute(stmt).rows
    tr.execute(stmt).rows.clear()
    assert tr.execute(stmt).rows == want
    tr.execute("CACHE INIT")
    for value in ("not hex", "80049500"):
        tr.execute(f"CACHE PUT '{stmt.lower()}' '{value}'")
        tr.execute(f"CACHE PUT '{stmt}' '{value}'")
        assert tr.execute(stmt).rows == want


def test_docs_cli_indexes_and_searches_as_jax(tmp_path, monkeypatch, capsys):
    """``docs_cli`` (the cache's default embedder over the unified
    engine): the same sections indexed and the same hits on both
    packages; the port's ``main`` indexes and searches on a router it is
    given."""
    from neumann_tpu import docs_cli as jdocs
    from neumann_tpu_torch import docs_cli as tdocs
    from neumann_tpu_torch.router import QueryRouter as TRouter

    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "wal.md").write_text(
        "# WAL\nThe write-ahead log records every put.\n"
        "## Recovery\nOn restart the wal replays records after the "
        "snapshot.\n")
    (docs / "search.txt").write_text("Vector search scans the corpus on "
                                     "the card and reranks the best pools.")
    (docs / "skip.bin").write_bytes(b"\x00")
    jr, tr = routers()
    assert jdocs.build_index(jr, str(docs)) == \
        tdocs.build_index(tr, str(docs)) == 3
    for q in ("how does the wal recover", "vector search on the card"):
        got, want = tdocs.search(tr, q, k=3), jdocs.search(jr, q, k=3)
        assert [h["key"] for h in got] == [h["key"] for h in want]
        same(got, want, rtol=1e-4)
    monkeypatch.setattr(tdocs, "_STATE", str(tmp_path / "state.ntpu"))
    assert tdocs.main(["index", str(docs)], TRouter(device="cpu")) == 0
    assert tdocs.main(["search", "wal", "recovery"],
                      TRouter(device="cpu")) == 0
    out = capsys.readouterr().out
    assert "indexed 3 sections" in out and "wal.md" in out


def test_port_query_cache_keeps_no_result_computed_across_a_write():
    """A write that lands while a statement runs (another client's) makes
    its result stale before it is stored: the port does not keep it."""
    _, tr = routers()
    tr.enable_query_cache()
    tr.execute("EMBED STORE 'x' [1.0, 0.0]")
    run = tr.execute_statement

    def racing(stmt):
        out = run(stmt)
        tr.vector.store_embedding("y", np.array([1.0, 0.0], np.float32))
        return out

    stmt = "SIMILAR [1.0, 0.0] TOP 2"
    tr.execute_statement = racing
    first = tr.execute(stmt)
    tr.execute_statement = run
    assert [h["key"] for h in first.results] == ["x"]
    runs = _count_runs(tr)
    assert len(tr.execute(stmt).results) == 2
    assert len(runs) == 1


def test_port_query_cache_holds_at_most_its_capacity(monkeypatch):
    """The dict drops its oldest statement when full: a repeat of it is
    run again, a repeat of the newest is served."""
    from neumann_tpu_torch.router import QueryRouter as TRouter

    monkeypatch.setattr(TRouter, "_QUERY_CACHE_CAPACITY", 2)
    _, tr = routers()
    tr.enable_query_cache()
    tr.execute("EMBED STORE 'x' [1.0, 0.0]")
    stmts = [f"SIMILAR [1.0, {v}] TOP 1" for v in ("0.1", "0.2", "0.3")]
    for stmt in stmts:
        tr.execute(stmt)
    runs = _count_runs(tr)
    tr.execute(stmts[2])
    assert runs == []
    tr.execute(stmts[0])
    assert len(runs) == 1
    assert len(tr._query_cache) == 2

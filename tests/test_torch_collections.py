"""The port's collections, entity embeddings and brute-force routes
(neumann_tpu_torch/engines/vector.py, router/router.py, convert.py)
side by side with the JAX package's, on the CPU.

4,096 x 64 clustered rows, loaded into each quantization (none, int8,
binary) of both engines. With NEUMANN_POOLED_MIN_ROWS=1024 and
NEUMANN_POOLED_MIN_POOLS=64 (set through monkeypatch for both packages,
which read them at search time) the cosine routes take the pooled-bits
scans (pool 8, 512 pools) as a 256K-row corpus does by default; other
metrics take the int8 scan or the exact scan. The JAX engine runs with
``mesh_auto=False``, since tests/conftest.py gives JAX 8 virtual CPU
devices.

Tolerances: scores within 1e-5 (1e-4 for euclidean's 1/(1+d)), keys
equal wherever the scores are more than that apart, and among scores
exactly equal in both packages (an exact tie, apart from every other
score and not at the end of the list) the same keys in the same order,
``lax.top_k``'s. Binary scores are
-hamming distances: equal exactly, and the keys equal in the same order
(equal distances by row, as the JAX package's ``lax.top_k`` orders
them), each at its reported distance.
"""

import numpy as np
import pytest

from neumann_tpu.engines.vector import FilterCondition as JFilter
from neumann_tpu.engines.vector import VectorCollectionConfig as JColl
from neumann_tpu.engines.vector import VectorEngine as JEngine
from neumann_tpu.engines.vector import VectorEngineConfig as JConfig
from neumann_tpu.router import QueryRouter as JRouter
from neumann_tpu.utils.errors import VectorError as JVectorError
from neumann_tpu_torch.convert import collection_state_from_jax
from neumann_tpu_torch.engines.vector import FilterCondition as TFilter
from neumann_tpu_torch.engines.vector import VectorCollectionConfig as TColl
from neumann_tpu_torch.engines.vector import VectorEngine as TEngine
from neumann_tpu_torch.ops import kernels as tk
from neumann_tpu_torch.router import QueryRouter as TRouter
from neumann_tpu_torch.store.tensor_store import TensorStore
from neumann_tpu_torch.utils.errors import VectorError as TVectorError

N, D = 4096, 64
QUANTS = ("none", "int8", "binary")


def _vec(v):
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    cents = rng.standard_normal((32, D)).astype(np.float32) * 2
    v = (cents[rng.integers(0, 32, N)]
         + 0.4 * rng.standard_normal((N, D))).astype(np.float32)
    qs = (v[rng.choice(N, 12)]
          + 0.05 * rng.standard_normal((12, D))).astype(np.float32)
    return v, qs


@pytest.fixture
def pooled_env(monkeypatch):
    monkeypatch.setenv("NEUMANN_POOLED_MIN_ROWS", "1024")
    monkeypatch.setenv("NEUMANN_POOLED_MIN_POOLS", "64")


@pytest.fixture(scope="module")
def engines(data):
    """A JAX and a port engine, each with one collection per
    quantization holding the same rows (metadata cat = i % 4)."""
    v, _ = data
    je = JEngine(config=JConfig(mesh_auto=False))
    te = TEngine(device="cpu")
    for eng, coll in ((je, JColl), (te, TColl)):
        for quant in QUANTS:
            eng.create_collection(quant, coll(dimension=D,
                                              quantization=quant))
            with eng.bulk_ingest():
                for i in range(N):
                    eng.store_in_collection(quant, f"k{i}", v[i],
                                            {"cat": i % 4})
    return je, te


def _assert_hits_close(got, want, tol=1e-5):
    assert len(got) == len(want)
    s_g = np.array([h.score for h in got])
    s_w = np.array([h.score for h in want])
    np.testing.assert_allclose(s_g, s_w, rtol=0, atol=tol)
    for j, h in enumerate(want):
        near = np.abs(s_w - s_w[j]) <= 2 * tol
        tied = (s_w == s_w[j]) & (s_g == s_g[j])
        if (near == tied).all() and not near[-1]:
            assert got[j].key == h.key, j


def _assert_binary_hits(got, want, v, q):
    """The JAX engine's keys in its order (equal distances by row) and
    -hamming distances, each key at its reported distance."""
    assert [h.score for h in got] == [h.score for h in want]
    assert [h.key for h in got] == [h.key for h in want]
    qb = (q > 0)
    for h in got:
        row = int(h.key[1:])
        assert -np.count_nonzero((v[row] > 0) != qb) == h.score


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("filtered", [False, True])
def test_collection_search_matches_jax(engines, data, pooled_env, quant,
                                       filtered):
    je, te = engines
    v, qs = data
    tk.reset_launch_counts()
    for q in qs[:4]:
        if filtered:
            want = je.search_filtered_in_collection(
                quant, q, 10, JFilter.eq("cat", 1))
            got = te.search_filtered_in_collection(
                quant, q, 10, TFilter.eq("cat", 1))
            assert all(int(h.key[1:]) % 4 == 1 for h in got)
        else:
            want = je.search_in_collection(quant, q, 10)
            got = te.search_in_collection(quant, q, 10)
        if quant == "binary":
            _assert_binary_hits(got, want, v, q)
        else:
            _assert_hits_close(got, want)
    # on the CPU the wrappers take their plain versions: nothing counts
    assert set(tk.LAUNCHES.values()) == {0}


def test_routes_taken(engines, data, pooled_env, monkeypatch):
    """Which scan each quantization and metric reaches (the plain
    versions stand in for the kernels on the CPU)."""
    _, te = engines
    _, qs = data
    called = []
    for name in ("int8_dot_scores", "int8_pooled_bits", "f32_pooled_bits",
                 "hamming_scores", "hamming_topk"):
        orig = getattr(tk, name)

        def spy(*a, _name=name, _orig=orig, **kw):
            called.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(tk, name, spy)
    cases = (("none", "cosine", ["f32_pooled_bits"]),
             ("none", "euclidean", []),
             ("int8", "cosine", ["int8_pooled_bits"]),
             ("int8", "euclidean", ["int8_dot_scores"]),
             ("int8", "dot", ["int8_dot_scores"]),
             ("binary", "cosine", ["hamming_topk"]))
    for quant, metric, want in cases:
        called.clear()
        te.search_in_collection(quant, qs[0], 10, metric)
        assert called == want, (quant, metric, called)
    # above the fused kernel's k cap, one hamming_scores call per block
    called.clear()
    te.search_in_collection("binary", qs[0], tk.HAMMING_TOPK_CAP + 1)
    assert called == ["hamming_scores"]
    # without the lowered gate a 4,096-row corpus takes no pooled route
    monkeypatch.delenv("NEUMANN_POOLED_MIN_ROWS")
    called.clear()
    te.search_in_collection("int8", qs[0], 10)
    assert called == ["int8_dot_scores"]


@pytest.mark.parametrize("metric", ["euclidean", "dot", "angular"])
def test_int8_metrics_match_jax(engines, data, pooled_env, metric):
    je, te = engines
    _, qs = data
    for q in qs[4:7]:
        want = je.search_in_collection("int8", q, 8, metric)
        got = te.search_in_collection("int8", q, 8, metric)
        _assert_hits_close(got, want, 1e-4)


@pytest.mark.parametrize("quant", QUANTS)
def test_batch_search_ns_matches_jax(engines, data, pooled_env, quant):
    je, te = engines
    v, qs = data
    want = je.batch_search_ns(qs, 10, ns=f"col/{quant}")
    got = te.batch_search_ns(qs, 10, ns=f"col/{quant}")
    assert len(got) == len(want) == len(qs)
    for g, w, q in zip(got, want, qs):
        if quant == "binary":
            _assert_binary_hits(g, w, v, q)
        else:
            _assert_hits_close(g, w)
    with pytest.raises(TVectorError):
        te.batch_search_ns(qs[:, :32], 10, ns=f"col/{quant}")


def test_default_namespace_pooled_route_matches_jax(data, pooled_env):
    v, qs = data
    je = JEngine(config=JConfig(mesh_auto=False))
    te = TEngine(device="cpu")
    for eng in (je, te):
        eng.ingest_matrix([f"k{i}" for i in range(N)], v)
    for q in qs[:3]:
        _assert_hits_close(te.search_similar(q, 10),
                           je.search_similar(q, 10))
    cond = (JFilter.eq("cat", 1), TFilter.eq("cat", 1))
    assert te.search_similar_filtered(qs[0], 5, cond[1]) == []  # no metadata
    assert je.search_similar_filtered(qs[0], 5, cond[0]) == []
    got = te.batch_search(qs, 10)
    want = je.batch_search(qs, 10)
    for g, w in zip(got, want):
        _assert_hits_close(g, w)


def test_router_collection_statements_match_jax(data, pooled_env):
    v, qs = data
    jr = JRouter()
    jr.vector.config = JConfig(mesh_auto=False)
    tr = TRouter(device="cpu")
    script = [f"CREATE COLLECTION q8 DIM {D} QUANTIZATION int8",
              f"CREATE COLLECTION bits DIM {D} METRIC cosine "
              f"QUANTIZATION binary"]
    for r in (jr, tr):
        for stmt in script:
            assert r.execute(stmt).kind == "message"
        for name in ("q8", "bits"):
            with r.vector.bulk_ingest():
                for i in range(N):
                    r.vector.store_in_collection(name, f"k{i}", v[i],
                                                 {"cat": i % 4})
        r.execute(f"EMBED STORE 'extra' {_vec(v[3] * 2)} IN q8")
        r.execute(f"EMBED BATCH [('b1', {_vec(v[9])})] IN fresh")
    for stmt in (f"SIMILAR {_vec(qs[0])} IN q8 TOP 10",
                 f"SIMILAR {_vec(qs[1])} TOP 10 IN q8 WHERE cat = 3",
                 f"SIMILAR {_vec(qs[2])} IN q8 METRIC euclidean TOP 6",
                 "SIMILAR 'k17' IN q8 TOP 5",
                 f"SIMILAR {_vec(qs[3])} IN fresh TOP 3"):
        got, want = tr.execute(stmt), jr.execute(stmt)
        assert got.kind == want.kind == "similar"
        g = [(h["key"], h["score"]) for h in got.results]
        w = [(h["key"], h["score"]) for h in want.results]
        assert len(g) == len(w)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=1e-4)
    hits = tr.execute(f"SIMILAR {_vec(qs[1])} TOP 10 IN q8 WHERE cat = 3")
    assert all(int(h["key"][1:]) % 4 == 3 for h in hits.results)
    for top in (7, tk.HAMMING_TOPK_CAP + 1):
        stmt = f"SIMILAR {_vec(qs[4])} IN bits TOP {top}"
        bits = tr.execute(stmt).results
        assert [(h["key"], h["score"]) for h in bits] == [
            (h["key"], h["score"]) for h in jr.execute(stmt).results]
    for stmt in ("SHOW COLLECTIONS", "EMBED GET 'k5' IN q8",
                 "EMBED GET 'nope' IN q8", "EMBED DELETE 'k5' IN q8",
                 "EMBED GET 'k5' IN q8", "DROP COLLECTION bits",
                 "DROP COLLECTION bits", "SHOW COLLECTIONS"):
        got, want = tr.execute(stmt), jr.execute(stmt)
        assert (got.kind, got.message, got.rows) == \
            (want.kind, want.message, want.rows), stmt
        if got.kind == "value":
            np.testing.assert_allclose(got.value, want.value)
    assert "k5" not in [h["key"] for h in tr.execute(
        f"SIMILAR {_vec(v[5])} IN q8 TOP 3").results]


def test_wide_binary_collection_matches_jax():
    """A 3,072-d ``QUANTIZATION binary`` collection (W 96, as sign bits
    of text-embedding-3-large rows) through both routers: the same keys in
    the same order and the same -hamming scores, below and above the fused
    kernel's k cap."""
    d, n = 3072, 300
    rng = np.random.default_rng(d)
    base = rng.standard_normal((40, d)).astype(np.float32)
    v = base[rng.integers(0, 40, n)]
    qs = (v[rng.choice(n, 2)]
          + 0.5 * rng.standard_normal((2, d))).astype(np.float32)
    jr = JRouter()
    jr.vector.config = JConfig(mesh_auto=False)
    tr = TRouter(device="cpu")
    for r in (jr, tr):
        stmt = f"CREATE COLLECTION wide DIM {d} QUANTIZATION binary"
        assert r.execute(stmt).kind == "message"
        with r.vector.bulk_ingest():
            for i in range(n):
                r.vector.store_in_collection("wide", f"k{i}", v[i])
    for q in qs:
        for top in (10, tk.HAMMING_TOPK_CAP + 1):
            stmt = f"SIMILAR {_vec(q)} IN wide TOP {top}"
            got, want = tr.execute(stmt), jr.execute(stmt)
            assert got.kind == want.kind == "similar"
            g = [(h["key"], h["score"]) for h in got.results]
            assert len(g) == top
            assert g == [(h["key"], h["score"]) for h in want.results]


def test_entity_embeddings_match_jax(data):
    v, qs = data
    je = JEngine(config=JConfig(mesh_auto=False))
    te = TEngine(device="cpu")
    for eng in (je, te):
        eng.ingest_matrix([f"e{i}" for i in range(512)], v[:512],
                          ns="entity")
        eng.store_entity_embedding("late", v[600])
        eng.store_embedding("plain", v[601])       # another namespace
    assert te.entity_corpus(D).count() == 513
    np.testing.assert_array_equal(te.get_entity_embedding("e7"), v[7])
    for q in (qs[0], v[600]):
        _assert_hits_close(te.search_entities(q, 6),
                           je.search_entities(q, 6))
    assert te.search_entities(v[600], 1)[0].key == "late"
    assert "plain" not in {h.key for h in te.search_entities(v[601], 5)}
    mask = np.zeros(te.entity_corpus(D).slab.capacity, bool)
    mask[:100] = True
    hits = te.search_entities(qs[0], 5, mask_rows=mask)
    assert all(int(h.key[1:]) < 100 for h in hits)
    with pytest.raises(TVectorError):
        te.ingest_matrix(["x"], v[:1], ns="col/x")


def test_ingest_matrix_with_wal_keeps_the_namespace(tmp_path, data):
    """With a WAL the ingest takes the per-row path. The JAX engine's
    per-row fallback writes every row under ``emb:`` whatever ``ns`` is;
    the port keeps ``entity:`` rows in the entity namespace."""
    v, _ = data
    store = TensorStore()
    store.open_durable(tmp_path / "wal.bin")
    te = TEngine(store, device="cpu")
    keys = [f"w{i}" for i in range(40)]
    te.ingest_matrix(keys, v[:40], ns="entity")
    assert not [k for k in store.scan("emb:")]
    assert sorted(store.scan("entity:")) == sorted(f"entity:{k}"
                                                   for k in keys)
    assert te.count_embeddings() == 0
    assert te.entity_corpus(D).count() == 40
    assert te.search_entities(v[3], 1)[0].key == "w3"
    assert te.search_similar(v[3], 1) == []
    # the WAL replays the rows into the entity namespace of a new engine
    store.wal_flush()
    fresh = TensorStore()
    te2 = TEngine(fresh, device="cpu")
    fresh.recover(tmp_path / "wal.bin")
    assert te2.search_entities(v[3], 1)[0].key == "w3"


def test_snapshot_round_trip_both_ways(tmp_path, data):
    v, _ = data
    je = JEngine(config=JConfig(mesh_auto=False))
    te = TEngine(device="cpu")
    rows = range(0, N, 16)
    for eng, coll in ((je, JColl), (te, TColl)):
        eng.create_collection("snap", coll(dimension=D, quantization="int8"))
        for i in rows:
            eng.store_in_collection("snap", f"k{i}", v[i],
                                    {"cat": i % 4, "tag": f"t{i}"})
    assert je.snapshot_collection("snap", tmp_path / "j.npz") == len(rows)
    assert te.snapshot_collection("snap", tmp_path / "t.npz") == len(rows)
    je2 = JEngine(config=JConfig(mesh_auto=False))
    te2 = TEngine(device="cpu")
    assert te2.load_collection_snapshot("fromj", tmp_path / "j.npz") == \
        len(rows)
    assert je2.load_collection_snapshot("fromt", tmp_path / "t.npz") == \
        len(rows)
    for i in (0, 160, 4080):
        got = te2.store.get(f"col:fromj:k{i}")
        np.testing.assert_array_equal(got.get("embedding").to_dense(), v[i])
        assert got.get("tag").value == f"t{i}"
        back = je2.store.get(f"col:fromt:k{i}")
        np.testing.assert_array_equal(back.get("embedding").to_dense(), v[i])
        assert back.get("cat").value == i % 4
    _assert_hits_close(te2.search_in_collection("fromj", v[32], 5),
                       je2.search_in_collection("fromt", v[32], 5))
    # the state converter carries the config too
    state = collection_state_from_jax(je, "snap")
    assert state["config"] == {"dimension": D, "metric": "cosine",
                               "quantization": "int8"}
    assert state["vectors"].shape == (len(rows), D)
    te3 = TEngine(device="cpu")
    te3.create_collection("snap", TColl(**state["config"]))
    for key, vec, meta in zip(state["keys"], state["vectors"],
                              state["metadata"]):
        te3.store_in_collection("snap", str(key), vec, meta)
    assert te3.collection_stats("snap") == te.collection_stats("snap")
    _assert_hits_close(te3.search_in_collection("snap", v[48], 5),
                       je.search_in_collection("snap", v[48], 5))


def test_collection_errors_match_jax():
    for eng, coll, error in (
            (JEngine(config=JConfig(mesh_auto=False)), JColl, JVectorError),
            (TEngine(device="cpu"), TColl, TVectorError)):
        eng.create_collection("c", coll(dimension=4))
        with pytest.raises(error):
            eng.create_collection("c")
        with pytest.raises(error):
            eng.store_in_collection("c", "a", np.ones(5))
        with pytest.raises(error):
            eng.search_in_collection("missing", np.ones(4), 3)
        with pytest.raises(error):
            eng.create_collection("d", coll(quantization="fp4"))
        assert eng.search_in_collection("c", np.ones(4), 3) == []
        assert eng.drop_collection("c") and not eng.drop_collection("c")
        assert eng.list_collections() == []

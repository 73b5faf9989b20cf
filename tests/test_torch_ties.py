"""Equal scores in ``lax.top_k``'s order on every route of the port, on
the CPU, against the JAX package.

The corpus holds each of a few seeded random vectors several times
(``_dup``: 2-16 copies, laid out consecutively or interleaved), so
every query meets exact ties, among them ties that straddle the k-th
place. Wherever JAX's route ends in ``lax.top_k`` the port must give
JAX's keys in JAX's order: the exact scan under every metric, filtered
(cosine and euclidean), batched and paginated searches, the int8 scan,
the pooled int8 and f32 scans with their rerank (small corpora take
them through a lowered ``NEUMANN_POOLED_MIN_ROWS`` / ``MIN_POOLS``), the
auto-IVF index single and batched (the port given JAX's layout, as in
tests/test_torch_engine.py), collections, the entity (FIND) route, the
sharded corpus's merge and the planner's. Scores are held within 1e-5
(squared euclidean distances within 1e-4). The paginated walks must
also give disjoint pages that together are the top-(k + offset).
"""

import numpy as np
import pytest

from neumann_tpu.engines.unified import UnifiedEngine as JUnified
from neumann_tpu.engines.vector import FilterCondition as JFilter
from neumann_tpu.engines.vector import VectorCollectionConfig as JColl
from neumann_tpu.engines.vector import VectorEngine as JEngine
from neumann_tpu.engines.vector import VectorEngineConfig as JConfig
from neumann_tpu.parallel import make_mesh as jmake_mesh
from neumann_tpu.parallel import sharded_search as jss
from neumann_tpu.parallel.distributed import QueryPlan as JPlan
from neumann_tpu.parallel.distributed import ResultMerger as JMerger
from neumann_tpu.router import QueryResult as JResult
from neumann_tpu_torch.convert import ivf_state_from_jax
from neumann_tpu_torch.engines.unified import UnifiedEngine as TUnified
from neumann_tpu_torch.engines.vector import FilterCondition as TFilter
from neumann_tpu_torch.engines.vector import VectorCollectionConfig as TColl
from neumann_tpu_torch.engines.vector import VectorEngine as TEngine
from neumann_tpu_torch.engines.vector import VectorEngineConfig as TConfig
from neumann_tpu_torch.ops.ivf import DeviceIVFInt8
from neumann_tpu_torch.parallel import mesh as tmesh
from neumann_tpu_torch.parallel import sharded_search as tss
from neumann_tpu_torch.parallel.distributed import QueryPlan as TPlan
from neumann_tpu_torch.parallel.distributed import ResultMerger as TMerger
from neumann_tpu_torch.router import QueryResult as TResult
from neumann_tpu_torch.store.tensor_store import TensorStore

TOL = 1e-5
D = 32
LAYOUTS = ("consecutive", "interleaved")
METRICS = ("cosine", "dot", "euclidean", "manhattan", "angular", "geodesic",
           "composite", "weighted_jaccard", "jaccard", "overlap")


def _dup(n_vec, copies, layout, seed=0, d=D, n_q=8):
    """Rows: ``n_vec`` random vectors ``copies`` times each, copies
    consecutive (row i holds vector i // copies) or interleaved (vector
    i % n_vec); queries near the first ``n_q`` vectors."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n_vec, d)).astype(np.float32)
    rows = (np.repeat(base, copies, axis=0) if layout == "consecutive"
            else np.tile(base, (copies, 1)))
    q = (base[:n_q] + 0.05 * rng.standard_normal((n_q, d))
         ).astype(np.float32)
    return rows, q


def _key(i):
    return f"k{i:05d}"


def _engines(rows, collections=(), **cfg):
    """A JAX and a port engine holding ``rows`` (metadata cat = i % 16)
    in the default corpus, or in each named (name, quantization)
    collection."""
    je = JEngine(config=JConfig(mesh_auto=False, **cfg))
    te = TEngine(config=TConfig(**cfg), device="cpu")
    for eng, coll in ((je, JColl), (te, TColl)):
        for name, quant in collections:
            eng.create_collection(name, coll(dimension=rows.shape[1],
                                             quantization=quant))
        with eng.bulk_ingest():
            for i, v in enumerate(rows):
                meta = {"cat": i % 16}
                if collections:
                    for name, _ in collections:
                        eng.store_in_collection(name, _key(i), v, meta)
                else:
                    eng.store_embedding(_key(i), v, meta)
    return je, te


def _same(got, want, metric="cosine"):
    """JAX's keys in JAX's order, scores within TOL."""
    assert [h.key for h in got] == [h.key for h in want]
    s_g = np.array([h.score for h in got], np.float64)
    s_w = np.array([h.score for h in want], np.float64)
    if metric == "euclidean":
        # 1 / (1 + d) of a near-zero distance: compare squared distances
        s_g, s_w = np.square(1 / s_g - 1), np.square(1 / s_w - 1)
        np.testing.assert_allclose(s_g, s_w, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(s_g, s_w, rtol=0, atol=TOL)


@pytest.fixture
def pooled_env(monkeypatch):
    monkeypatch.setenv("NEUMANN_POOLED_MIN_ROWS", "1024")
    monkeypatch.setenv("NEUMANN_POOLED_MIN_POOLS", "64")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("metric", METRICS)
def test_exact_scan_every_metric(layout, metric):
    """64 rows (16 vectors x 4): TOP 6 takes one vector's four copies
    and two of the next one's four, a tie across the k-th place; for
    jaccard and overlap every dense row scores alike."""
    rows, q = _dup(16, 4, layout)
    je, te = _engines(rows)
    for qv in q:
        _same(te.search_similar_with_metric(qv, 6, metric),
              je.search_similar_with_metric(qv, 6, metric), metric)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_batched_and_filtered(layout):
    rows, q = _dup(32, 8, layout, seed=1)
    je, te = _engines(rows)
    for got, want in zip(te.batch_search(q, 6), je.batch_search(q, 6)):
        _same(got, want)
    for metric in ("cosine", "euclidean"):
        for qv in q:
            got = te.search_similar_filtered(qv, 6, TFilter.eq("cat", 3),
                                             metric)
            want = je.search_similar_filtered(qv, 6, JFilter.eq("cat", 3),
                                              metric)
            assert all(int(h.key[1:]) % 16 == 3 for h in got)
            _same(got, want, metric)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_paginated_pages_are_disjoint(layout):
    """Pages of 3 at offsets 0-15 over 8 copies a vector: JAX's pages,
    disjoint, together the top-18."""
    rows, q = _dup(16, 8, layout, seed=2)
    je, te = _engines(rows)
    for qv in q[:4]:
        pages = []
        for off in range(0, 18, 3):
            got = te.search_similar_paginated(qv, 3, off)
            _same(got, je.search_similar_paginated(qv, 3, off))
            pages += [h.key for h in got]
        assert len(set(pages)) == len(pages)
        assert pages == [h.key for h in te.search_similar(qv, 18)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_collections_scan_and_pooled_routes(layout, quant, pooled_env):
    """4,096 rows (512 vectors x 8) in a collection: cosine takes the
    pooled scan (f32 or int8, pool 8) and its rerank, dot and euclidean
    the exact or int8 scan; a filter takes the masked routes."""
    rows, q = _dup(512, 8, layout, seed=3)
    je, te = _engines(rows, collections=(("c", quant),))
    assert te.search_route("col/c", D, 10, "cosine", None, quant)["route"] \
        == ("int8_pooled" if quant == "int8" else "f32_pooled")
    for metric in ("cosine", "dot", "euclidean"):
        for qv in q:
            _same(te.search_in_collection("c", qv, 10, metric),
                  je.search_in_collection("c", qv, 10, metric), metric)
            _same(te.search_filtered_in_collection(
                      "c", qv, 10, TFilter.eq("cat", 3), metric),
                  je.search_filtered_in_collection(
                      "c", qv, 10, JFilter.eq("cat", 3), metric), metric)
    for got, want in zip(te.batch_search_ns(q, 10, ns="col/c"),
                         je.batch_search_ns(q, 10, ns="col/c")):
        _same(got, want)


def test_auto_ivf_single_and_batched():
    """6,000 rows (1,500 vectors x 4) over a 2,000-row auto threshold:
    the port searches JAX's index (its state carried over) alone and in
    a batch of 16."""
    rows, _ = _dup(1500, 4, "interleaved", seed=4)
    cfg = dict(ivf_auto_threshold=2_000, ivf_auto_clusters=16,
               ivf_auto_nprobe=16, ivf_auto_max_batch=8)
    je, te = _engines(rows, **cfg)
    q = rows[[0, 7, 100, 1499]] + 0.01
    je.search_similar(q[0], 3)              # builds JAX's index
    jcorpus = je._corpora[""][D]
    tcorpus = te._corpora[""][D]
    tcorpus.slab.watch("auto_ivf")
    tcorpus._auto_ivf = DeviceIVFInt8.from_state(
        ivf_state_from_jax(jcorpus._auto_ivf), "cpu")
    assert te.search_route("", D, 10, "cosine", None, "none")["route"] \
        == "auto_ivf"
    for qv in q:
        _same(te.search_similar(qv, 10), je.search_similar(qv, 10))
    qb = np.repeat(q, 4, axis=0)
    for got, want in zip(te.batch_search(qb, 10), je.batch_search(qb, 10)):
        _same(got, want)


def test_entity_find_route():
    """FIND's similarity step: entities carrying duplicated embeddings."""
    rows, q = _dup(8, 4, "interleaved", seed=5)
    ju = JUnified()
    tstore = TensorStore()
    tu = TUnified(tstore, vector=TEngine(tstore, device="cpu"))
    for u in (ju, tu):
        for i, v in enumerate(rows):
            u.create_entity(_key(i), {"n": i}, embedding=v)
    for qv in q:
        _same(tu.find_similar_entities(qv, 6), ju.find_similar_entities(qv, 6))


@pytest.mark.parametrize("quantized", [False, True])
def test_sharded_corpus_merge(quantized, monkeypatch):
    """Four shards of 512 rows, 128 vectors 16 times over (interleaved,
    so every tie spans the four shards): ids equal, the lower first. The
    JAX mesh is four of tests/conftest.py's virtual CPU devices, the
    port's four of ``NEUMANN_MESH_DEVICES``."""
    monkeypatch.setenv("NEUMANN_MESH_DEVICES", "8")
    rows, q = _dup(128, 16, "interleaved", seed=6)
    j = jss.ShardedCorpus(jmake_mesh(4), D, quantized=quantized)
    t = tss.ShardedCorpus(tmesh.make_mesh(4, device="cpu"), D,
                          quantized=quantized)
    j.load(rows)
    t.load(rows)
    js, ji = j.search(q, 20)
    ts, ti = t.search(q, 20)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)


def test_planner_top_k_merge():
    """The planner's top-k merge over three shards' tied hits."""
    hits = [[{"key": f"s{s}k{i}", "score": float(1 - (i // 2) / 10)}
             for i in range(6)] for s in range(3)]
    want = JMerger.merge(JPlan(kind="scatter_gather", merge="top_k", k=7),
                         [JResult("similar", results=h) for h in hits])
    got = TMerger.merge(TPlan(kind="scatter_gather", merge="top_k", k=7),
                        [TResult("similar", results=h) for h in hits])
    assert got.results == want.results
    assert [h["key"] for h in got.results] == [
        "s0k0", "s0k1", "s1k0", "s1k1", "s2k0", "s2k1", "s0k2"]


@pytest.mark.parametrize("sort_max", [0, 1 << 21])
def test_selection_helpers_match_lax_top_k(sort_max, monkeypatch):
    """``_topk_stable`` on f32 scores full of ties (and NaNs of both
    signs, infinities, signed zeros) and ``_int_topk_stable`` on int32
    give ``lax.top_k``'s values and indices, by either way (``_SORT_MAX``
    0: the int64 keys; else the stable sort); so does the exact scan,
    flat and in blocks of 16 rows, on integer rows copied 4 times."""
    import jax
    import torch

    from neumann_tpu.ops.scan import topk_scan as jax_topk_scan
    from neumann_tpu_torch.ops import scan

    monkeypatch.setattr(scan, "_SORT_MAX", sort_max)
    rng = np.random.default_rng(7)
    specials = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0],
                        np.float32)
    for _ in range(40):
        q, n = int(rng.integers(1, 5)), int(rng.integers(1, 300))
        k = int(rng.integers(1, n + 1))
        s = rng.integers(-3, 4, (q, n)).astype(np.float32)
        s.flat[rng.integers(0, s.size, 3)] = rng.choice(specials, 3)
        want_v, want_i = (np.asarray(a) for a in jax.lax.top_k(s, k))
        got_v, got_i = scan._topk_stable(torch.from_numpy(s), k)
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                      want_v.view(np.int32))
        b = rng.integers(-4, 4, (q, n)).astype(np.int32)
        want_v, want_i = (np.asarray(a) for a in jax.lax.top_k(b, k))
        got_v, got_i = scan._int_topk_stable(torch.from_numpy(b), k)
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_array_equal(got_v.numpy(), want_v)
        # the exact scan, flat and blockwise, on rows copied 4 times
        c = np.tile(rng.integers(-2, 3, (n // 4 + 1, 8)), (4, 1)
                    ).astype(np.float32)
        qv = rng.integers(-2, 3, (q, 8)).astype(np.float32)
        kk = min(k, len(c))
        want_v, want_i = (np.asarray(a) for a in jax_topk_scan(
            c, qv, kk, "dot"))
        for block_rows in (len(c), 16):
            got_v, got_i = scan.topk_scan(torch.from_numpy(c),
                                          torch.from_numpy(qv), kk, "dot",
                                          block_rows=block_rows)
            np.testing.assert_array_equal(got_i.numpy(), want_i)
            np.testing.assert_array_equal(got_v.numpy(), want_v)

"""The port's router + vector engine side by side with the JAX package's,
on the auto-IVF setup of tests/test_auto_ivf.py (12,000 x 64 clustered
rows, threshold 5,000, 48 clusters, nprobe 12, max batch 8).

The JAX router builds its auto index on the first SIMILAR; the port is
then given the SAME index (convert.ivf_state_from_jax ->
DeviceIVFInt8.from_state), so both search one layout and their results
compare directly: scores within 1e-5, keys equal wherever scores differ
by more than that, and in the same order among scores exactly equal in
both packages (apart from every other score). A second port router builds its own index through
the same statements (the port's k-means draws from a torch.Generator,
so that layout is compared by recall, not bit for bit).

On this setup the slab capacity (16,384) gives 384-row windows — 3
pools, not a power of two — so a batch of 40 runs the non-fast batched
variant in both packages; both are held to the exact oracle.
"""

import os

import numpy as np
import pytest

from neumann_tpu.engines.vector import VectorEngineConfig as JConfig
from neumann_tpu.router import QueryRouter as JRouter
from neumann_tpu_torch.convert import ivf_state_from_jax
from neumann_tpu_torch.engines.vector import VectorEngine
from neumann_tpu_torch.engines.vector import VectorEngineConfig as TConfig
from neumann_tpu_torch.ops.ivf import DeviceIVFInt8
from neumann_tpu_torch.router import QueryRouter as TRouter
from neumann_tpu_torch.utils.errors import VectorError
from tests.test_torch_relational import routers as fresh_routers
from tests.test_torch_relational import run_both

TOL = 1e-5
N, D = 12_000, 64
IVF_CFG = dict(ivf_auto_threshold=5_000, ivf_auto_clusters=48,
               ivf_auto_nprobe=12, ivf_auto_max_batch=8)


def _clustered(n, d, k_clusters, rng):
    cents = rng.standard_normal((k_clusters, d)).astype(np.float32) * 3
    assign = rng.integers(0, k_clusters, n)
    v = cents[assign] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    return v.astype(np.float32)


def _vec(v):
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


def _load(router, vecs):
    eng = router.vector
    with eng.bulk_ingest():
        for i in range(len(vecs)):
            eng.store_embedding(f"k{i}", vecs[i], {"grp": i % 4})


@pytest.fixture(scope="module")
def routers():
    vecs = _clustered(N, D, 48, np.random.default_rng(42))
    jr = JRouter()
    jr.vector.config = JConfig(mesh_auto=False, **IVF_CFG)
    tr = TRouter(device="cpu")
    tr.vector.config = TConfig(**IVF_CFG)
    _load(jr, vecs)
    _load(tr, vecs)
    # the JAX router builds its index on the first SIMILAR; the port
    # searches the same layout from then on
    jr.execute(f"SIMILAR {_vec(vecs[0])} TOP 3")
    jcorpus = jr.vector._corpora[""][D]
    tcorpus = tr.vector._corpora[""][D]
    tcorpus.slab.watch("auto_ivf")
    tcorpus._auto_ivf = DeviceIVFInt8.from_state(
        ivf_state_from_jax(jcorpus._auto_ivf), "cpu")
    return jr, tr, vecs


def _oracle(vecs, q, k):
    vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    return np.argsort(-(vn @ (q / np.linalg.norm(q))))[:k]


def _assert_hits_close(got, want, angular=False):
    """angular: scores are -arccos(cos), whose slope is unbounded at
    cos = 1 (one f32 ulp of cosine there is 3e-4 of angle), so the
    cosines are compared instead."""
    assert len(got) == len(want)
    s_g = np.array([h["score"] for h in got])
    s_w = np.array([h["score"] for h in want])
    if angular:
        s_g, s_w = np.cos(s_g), np.cos(s_w)
    np.testing.assert_allclose(s_g, s_w, rtol=0, atol=TOL)
    for j, h in enumerate(want):
        near = np.abs(s_w - s_w[j]) <= TOL
        tied = (s_w == s_w[j]) & (s_g == s_g[j])
        if (near == tied).all() and (near.sum() == 1 or not near[-1]):
            assert got[j]["key"] == h["key"]


def test_single_similar_matches_jax(routers):
    jr, tr, vecs = routers
    for qi in (3, 1000, 5000, 11999):
        stmt = f"SIMILAR {_vec(vecs[qi])} TOP 10"
        got, want = tr.execute(stmt), jr.execute(stmt)
        assert got.kind == want.kind == "similar"
        assert got.results[0]["key"] == f"k{qi}"
        _assert_hits_close(got.results, want.results)
    # by key, and with METRIC angular (cosine order, -arccos scores)
    for stmt in ("SIMILAR 'k42' TOP 5", "SIMILAR 'k42' TOP 5 METRIC angular"):
        _assert_hits_close(tr.execute(stmt).results,
                           jr.execute(stmt).results,
                           angular="angular" in stmt)


def test_batch_of_40_recall(routers):
    jr, tr, vecs = routers
    rng = np.random.default_rng(7)
    qs = vecs[rng.choice(N, 40)] + 0.05 * rng.standard_normal(
        (40, D)).astype(np.float32)
    got = tr.vector.batch_search(qs, 10)
    want = jr.vector.batch_search(qs, 10)
    assert len(got) == len(want) == 40
    rec_t, rec_j = [], []
    for r in range(40):
        truth = {f"k{i}" for i in _oracle(vecs, qs[r], 10)}
        rec_t.append(len(truth & {h.key for h in got[r]}) / 10)
        rec_j.append(len(truth & {h.key for h in want[r]}) / 10)
    assert np.mean(rec_t) >= 0.95 and np.mean(rec_t) >= np.mean(rec_j) - 0.02


def test_where_takes_exact_route(routers):
    jr, tr, vecs = routers
    stmt = f"SIMILAR {_vec(vecs[10])} TOP 8 WHERE grp = 2"
    got, want = tr.execute(stmt), jr.execute(stmt)
    assert got.results and all(int(h["key"][1:]) % 4 == 2
                               for h in got.results)
    _assert_hits_close(got.results, want.results)
    exact = [f"k{i}" for i in _oracle(vecs, vecs[10], N) if i % 4 == 2][:8]
    assert [h["key"] for h in got.results] == exact


def test_storage_statements_match_jax(routers):
    jr, tr, _ = routers
    for stmt in ("COUNT EMBEDDINGS", "EMBED GET 'k17'", "SHOW EMBEDDINGS LIMIT 3"):
        got, want = tr.execute(stmt), jr.execute(stmt)
        assert (got.kind, got.count) == (want.kind, want.count)
        if got.kind == "value":
            np.testing.assert_allclose(got.value, want.value)
    assert tr.execute("EMBED GET 'nope'").message == \
        jr.execute("EMBED GET 'nope'").message


def test_unported_statements_raise(routers, tmp_path):
    """The extended modules' and the chain's statements and ``init_*``
    answer as the JAX router's do."""
    jr, tr, _ = routers
    stmts = ("VAULT GET 'x'", "CHECKPOINTS", "CACHE STATS",
             "EXPLAIN SELECT * FROM t", "BLOB STATS", "CHAIN HEIGHT")
    mj, mt = fresh_routers()
    for stmt in stmts:                      # before init_*: errors alike
        run_both(mj, mt, stmt, fields=("kind", "rows", "message"))
    for r, name in ((mj, "jax"), (mt, "port")):
        r.init_checkpoints(str(tmp_path / name))
        r.init_vault("pw")
        r.init_cache()
        r.init_blob()
        r.init_chain()
    for stmt in stmts:
        run_both(mj, mt, stmt, fields=("kind", "rows", "message", "count"))
    # pq and tt storage are ported: they answer as the JAX router does
    for quant in ("pq", "tt"):
        got = []
        for r in (jr, tr):
            r.execute(f"CREATE COLLECTION u_{quant} DIM {D} QUANTIZATION "
                      f"{quant}")
            r.execute(f"EMBED STORE 'a' [{', '.join(['1.0'] * D)}] IN "
                      f"u_{quant}")
            got.append(r.execute(f"SIMILAR 'a' TOP 3 IN u_{quant}").results)
            r.execute(f"DROP COLLECTION u_{quant}")
        assert [h["key"] for h in got[1]] == [h["key"] for h in got[0]]
        _assert_hits_close(got[1], got[0])


def test_config_takes_the_jax_fields_and_presets():
    """Every field of the JAX package's config constructs; on one card
    the mesh fields change nothing and every selector cuts exactly; the
    scan limits, which the JAX engine accepts and never reads, are
    accepted and not enforced as there (tests/test_torch_pq_select.py
    holds a router on them to the JAX router's hits); the ANN index APIs
    raise as the JAX engine's do when no index is built."""
    fields = dict(mesh_auto=False, mesh_threshold=1024,
                  pooled_selector="approx:0.95")
    assert TConfig(**fields) == TConfig(**fields)
    VectorEngine(config=TConfig(**fields), device="cpu")
    assert TConfig.high_throughput() == TConfig()
    low = TConfig.low_memory()
    assert (low.max_keys_per_scan, low.search_timeout_s) == (10_000, 30.0)
    assert low == TConfig(**{k: getattr(JConfig.low_memory(), k)
                             for k in TConfig.__dataclass_fields__})
    for cfg in (low, TConfig(search_timeout_s=1.0)):
        assert VectorEngine(config=cfg, device="cpu").config is cfg
    # the ANN index APIs are ported: with no index built they raise the
    # JAX engine's VectorError
    from neumann_tpu.engines.vector import VectorEngine as JEngine
    from neumann_tpu.utils.errors import VectorError as JVectorError

    with pytest.raises(JVectorError, match="no index built"):
        JEngine().search_with_hnsw_ef([1.0], 1, 16)
    with pytest.raises(VectorError, match="no index built"):
        VectorEngine(device="cpu").search_with_hnsw_ef([1.0], 1, 16)


@pytest.fixture(scope="module")
def nonfinite():
    """4,096 x 768 rows through both engines; row 5 is +inf everywhere,
    row 9 -inf."""
    from neumann_tpu.engines.vector import VectorEngine as JEngine

    v = np.random.default_rng(3).standard_normal((4096, 768)).astype(
        np.float32)
    v[5], v[9] = np.inf, -np.inf
    je = JEngine(config=JConfig(mesh_auto=False))
    te = VectorEngine(device="cpu")
    for eng in (je, te):
        with eng.bulk_ingest():
            for i in range(len(v)):
                eng.store_embedding(f"k{i}", v[i])
    return je, te


def test_nan_query_returns_the_jax_hits(nonfinite):
    """A NaN query scores NaN on every row: both packages return k hits
    (the port once stopped at the first non-finite score)."""
    je, te = nonfinite
    q = np.full(768, np.nan, np.float32)
    want, got = je.search_similar(q, 3), te.search_similar(q, 3)
    assert len(got) == len(want) == 3
    assert [h.key for h in got] == [h.key for h in want]
    assert all(np.isnan(h.score) for h in got)


@pytest.mark.parametrize("metric", ["dot", "cosine", "euclidean",
                                    "manhattan"])
@pytest.mark.parametrize("sign", [1, -1])
def test_rows_scoring_inf_or_nan_match_jax(nonfinite, metric, sign):
    """Rows of +-inf score +-inf (dot), NaN (cosine: inf / inf;
    euclidean: inf - inf) or -inf (manhattan) against a query of one
    sign. The hits, in order, are the JAX package's: +inf and positive
    NaN rank first, a NaN with the sign bit set last, as in lax.top_k."""
    je, te = nonfinite
    q = sign * np.abs(np.random.default_rng(4).standard_normal(768)
                      ).astype(np.float32)
    want = je.search_similar_with_metric(q, 3, metric)
    got = te.search_similar_with_metric(q, 3, metric)
    assert [h.key for h in got] == [h.key for h in want]
    for g, w in zip(got, want):
        assert (np.isnan(g.score) and np.isnan(w.score)) or \
            g.score == pytest.approx(w.score, rel=1e-5)
    if metric == "dot":
        assert got[0].key == ("k5" if sign > 0 else "k9")
        assert got[0].score == np.inf


def test_port_builds_its_own_index():
    vecs = _clustered(N, D, 48, np.random.default_rng(42))
    tr = TRouter(device="cpu")
    tr.vector.config = TConfig(**IVF_CFG)
    tr.execute("EMBED BATCH [" + ", ".join(
        f"('k{i}', {_vec(vecs[i])})" for i in range(3)) + "]")
    tr.vector.batch_store_embeddings(
        [(f"k{i}", vecs[i]) for i in range(3, N)])
    hits = tr.execute(f"SIMILAR {_vec(vecs[7])} TOP 10").results
    corpus = tr.vector._corpora[""][D]
    assert isinstance(corpus._auto_ivf, DeviceIVFInt8)
    assert hits[0]["key"] == "k7" and hits[0]["score"] > 0.98
    recs = []
    for qi in (3, 1000, 5000, 11999):
        truth = {f"k{i}" for i in _oracle(vecs, vecs[qi], 10)}
        got = {h.key for h in tr.vector.search_similar(vecs[qi], 10)}
        recs.append(len(truth & got) / 10)
    assert np.mean(recs) >= 0.9, recs


def test_delta_rescan_after_embed_store(routers):
    """A row re-embedded after the build is served at its current value
    (exact rescan merged over the stale-masked index hits)."""
    jr, tr, vecs = routers
    new = -vecs[5] + 0.01
    for r in (jr, tr):
        r.execute(f"EMBED STORE 'k5' {_vec(new)}")
    stmt = f"SIMILAR {_vec(new)} TOP 5"
    got, want = tr.execute(stmt), jr.execute(stmt)
    assert got.results[0]["key"] == "k5" and got.results[0]["score"] > 0.999
    _assert_hits_close(got.results, want.results)
    # and the old vector no longer finds k5 first
    old = tr.execute(f"SIMILAR {_vec(vecs[5])} TOP 5").results
    assert "k5" not in [h["key"] for h in old]
    # a deleted key disappears from results
    for r in (jr, tr):
        r.execute("EMBED DELETE 'k5'")
    assert "k5" not in [h["key"] for h in tr.execute(stmt).results]


def test_ingest_matrix_adopts_only_identity_rows():
    """copy=False may adopt the caller's buffer only when the keys map
    to rows 0..N-1 in order. Here freed rows are reused as 0, 2, 1, 3..:
    the endpoints look like an identity (the JAX package's check) but
    row 1 belongs to key 'm2'."""
    rng = np.random.default_rng(3)
    eng = VectorEngine(device="cpu")
    for i in range(3):
        eng.store_embedding(f"old{i}", rng.standard_normal(128))
    for key in ("old1", "old2", "old0"):     # free list -> pops 0, 2, 1
        eng.delete_embedding(key)
    n = 1024
    mat = rng.standard_normal((n, 128)).astype(np.float32)
    keys = [f"m{i}" for i in range(n)]
    eng.ingest_matrix(keys, mat, copy=False)
    corpus = eng._corpora[""][128]
    rows = np.array([corpus.index.lookup(k) for k in keys])
    assert rows[0] == 0 and rows[-1] == n - 1          # passes endpoints
    assert not np.array_equal(rows, np.arange(n))      # not the identity
    assert corpus.slab._host is not mat                # so: copied
    for i in (0, 1, 2, 500, n - 1):
        np.testing.assert_array_equal(corpus.slab.get_row(rows[i]), mat[i])
    hits = eng.search_similar(mat[1], 1)
    assert hits[0].key == "m1"
    # the identity case still adopts zero-copy
    eng2 = VectorEngine(device="cpu")
    eng2.ingest_matrix(keys, mat, copy=False)
    assert eng2._corpora[""][128].slab._host is mat


def test_large_ingest_freezes_gc(monkeypatch):
    """A bulk ingest leaves millions of long-lived store objects; the
    port freezes them out of the cyclic collector (one full collection
    over them was a 2 s query pause at 4.19M rows)."""
    import gc

    from neumann_tpu_torch.engines import vector as tv

    monkeypatch.setattr(tv, "_GC_FREEZE_MIN_ROWS", 16)
    before = gc.get_freeze_count()
    try:
        eng = VectorEngine(device="cpu")
        eng.ingest_matrix([f"g{i}" for i in range(8)],
                          np.ones((8, 4), np.float32))
        assert gc.get_freeze_count() == before
        eng.ingest_matrix([f"h{i}" for i in range(16)],
                          np.ones((16, 4), np.float32))
        assert gc.get_freeze_count() > before
        assert eng.count_embeddings() == 24
    finally:
        gc.unfreeze()


def test_large_bulk_flush_freezes_gc(monkeypatch):
    """A bulk_ingest flush of many per-row puts freezes the collector
    too (after a 1M-row flush, the young collections of the next queries
    took 30-48 ms without it)."""
    import gc

    from neumann_tpu_torch.engines import vector as tv

    monkeypatch.setattr(tv, "_GC_FREEZE_MIN_ROWS", 16)
    before = gc.get_freeze_count()
    try:
        eng = VectorEngine(device="cpu")
        with eng.bulk_ingest():
            for i in range(8):
                eng.store_embedding(f"g{i}", np.ones(4, np.float32))
        assert gc.get_freeze_count() == before
        with eng.bulk_ingest():
            for i in range(16):
                eng.store_embedding(f"h{i}", np.ones(4, np.float32),
                                    {"cat": i})
        assert gc.get_freeze_count() > before
        assert eng.count_embeddings() == 24
    finally:
        gc.unfreeze()


def test_chip_smoke_shell_text_tolerance():
    """Phase 13 compares the shell's text on the card and the CPU: equal
    but for numerals within a relative SHELL_RTOL, a shorter numeral's
    padding included; a changed word or row is never within it."""
    import chip_smoke

    card = ("+----+----------+\n| id | rank     |\n+----+----------+\n"
            "| 1  | 0.52087  |\n| 2  | 0.281551 |\n+----+----------+")
    cpu = card.replace("0.52087  ", "0.520869 ")
    assert chip_smoke.text_rel_diff(card, card) == 0
    assert 0 < chip_smoke.text_rel_diff(card, cpu) < chip_smoke.SHELL_RTOL
    assert chip_smoke.text_rel_diff(card, cpu.replace("0.28", "0.29")) > \
        chip_smoke.SHELL_RTOL
    assert chip_smoke.text_rel_diff(card, cpu.replace("rank", "rang")) == \
        float("inf")
    assert chip_smoke.text_rel_diff(card, cpu + "\n| 3  | 0.1 |") == \
        float("inf")


def test_chip_smoke_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's phases 1 and 3-15 (the native parse check, corpus,
    counted auto-IVF path, recall against the exact scan, delta rescan;
    then the pooled, int8 and binary routes, the 3,072-d binary
    collection and the hybrid query with their checks; the served
    auto-IVF and brute-force routes over HTTP and over gRPC; the shell;
    the pq and tt
    collections and the ANN index APIs; the chain, the consensus
    classification and the clusters of phase 18; SIMILAR scattered over
    three shard-server processes, phase 20; the same rows on a mesh of
    four logical devices, phase 21; equal scores on the pooled routes,
    phase 22) at a toy size
    on the CPU; the kernel phase, the launch checks and the profiles need
    the card. 8 mixture centres
    instead of 4,096 so that 20,480 rows are clustered like the real
    corpus (each row's neighbours come from its own centre); the pooled
    gate is lowered so that 4,096 rows take the pooled routes."""
    import types

    import torch

    import chip_smoke

    monkeypatch.setattr(chip_smoke, "N_CENTRES", 8)
    monkeypatch.setattr(chip_smoke, "HUB_DEGREE", 40)
    monkeypatch.setattr(chip_smoke, "HYBRID_ROWS", 8192)
    monkeypatch.setattr(chip_smoke, "HYBRID_EDGES", 32_768)
    monkeypatch.setattr(chip_smoke, "N_SERVED", 256)
    # phases 14-15 at a toy size: the legacy IVF index and IVFIndex with
    # 16 clusters, HNSW graphs of a few hundred rows, 1,024 tt rows
    monkeypatch.setattr(chip_smoke, "IVF_CLUSTERS", 16)
    monkeypatch.setattr(chip_smoke, "IVF_INDEX_CLUSTERS", 16)
    monkeypatch.setattr(chip_smoke, "TT_ROWS", 1024)
    monkeypatch.setattr(chip_smoke, "HNSW_ROWS", 512)
    monkeypatch.setattr(chip_smoke, "HNSW_QUANT_ROWS", 512)
    monkeypatch.setattr(chip_smoke, "HNSW_BINARY_ROWS", 256)
    # phase 16 at a toy size: collections of 2,048 rows, a 1 MiB blob,
    # 256 cache prompts
    monkeypatch.setattr(chip_smoke, "ROLLBACK_SUB_ROWS", 2048)
    monkeypatch.setattr(chip_smoke, "BLOB_BYTES", 1 << 20)
    monkeypatch.setattr(chip_smoke, "CACHE_PROMPTS", 256)
    monkeypatch.setattr(chip_smoke, "CACHE_MIX", 100)
    # phase 17's TOP 65 and delta batches: 256 queries
    monkeypatch.setattr(chip_smoke, "PHASE17_BATCH", 256)
    # phase 18: 256 chain keys, 512 deltas, clusters of 32 rows
    monkeypatch.setattr(chip_smoke, "N_CHAIN_KEYS", 256)
    monkeypatch.setattr(chip_smoke, "N_DELTAS", 512)
    monkeypatch.setattr(chip_smoke, "CLUSTER_ROWS", 32)
    # phase 21's batches: 256 queries
    monkeypatch.setattr(chip_smoke, "MESH_BATCH", 256)
    monkeypatch.setenv("NEUMANN_POOLED_MIN_ROWS", "1024")
    monkeypatch.setenv("NEUMANN_POOLED_MIN_POOLS", "64")
    cfg = TConfig(ivf_auto_threshold=10_000, ivf_auto_clusters=16,
                  ivf_auto_nprobe=8)
    rep = chip_smoke.run(
        types.SimpleNamespace(seed=0, rows=20_480, pooled_rows=4096,
                              wide_rows=2048),
        torch.device("cpu"), config=cfg, on_card=False)
    assert rep["recall_single"] >= 0.95 and rep["recall_batch"] >= 0.95
    # phase 17: the TOP 65 batch on the non-fast route, the top-1 route,
    # the delta plane before and after compact
    assert rep["top65_recall10"] >= 0.95 and rep["top1_route_recall10"] >= 0.95
    assert rep["top65_steps"]["live_windows"] > 0
    assert rep["delta_rows_added"] == 2048 and rep["delta_rows_deleted"] == 204
    assert rep["delta_added_first"] == 1.0
    assert min(rep["delta_before_recall"], rep["delta_after_recall"]) >= 0.95
    assert len(rep["single_ms"]) == chip_smoke.N_SINGLE - 1
    assert "kernels" not in rep and "profile" not in rep
    for key in ("pooled_recall_single", "pooled_recall_batch",
                "pooled_recall_filtered", "int8_recall_single",
                "int8_recall_batch"):
        assert rep[key] >= 0.95, key
    assert rep["int8_euclid_mismatches"] == 0
    assert len(rep["binary_single_ms"]) == chip_smoke.N_SINGLE - 1
    assert rep["binary_mismatches"] == 0
    assert rep["wide_mismatches"] == 0
    assert len(rep["wide_single_ms"]) == chip_smoke.N_WIDE_SINGLE - 1
    assert set(rep["launches"]) == set(chip_smoke.KERNELS)
    # phases 14-15: pq hits equal the plain ADC's, tt hits the exact scan
    # of the reconstruction, IVF hits an exact scan of the probed lists;
    # saved indexes load with the same hits
    assert rep["pq_mismatches"] == 0 and rep["tt_mismatches"] == 0
    assert rep["tt_sample_max_rel_err"] <= chip_smoke.TT_RTOL
    assert rep["pq_subspaces"] == chip_smoke.PQ_M
    assert rep["ivf_nprobe32_recall"] >= rep["ivf_nprobe8_recall"] > 0.5
    assert rep["hnsw_dense_recall"] > 0.5 and rep["saved_index_ok"]
    # the launch counts are kept per route; on the CPU nothing launches
    assert rep["launches_pq"]["pq_adc"] == rep["launches_ann"]["pq_adc"] == 0
    # phase 11 at 8,192 entities: FIND's tier mask opens the pooled gate
    # (pool 16, one tier-3 row in each), the hubs' masks do not
    assert rep["hybrid_find_pool"] == 16
    assert rep["hybrid_find_recall"] >= 0.95
    assert len(rep["hybrid_ms"]) == chip_smoke.N_HYBRID - 1
    assert rep["hybrid_bfs_reached"] > 1
    assert rep["hybrid_pagerank_max_rel_err"] <= chip_smoke.PAGERANK_RTOL
    # phase 1: the native parse; phases 12a-12b: served over HTTP with
    # batching on; phase 13: the shell on two routers
    assert 0 < rep["parse_native_ms"] < rep["parse_python_ms"]
    assert rep["warmup_calls"] == 5 * 2
    for part in ("ivf", "pooled", "int8"):
        assert rep[f"served_{part}_recall"] >= 0.95, part
    for part in ("ivf", "pooled", "int8", "binary"):
        assert rep[f"served_{part}_mean_cohort"] > 1, part
    assert rep["served_binary_mismatches"] == 0
    assert rep["served_filtered_recall"] >= 0.95
    assert rep["served_in_filter_ok"] and rep["points_query_mismatches"] == 0
    # phase 19: the same routers served over gRPC: Execute, the Points
    # QueryBatch / QueryStream / filtered queries, gRPC-web; Health
    # names the device, the native points codec serves
    for part in ("ivf", "pooled"):
        assert rep[f"grpc_{part}_recall"] >= 0.95, part
        assert rep[f"grpc_{part}_mean_cohort"] > 1, part
    assert rep["grpc_stream_recall"] >= 0.95
    assert rep["grpc_filtered_recall"] >= 0.95
    assert rep["grpc_ivf_query_batch_mismatches"] == 0
    assert rep["grpc_bits_mismatches"] == rep["grpc_web_mismatches"] == 0
    assert rep["grpc_health"]["device"] == "cpu"
    assert rep["points_codec_native"]
    assert rep["grpc_ivf_server_requests"] >= chip_smoke.N_SERVED
    # phase 22: 4,096 rows x 4 take the pooled f32 and int8 routes, every
    # single top-10 holds copies, the store of copies in a row takes the
    # exact scan and meets ties across the 10th place, and every order is
    # the plain version's
    assert rep["ties_routes"] == {"default": "f32_pooled",
                                  "col/tq8": "int8_pooled",
                                  "run_euclidean": "exact"}
    assert rep["ties_lists_with_copies"] == 2 * chip_smoke.N_SINGLE
    assert rep["ties_run_straddles"] > 0
    assert rep["ties_mismatches"] == 0
    assert rep["shell_errors"] == 0 and rep["shell_max_rel_diff"] == 0
    assert rep["shell_doctor_devices"] == ["[OK ] devices         1 x cpu"]
    # phase 16: the rollback restores every route's hits and the events
    # table; EXPLAIN names each route's kernel; the blob comes back with
    # equal bytes; the query cache serves a repeat and not across a write
    assert rep["rollback_mismatches"] == 0
    assert rep["rollback_events_rows"] == chip_smoke.N_EVENTS
    assert rep["checkpoints_after"] == 3
    assert rep["explain_kernels"]["pooled"] == "f32_pooled_bits"
    assert rep["blob_checks"] == [True, "OK", "OK", True]
    assert rep["cache_entries"] == 256
    assert rep["cache_exact_hit_rate"] == 0.5
    assert rep["launches_rollback"]["f32_pooled_bits"] == 0
    # phase 18: ROLLBACK CHAIN restores the hits; the consensus codes
    # equal float64 off the thresholds, every class present; every
    # acknowledged row is read back first on each replica, after the
    # leader's SIGKILL too, through the int8 scan
    assert rep["chain_rollback_mismatches"] == 0
    assert rep["chain_views"]["verify"] == "chain OK"
    assert rep["consensus_mismatches"] == 0
    assert min(rep["consensus_class_counts"]) > 0
    assert rep["cluster_acked_rows"] == chip_smoke.CLUSTER_ROWS
    assert all(not p["lost"] and p["kernel"] == "int8_dot_scores"
               for p in rep["cluster_replicas"].values())
    assert rep["cluster_kill_acked_rows"] == chip_smoke.CLUSTER_ROWS
    assert all(r["lost"] == 0 and r["kernel"] == "int8_dot_scores"
               for r in rep["cluster_kill_reads"].values())
    assert len(rep["cluster_kill_reads"]) == 3
    # phase 20: B's rows on three shard-server processes; every merge is
    # the shards' own, nprobe 3 equals the full fan-out, COUNT adds up,
    # and after a SIGKILL the answers are the live shards' merge
    assert sum(rep["sharded_sizes"]) == rep["sharded_count"] == 4096
    assert rep["sharded_mismatches"] == 0
    assert rep["sharded_nprobe_all_mismatches"] == 0
    assert rep["sharded_degraded_mismatches"] == 0
    assert min(rep["sharded_recall"], rep["sharded_nprobe3_recall"],
               rep["sharded_served_recall"]) >= 0.95
    assert set(rep["sharded_launches"]) == {"s0", "s1", "s2"}
    assert rep["launches_sharded"]["f32_pooled_bits"] == 0
    # phase 21: the same rows on a mesh of four logical devices; the f32
    # placement is the exact scan, the merge the shards' own, re-embedded
    # keys first on both placements without a rebuild
    assert rep["mesh_shards"] == {"f32": 4, "int8": 4, "ivf": 4}
    assert rep["mesh_f32_mismatches"] == rep["mesh_merge_mismatches"] == 0
    assert rep["mesh_fresh_not_first"] == {"ivf": 0, "f32": 0}
    assert rep["mesh_ivf_batched_top1_mismatches"] == {
        "search_self": 0, "fast_plain": 0, "fast": 0, "non_fast": 0}
    assert min(rep["mesh_ivf_recall_own_single"],
               rep["mesh_ivf_recall_own_batch"]) >= 0.95
    assert min(rep["mesh_int8_recall_batch"], rep["mesh_euclid_recall"],
               rep["mesh_filtered_recall"]) >= 0.95
    assert rep["mesh_ivf_recall_batch"] >= 0.85
    assert rep["launches_mesh"]["int8_pooled_bits"] == 0
    assert "NEUMANN_MESH_DEVICES" not in os.environ

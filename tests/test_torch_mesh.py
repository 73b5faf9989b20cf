"""The port's mesh (``neumann_tpu_torch/parallel/mesh.py``,
``sharded_search.py`` and the vector engine's mesh route) against the
JAX package's, on the CPU.

The JAX tests get their mesh from eight virtual CPU devices
(``tests/conftest.py``); the port's twins get theirs from
``NEUMANN_MESH_DEVICES=8``, set for every test of this file. Twinned
(tests/torch_twins.py, both packages): the six mesh tests of
tests/test_parallel.py (the int8 oracle of the pooled-parity test is the
port's ``int8_topk_scan``), all of tests/test_mesh_engine.py, the two
``ShardedIVFCorpus`` tests of tests/test_distributed_search.py and
tests/test_coverage_gaps.py's ``test_make_mesh_shapes`` (the port twin
counts the port's mesh devices).

Then the same numpy inputs go to both packages:

* ``ShardedCorpus`` (``make_sharded_topk``) f32 and int8 under cosine,
  dot and euclidean on 2, 4 and 8 shards, rows copied across shard
  boundaries: ids equal (duplicates in ascending id order, as
  ``lax.top_k`` merges them), scores within 1e-5; a filter mask; a shard
  that is all padding; the merge equal to each shard's answer
  concatenated in shard order and cut by ``_topk_stable``;
* ``ShardedIVFCorpus.load`` at a size where both packages' k-means run
  the same numpy steps: ``buf``, ``row_ids`` and ``starts`` equal,
  ``rmult`` and ``cents`` within 1e-6;
* a JAX ``ShardedIVFCorpus`` and ``ShardedCorpus`` carried to the port
  by ``convert`` and searched alike: ``search`` (its bf16 first pass
  selects, the exact rerank orders: ids equal wherever scores are more
  than 1e-5 apart) and both ``search_batched`` forms (fast: the batched
  top-2 kernel's plain version);
* a JAX and a port engine through mutations on the mesh (re-embedded,
  added and deleted rows, the delta rescans), hits alike, and EXPLAIN
  naming the mesh route;
* a one-device mesh (no variable, a value of 1, one CUDA device) leaves
  the route off;
* the sharded IVF's recall@10 against the f32 scan, equal in both
  packages on a small layout and at cell M's (windows of 1,024, nprobe a
  quarter of a shard's windows).
"""

import functools

import numpy as np
import pytest
import torch

from neumann_tpu.engines.vector import VectorEngine as JEngine
from neumann_tpu.engines.vector import VectorEngineConfig as JConfig
from neumann_tpu.parallel import make_mesh as jmake_mesh
from neumann_tpu.parallel import sharded_search as jss
from neumann_tpu_torch import convert
from neumann_tpu_torch.engines.vector import VectorEngine as TEngine
from neumann_tpu_torch.engines.vector import VectorEngineConfig as TConfig
from neumann_tpu_torch.ops.scan import _topk_stable
from neumann_tpu_torch.parallel import mesh as tmesh
from neumann_tpu_torch.parallel import sharded_search as tss
from neumann_tpu_torch.router import QueryRouter as TRouter
from tests.test_torch_ivf_batched import _assert_search_close
from tests.torch_twins import twin_tests

TOL = 1e-5
# squared euclidean distances of 32-d Gaussian rows: a few ulps of
# |q|^2 + |x|^2, about 64
EUCLID_SQ_ATOL = 1e-4
# ... and of the engine test's clustered 24-d rows (|q|^2 + |x|^2 up to
# about 500, ulp 6e-5)
ENGINE_SQ_ATOL = 5e-4


@pytest.fixture(autouse=True)
def _eight_mesh_devices(monkeypatch):
    monkeypatch.setenv(tmesh.MESH_DEVICES_ENV, "8")


globals().update(twin_tests("test_parallel", (
    "test_mesh_has_8_devices", "test_sharded_search_matches_oracle",
    "test_sharded_search_masked", "test_sharded_int8",
    "test_sharded_euclidean", "test_sharded_int8_pooled_parity"),
    torch_jnp=True))
globals().update(twin_tests("test_mesh_engine"))
globals().update(twin_tests("test_distributed_search", (
    "test_sharded_ivf_corpus_recall_and_ids",
    "test_sharded_ivf_batched_parity")))
globals().update(twin_tests(
    "test_coverage_gaps", ("test_make_mesh_shapes",), port_patch={
        "n = len(jax.devices())":
            "n = len(__import__('neumann_tpu_torch.parallel.mesh', "
            "fromlist=['x']).mesh_devices('cpu'))"}))


def _with_copies(n, d, seed, copies=16):
    """n Gaussian rows; ``copies`` rows of the first half copied into
    the second, so equal rows straddle every shard boundary; queries
    near the copied rows."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    src = rng.choice(n // 2, copies, replace=False)
    dst = src + n // 2 + rng.integers(0, n // 2 - src.max(), copies)
    v[dst] = v[src]
    q = v[src[:6]] + 0.05 * rng.standard_normal((6, d)).astype(np.float32)
    return v, np.concatenate([q, v[src[6:10]]])


def _assert_scores_close(got, want, metric):
    """Within TOL; euclidean scores (-distance) as squared distances
    within EUCLID_SQ_ATOL: |q|^2 + |x|^2 - 2 q.x cancels near a copied
    row, where a sqrt turns a few ulps into 2e-3."""
    if metric == "euclidean":
        got, want, tol = np.square(got), np.square(want), EUCLID_SQ_ATOL
    else:
        tol = TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _both_sharded(shards, d, quantized):
    return (jss.ShardedCorpus(jmake_mesh(shards), d, quantized=quantized),
            tss.ShardedCorpus(tmesh.make_mesh(shards, device="cpu"), d,
                              quantized=quantized))


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
@pytest.mark.parametrize("quantized", [False, True])
def test_sharded_corpus_matches_jax(shards, metric, quantized):
    """Per shard: the f32 scan, or (int8) the pooled-bits scan for
    cosine (2,048 rows a shard: pool 8) and the int8 scan otherwise,
    then the rerank; the merge in ``lax.top_k``'s order."""
    v, q = _with_copies(shards * 2048, 32, shards)
    j, t = _both_sharded(shards, 32, quantized)
    j.load(v)
    t.load(v)
    js, ji = j.search(q, 10, metric)
    ts, ti = t.search(q, 10, metric)
    _assert_scores_close(ts, js, metric)
    np.testing.assert_array_equal(ti, ji)
    # the copied rows come back as pairs, lower id first
    assert all(ti[r, 0] < ti[r, 1] for r in range(6, 10))


def test_sharded_corpus_masked_and_padded():
    """A filter mask narrows one call; 1,000 rows on 8 int8 shards of 256
    rows leave whole shards of padding, which answer -1 / -inf and never
    row 0."""
    rng = np.random.default_rng(3)
    v = rng.standard_normal((1000, 24)).astype(np.float32)
    mask = np.zeros(1000, bool)
    mask[::7] = True
    for quantized in (False, True):
        j, t = _both_sharded(8, 24, quantized)
        j.load(v)
        t.load(v)
        for m, k in ((None, 5), (mask, 5), (mask[:3], 4)):
            js, ji = j.search(v[:4], k, mask=m)
            ts, ti = t.search(v[:4], k, mask=m)
            np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
            np.testing.assert_array_equal(ti, ji)
        # int8 shards align to 256 rows: shards 4-7 hold padding only
        assert (not t.mask[-1].any()) == quantized
        s, i = t.search(v[:2], 600, mask=mask[:3])
        assert (i[:, 1:] == -1).all() and np.isneginf(s[:, 1:]).all()


def test_merge_equals_the_shards_concatenated():
    """``make_sharded_topk``'s merge is each shard's own top-k (its ids
    made global) concatenated in shard order and cut by
    ``_topk_stable``: with rows copied across shards, equal scores keep
    the lower shard first."""
    v, q = _with_copies(4 * 512, 16, 9)
    mesh = tmesh.make_mesh(4, device="cpu")
    t = tss.ShardedCorpus(mesh, 16)
    t.load(v)
    qd = torch.from_numpy(np.pad(q, ((0, 0), (0, t.dim_pad - 16))))
    s, i = tss.make_sharded_topk(mesh, 10)(t.corpus, qd, t.mask)
    parts_s, parts_i = [], []
    for shard, (c, m) in enumerate(zip(t.corpus, t.mask)):
        ps, pi = tss.topk_scan(c, qd, 10, "cosine", m)
        parts_s.append(ps)
        parts_i.append(torch.where(pi >= 0, pi.long() + shard * len(c), -1))
    cat_s = torch.cat(parts_s, dim=1)
    want_s, pos = _topk_stable(cat_s, 10)
    assert torch.equal(s, want_s)
    assert torch.equal(i, torch.gather(torch.cat(parts_i, dim=1), 1, pos))


def _clustered(n, d, k, seed, spread=3.0, noise=1.0):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((k, d)).astype(np.float32) * spread
    return (cents[rng.integers(0, k, n)]
            + noise * rng.standard_normal((n, d))).astype(np.float32)


def test_sharded_ivf_layout_matches_jax():
    """1,920 rows x 48 (dim_pad 128): both packages' k-means take the
    same numpy steps, so the cluster deal and the windows are JAX's."""
    v = _clustered(1920, 48, 16, 4)
    j = jss.ShardedIVFCorpus(jmake_mesh(4), 48, n_clusters=16, nprobe=3)
    t = tss.ShardedIVFCorpus(tmesh.make_mesh(4, device="cpu"), 48,
                             n_clusters=16, nprobe=3)
    j.load(v, seed=2)
    t.load(v, seed=2)
    for name in ("rows_s", "window", "c_per", "n_rows", "nprobe"):
        assert getattr(t, name) == getattr(j, name), name
    np.testing.assert_array_equal(t.row_ids, j.row_ids)
    got = {name: np.stack([x.numpy() for x in getattr(t, name)])
           for name in ("corpus", "rmult", "cents", "starts")}
    np.testing.assert_array_equal(got["corpus"], np.asarray(j.corpus))
    np.testing.assert_array_equal(got["starts"], np.asarray(j.starts))
    np.testing.assert_allclose(got["rmult"], np.asarray(j.rmult), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["cents"], np.asarray(j.cents), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope="module")
def carried_ivf():
    """A JAX ShardedIVFCorpus over 8,192 clustered rows on 8 shards and
    the port's copy of it (``convert.sharded_ivf_from_jax``)."""
    v = _clustered(8192, 64, 32, 5)
    j = jss.ShardedIVFCorpus(jmake_mesh(8), 64, n_clusters=32, nprobe=6)
    j.load(v)
    with pytest.MonkeyPatch.context() as mp:   # before the autouse one
        mp.setenv(tmesh.MESH_DEVICES_ENV, "8")
        t = convert.sharded_ivf_from_jax(
            j, tmesh.make_mesh(8, device="cpu"))
    rng = np.random.default_rng(6)
    q = v[rng.choice(8192, 40, replace=False)] \
        + 0.05 * rng.standard_normal((40, 64)).astype(np.float32)
    return j, t, q


@pytest.mark.parametrize("k", [1, 10, 40])
def test_carried_ivf_search_matches_jax(carried_ivf, k):
    j, t, q = carried_ivf
    assert t.nprobe == j.nprobe and len(t.corpus) == 8
    _assert_search_close(t.search(q, k), j.search(q, k))


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("k", [10, 33])
def test_carried_ivf_search_batched_matches_jax(carried_ivf, fast, k):
    """Both forms of the batched search: the non-fast first pass (kernel
    10's plain version on the CPU) and the fast one (the batched top-2
    kernel's plain version on the CPU, the Pallas kernel in interpret
    mode in JAX)."""
    j, t, q = carried_ivf
    got = t.search_batched(q, k, fast=fast)
    want = j.search_batched(q, k, fast=fast)
    _assert_search_close(got, want)
    # top-1 as the latency path's (the graft entry's assertion)
    s1, i1 = t.search(q, k)
    np.testing.assert_array_equal(got[1][:, 0], i1[:, 0])
    np.testing.assert_allclose(got[0][:, 0], s1[:, 0], rtol=0, atol=TOL)


def test_carried_sharded_corpus_searches_alike():
    v, q = _with_copies(4 * 2048, 32, 8)
    for quantized in (False, True):
        j = jss.ShardedCorpus(jmake_mesh(4), 32, quantized=quantized)
        j.load(v)
        t = convert.sharded_corpus_from_jax(
            j, tmesh.make_mesh(4, device="cpu"))
        assert t.quantized == quantized and t.n_rows == len(v)
        for metric in ("cosine", "euclidean"):
            js, ji = j.search(q, 7, metric)
            ts, ti = t.search(q, 7, metric)
            _assert_scores_close(ts, js, metric)
            np.testing.assert_array_equal(ti, ji)
    with pytest.raises(ValueError, match="shards"):
        convert.sharded_corpus_from_jax(j, tmesh.make_mesh(2, device="cpu"))


def _hits(eng, q, k, **kw):
    return [[(h.key, h.score) for h in row]
            for row in eng.batch_search_ns(q, k, **kw)]


def _assert_hits_alike(got, want, euclidean=False):
    """Keys equal, scores within TOL; the euclidean route's reported
    1 / (1 + distance) as squared distances within ENGINE_SQ_ATOL."""
    for g, w in zip(got, want):
        assert [key for key, _ in g] == [key for key, _ in w]
        sg, sw = (np.array([s for _, s in h]) for h in (g, w))
        if euclidean:
            sg, sw = np.square(1 / sg - 1), np.square(1 / sw - 1)
        np.testing.assert_allclose(sg, sw, rtol=0,
                                   atol=ENGINE_SQ_ATOL if euclidean else TOL)


@pytest.mark.parametrize("ivf", [False, True])
def test_engines_on_the_mesh_stay_fresh_alike(ivf):
    """A JAX and a port engine (mesh threshold 256) on the same 1,024
    rows: SIMILAR, a filter, int8 euclidean, then re-embedded, added and
    deleted rows served through the delta rescans without a rebuild,
    and after enough changes a rebuild; hits alike at each step."""
    kw = dict(mesh_threshold=256, ivf_auto_threshold=512 if ivf else 10**9,
              ivf_auto_clusters=16, ivf_auto_nprobe=16)
    engines = (JEngine(config=JConfig(**kw)),
               TEngine(config=TConfig(**kw), device="cpu"))
    v = _clustered(1024, 24, 8, 7, noise=0.5)
    rng = np.random.default_rng(8)
    for eng in engines:
        eng.create_collection("q8", _collection_config(eng))
        for i in range(1024):
            eng.store_embedding(f"k{i}", v[i], {"g": i % 3})
            eng.store_in_collection("q8", f"k{i}", v[i])
    q = v[rng.choice(1024, 12, replace=False)] + 0.01

    def step():
        got = [_hits(e, q, 5) for e in engines]
        _assert_hits_alike(got[1], got[0])
        got = [_hits(e, q, 5, ns="col/q8", metric="euclidean")
               for e in engines]
        _assert_hits_alike(got[1], got[0], euclidean=True)
        from neumann_tpu.engines.vector import FilterCondition as JF
        from neumann_tpu_torch.engines.vector import FilterCondition as TF

        got = [_hits(e, q, 5, filter_cond=f.eq("g", 1))
               for e, f in zip(engines, (JF, TF))]
        _assert_hits_alike(got[1], got[0])

    step()
    port = engines[1]._corpora[""][24]
    placed = port._sharded_ivf if ivf else port._sharded
    assert placed is not None and placed[1].n_shards == 8
    for eng in engines:
        eng.store_embedding("k3", -v[3])
        eng.store_embedding("new", q[0])
        eng.delete_embedding("k7")
    step()
    assert (port._sharded_ivf if ivf else port._sharded)[1] is placed[1]
    assert engines[1].search_similar(q[0], 1)[0].key == "new"
    for eng in engines:                     # past the staleness bound
        for i in range(1100):
            eng.store_embedding(f"x{i}", v[(i * 7) % 1024] + 0.5)
    step()
    assert (port._sharded_ivf if ivf else port._sharded)[1] is not placed[1]


def _collection_config(eng):
    mod = __import__(type(eng).__module__, fromlist=["x"])
    return mod.VectorCollectionConfig(dimension=24, quantization="int8")


def test_explain_names_the_mesh_route():
    r = TRouter(device="cpu")
    r.vector.config.mesh_threshold = 64
    r.vector.config.ivf_auto_threshold = 128
    v = _clustered(200, 8, 4, 9)
    r.vector.ingest_matrix([f"k{i}" for i in range(200)], v)
    r.execute("CREATE COLLECTION q8 DIM 8 QUANTIZATION int8")
    for i in range(200):
        r.vector.store_in_collection("q8", f"k{i}", v[i])
    lit = "[" + ", ".join(map(str, v[4])) + "]"

    def detail(stmt):
        rows = r.execute(f"EXPLAIN {stmt}").rows
        return " ".join(str(row.get("detail", "")) for row in rows)

    assert "route mesh_ivf" in detail(f"SIMILAR {lit} TOP 3")
    assert "route mesh:" in detail(f"SIMILAR {lit} TOP 3 METRIC dot")
    assert "route mesh_ivf" in detail(f"SIMILAR {lit} IN q8 TOP 3")
    assert "kernel int8_dot_scores" in detail(
        f"SIMILAR {lit} IN q8 TOP 3 METRIC euclidean")
    assert r.execute(f"SIMILAR {lit} TOP 3").results[0]["key"] == "k4"
    assert r.vector._corpora[""][8]._sharded_ivf is not None


def test_one_device_leaves_the_route_off(monkeypatch):
    """No variable (the CPU's one device), a value of 1, or a machine of
    one CUDA device: no mesh, no placement; four logical devices over
    one card make a mesh of four."""
    v = _clustered(300, 8, 4, 10)
    for value in (None, "1"):
        if value is None:
            monkeypatch.delenv(tmesh.MESH_DEVICES_ENV)
        else:
            monkeypatch.setenv(tmesh.MESH_DEVICES_ENV, value)
        eng = TEngine(config=TConfig(mesh_threshold=64), device="cpu")
        eng.ingest_matrix([f"k{i}" for i in range(300)], v)
        assert eng.search_similar(v[5], 1)[0].key == "k5"
        assert eng._mesh() is None
        assert eng._corpora[""][8]._sharded is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv(tmesh.MESH_DEVICES_ENV)
    assert TEngine(device="cuda")._mesh() is None
    monkeypatch.setenv(tmesh.MESH_DEVICES_ENV, "4")
    mesh = TEngine(device="cuda")._mesh()
    assert mesh.shape["shard"] == 4
    assert set(mesh.devices.flat) == {torch.device("cuda", 0)}


def test_mesh_shapes_and_errors():
    m = tmesh.make_mesh(device="cpu")
    assert list(m.shape.items()) == [("shard", 8)]
    assert m.axis_devices("shard") == [torch.device("cpu")] * 8
    m2 = tmesh.make_mesh(4, axis_names=("dp", "tp"), device="cpu")
    assert dict(m2.shape) == dict(jmake_mesh(
        4, axis_names=("dp", "tp")).shape) == {"dp": 2, "tp": 2}
    assert m2.axis_devices("tp") == [torch.device("cpu")] * 2
    for make in (jmake_mesh, functools.partial(tmesh.make_mesh,
                                               device="cpu")):
        with pytest.raises(ValueError):     # 8 is no square: [3, 2]
            make(8, axis_names=("dp", "tp"))
        with pytest.raises(ValueError, match="requested 9 devices, have 8"):
            make(9)


@pytest.mark.parametrize("n, n_clusters, nprobes, n_q, seed", [
    (16384, 16, (1, 16), 64, 11),
    (65536, 64, (4,), 32, 12),
], ids=["small", "cell_m_geometry"])
def test_sharded_ivf_recall_is_the_references(n, n_clusters, nprobes, n_q,
                                              seed):
    """chip_smoke.py's recipe (N(0, 1) centres + sigma 0.25 noise, 768-d)
    at 256 rows a centre, as cell M's 1,048,576 rows about 4,096 centres,
    and clusters of about 1,024 rows, so windows of 1,024: the sharded
    IVF ranks its candidates by int8 rows times scale / ||f32 row||, so
    near-equal neighbours swap ranks against the f32 scan. Its hits (ids
    equal where scores stand 1e-5 apart), and so its recall@10 against
    the f32 scan, are the JAX class's; an exact int8 scan finds the f32
    scan's top-10 more often. "small": 16,384 rows, one window of 5 a
    shard and all of them (recall 0.5969 and 0.8891 in both packages,
    the int8 scan 0.9703). "cell_m_geometry": cell M's layout at a
    sixteenth of its rows, nprobe 4 of about 17 windows a shard (cell M:
    64 of 257; recall 0.8656 in both packages, the int8 scan 0.9719)."""
    from neumann_tpu_torch.ops.quant import (
        int8_cosine_row_mult,
        int8_exact_topk,
        scalar_quantize,
    )
    from neumann_tpu_torch.ops.scan import topk_scan

    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((n // 256, 768)).astype(np.float32)
    v, q = ((centres[rng.integers(0, len(centres), m)]
             + 0.25 * rng.standard_normal((m, 768))).astype(np.float32)
            for m in (n, n_q))
    truth = topk_scan(torch.from_numpy(v), torch.from_numpy(q), 10)[1]

    def rec(ids):
        return np.mean([len(set(a) & set(b.tolist())) / 10
                        for a, b in zip(ids, truth)])

    q8, sc = scalar_quantize(torch.from_numpy(v))
    exact8 = rec(int8_exact_topk(q8, int8_cosine_row_mult(q8, sc),
                                 torch.from_numpy(q), 10)[1].tolist())
    del q8, sc
    for nprobe in nprobes:
        j = jss.ShardedIVFCorpus(jmake_mesh(4), 768, n_clusters=n_clusters,
                                 nprobe=nprobe)
        t = tss.ShardedIVFCorpus(tmesh.make_mesh(4, device="cpu"), 768,
                                 n_clusters=n_clusters, nprobe=nprobe)
        j.load(v)
        t.load(v)
        assert (t.window, t.c_per, t.nprobe) == (j.window, j.c_per,
                                                 j.nprobe)
        assert t.window == 1024
        got, want = t.search(q, 10), j.search(q, 10)
        _assert_search_close(got, want)
        print(f"nprobe {t.nprobe} of {t.c_per}: recall@10 "
              f"{rec(got[1]):.4f} (JAX {rec(want[1]):.4f}); exact int8 "
              f"scan {exact8:.4f}")
        # a near-tie at the 10th hit may fall either way
        assert abs(rec(got[1]) - rec(want[1])) <= 2 / (10 * n_q)
        assert rec(got[1]) < exact8

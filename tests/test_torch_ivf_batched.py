"""The port's batched IVF first pass in every variant of the JAX
package's ``_batched_core`` (neumann_tpu/ops/ivf.py), the rerank's pool
and window expansion, the non-fast ``search_batched`` and the engine's
route for throughput batches above k 128.

One layout in both packages: JAX builds each index and the port gets it
through ``convert.ivf_state_from_jax`` / ``DeviceIVFInt8.from_state``.
The JAX side runs on the CPU as its own tests run it (the XLA scans,
the Pallas top-1 kernel in interpret mode). Both packages quantize a
query as ``scalar_quantize`` does, but under jit XLA multiplies absmax
by the reciprocal of 127 where the port divides: the scales, hence the
first-pass scores, may be a few ulps apart. Most first-pass queries
here are chosen to hide where that ulp could move a rounding: they have
small odd integer entries, so their norms, hence the normalized
queries, are the same bits in both packages, and x / scale is never
within an ulp of a half, so the int8 queries and their dots are equal.
On them positions are compared exactly, in JAX's column order
(``lax.top_k``'s order for equal scores; JAX's ``approx_max_k`` is exact
on the CPU), and scores within a few ulps (ULP_RTOL, ULP_ATOL). One
test runs ordinary queries, where a rounding may move: scores within
1e-5, positions equal wherever a score stands more than 1e-5 from the
others. Reranked hits: scores within 1e-5, ids equal wherever scores
differ by more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumann_tpu.engines.vector import VectorEngineConfig as JConfig
from neumann_tpu.ops import ivf as jivf
from neumann_tpu.ops import rerank as jrerank
from neumann_tpu.router import QueryRouter as JRouter
from neumann_tpu_torch.convert import ivf_state_from_jax
from neumann_tpu_torch.engines.vector import VectorEngineConfig as TConfig
from neumann_tpu_torch.ops import ivf as tivf
from neumann_tpu_torch.ops import rerank as trerank
from neumann_tpu_torch.router import QueryRouter as TRouter

TOL = 1e-5
# the query scale's ulp (absmax / 127 against absmax * (1 / 127)) as it
# reaches a first-pass score: a few ulps of f32, relative; the pooled
# selections add 2 to a score before they pack it (ulp 2.4e-7 there)
ULP_RTOL, ULP_ATOL = 1e-6, 2e-6


def _clustered(n, d, k, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((k, d)).astype(np.float32) * 3
    return (m[rng.integers(0, k, n)]
            + 0.3 * rng.standard_normal((n, d))).astype(np.float32)


def _int8(v):
    am = np.max(np.abs(v), axis=1)
    sc = np.where(am > 0, am / 127.0, 1.0).astype(np.float32)
    q8 = np.clip(np.round(v / sc[:, None]), -127, 127).astype(np.int8)
    return q8, sc


def _index(n, d, clusters, seed, fixed_window="auto"):
    v = _clustered(n, d, clusters + 4, seed)
    q8, sc = _int8(v)
    j = jivf.DeviceIVFInt8(d, n_clusters=clusters, nprobe=4)
    j.build(q8, sc, sample_rows=2000, fixed_window=fixed_window)
    port = tivf.DeviceIVFInt8.from_state(ivf_state_from_jax(j), "cpu")
    rng = np.random.default_rng(seed + 1)
    # odd integers near 2x corpus rows: exact norms in both packages,
    # and an odd absmax puts no entry of x / scale within an ulp of a
    # half, so the scales' ulp moves no rounding (chosen to hide it)
    qs = (2 * np.round(v[rng.choice(n, 16)]) + 1).astype(np.float32)
    return dict(v=v, j=j, port=port, qs=qs)


@pytest.fixture(scope="module")
def fixed():
    """4,096 x 64 rows, 8 k-means clusters: 512-row fixed windows."""
    return _index(4096, 64, 8, 0)


@pytest.fixture(scope="module")
def legacy():
    """The one-window-per-cluster layout: windows overlap."""
    return _index(3000, 64, 6, 2, fixed_window=None)


@pytest.fixture(scope="module")
def wide():
    """d 1,152, past the 1,040 up to which an f32 sum of int8 dots is
    exact: the dots are cut into exact column slices."""
    return _index(1024, 1152, 4, 4, fixed_window=256)


def _both(ix, nprobe, m, q_cap, qs=None, **kw):
    j, p = ix["j"], ix["port"]
    qs = ix["qs"] if qs is None else qs
    want = jivf.batched_ivf_topk(
        j._buf, j._rmult, j.centroids, j._starts, jnp.asarray(qs), nprobe,
        j._window, m, q_cap, **kw)
    got = tivf.batched_ivf_topk(
        p._buf, p._rmult, p.centroids, p._starts, torch.from_numpy(qs),
        nprobe, p._window, m, q_cap, **kw)
    return got, want


VARIANTS = {
    "approx": dict(),
    "approx_probes": dict(probe_mode="approx"),
    "pool4": dict(selection=4),
    "pool8_pool_probes": dict(selection=8, probe_mode="pool"),
    "stream_approx": dict(stream=True),
    "stream_pool4": dict(stream=True, selection=4),
    "fused_xla": dict(selection=8, fused=True),
    "pallas_top1": dict(selection=4, fused="pallas"),
}
LAYOUT_VARIANTS = (
    [("fixed", v) for v in VARIANTS]
    + [("legacy", v) for v in ("approx", "pool4", "approx_probes")]
    + [("wide", v) for v in ("approx", "pool4")])


@pytest.mark.parametrize("layout,variant", LAYOUT_VARIANTS)
def test_batched_variant_matches_jax(request, layout, variant):
    """On the odd-integer queries: positions of every (query, probe,
    candidate) equal to JAX's, in JAX's column order, scores within
    ULP_RTOL and ULP_ATOL; an overflowing q_cap (4 slots for 16
    queries) drops the same probes."""
    ix = request.getfixturevalue(layout)
    kw = dict(VARIANTS[variant])
    if layout == "wide" and "selection" in kw:
        kw["selection"] = 2
    for q_cap in (16, 4):
        (s_g, p_g, o_g), (s_w, p_w, o_w) = _both(ix, 3, 12, q_cap, **kw)
        assert o_g == int(o_w)
        s_w, p_w = np.asarray(s_w), np.asarray(p_w)
        assert s_g.shape == s_w.shape and p_g.dtype == torch.int32
        np.testing.assert_allclose(s_g.numpy(), s_w, rtol=ULP_RTOL,
                                   atol=ULP_ATOL)
        np.testing.assert_array_equal(p_g.numpy(), p_w)
    assert np.isfinite(s_w).any()


@pytest.mark.parametrize("variant", ["approx", "pool4", "fused_xla",
                                     "pallas_top1"])
def test_batched_variant_ordinary_queries(fixed, variant):
    """Ordinary f32 queries (no integer entries): scores within TOL of
    JAX's; positions equal wherever a score stands more than TOL from
    every other of its row, the last column of each probe left out (it
    may tie with a candidate neither list shows)."""
    qs = np.random.default_rng(7).standard_normal((16, 64)).astype(
        np.float32)
    (s_g, p_g, o_g), (s_w, p_w, o_w) = _both(fixed, 3, 12, 16, qs=qs,
                                             **VARIANTS[variant])
    assert o_g == int(o_w) == 0
    s_g, p_g = s_g.numpy(), p_g.numpy()
    s_w, p_w = np.asarray(s_w), np.asarray(p_w)
    np.testing.assert_array_equal(np.isneginf(s_g), np.isneginf(s_w))
    live = np.isfinite(s_w)
    np.testing.assert_allclose(s_g[live], s_w[live], rtol=0, atol=TOL)
    order = np.argsort(s_w, axis=1)
    srt = np.take_along_axis(s_w, order, axis=1)
    with np.errstate(invalid="ignore"):       # -inf - -inf
        close = np.diff(srt, axis=1) <= TOL
    near = np.zeros_like(live)
    near[:, 1:] |= close
    near[:, :-1] |= close
    alone = np.empty_like(near)
    np.put_along_axis(alone, order, ~near, axis=1)
    m_eff = s_w.shape[1] // 3
    alone[:, m_eff - 1::m_eff] = False
    assert (alone & live).sum() > s_w.size // 2
    np.testing.assert_array_equal(p_g[alone & live], p_w[alone & live])


def test_exact_int8_dots_past_the_f32_limit():
    """The column-sliced f32 product equals int64 dots where one f32
    sum would round (d 3,072 at +-127: sums up to 4.9e7 > 2^24)."""
    g = torch.Generator().manual_seed(0)
    for d in (64, 1024, 1040, 3072):
        a = torch.randint(-127, 128, (3, 5, d), generator=g,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (3, 7, d), generator=g,
                          dtype=torch.int8)
        a[0, 0] = b[0, 0] = 127                  # the largest sum
        want = torch.einsum("gqd,gwd->gqw", a.long(), b.long())
        got = tivf._int8_dots(a, b)
        assert torch.equal(got, want.int().float()), d
        assert int(want[0, 0, 0]) == 127 * 127 * d


def test_argument_errors_match_jax(fixed):
    j, p = fixed["j"], fixed["port"]
    qs = fixed["qs"]
    for kw in (dict(selection=3), dict(selection=1024), dict(fused=True),
               dict(selection=8, fused="pallas"), dict(presel=10),
               dict(selection=4, presel=10, fused=True)):
        with pytest.raises(ValueError) as e_w:
            jivf.batched_ivf_topk(j._buf, j._rmult, j.centroids, j._starts,
                                  jnp.asarray(qs), 3, j._window, 12, 16,
                                  **kw)
        with pytest.raises(ValueError) as e_g:
            tivf.batched_ivf_topk(p._buf, p._rmult, p.centroids, p._starts,
                                  torch.from_numpy(qs), 3, p._window, 12,
                                  16, **kw)
        assert str(e_g.value) == str(e_w.value)


@pytest.mark.parametrize("expand", ["pool", "window"])
def test_rerank_pool_expansion_matches_jax(fixed, expand):
    """expand_pool over the contiguous pools of the XLA pooled pass, and
    over the batched kernel's strided pools with expand_window, each
    after a pre-selection: the same reranked hits."""
    j, p, qs = fixed["j"], fixed["port"], fixed["qs"]
    window = j._window
    if expand == "pool":
        pool, kw, xw = 4, dict(selection=4), 0
    else:
        pool, kw, xw = window // 128, dict(selection=window // 128,
                                           fused="pallas"), window
    (s_g, p_g, _), (s_w, p_w, _) = _both(fixed, 3, 12, 16, **kw)
    dead = torch.zeros(p._rmult.shape, dtype=torch.float32)
    dead[::97] = -1.0                       # tombstones among pool-mates
    valid_g = p._rmult + dead
    want = jrerank.gather_rerank_topk_chunked(
        j._buf, p_w, jnp.asarray(qs), 10, "cosine", scale=j._scale,
        first_scores=s_w, dedup=False, chunk=8, pre_select=24,
        expand_pool=pool, expand_window=xw,
        valid_rows=jnp.asarray(valid_g.numpy()))
    got = trerank.gather_rerank_topk_chunked(
        p._buf, p_g, torch.from_numpy(qs), 10, "cosine", scale=p._scale,
        first_scores=s_g, dedup=False, chunk=8, pre_select=24,
        expand_pool=pool, expand_window=xw, valid_rows=valid_g)
    _assert_search_close((got[0].numpy(), got[1].numpy()),
                         (np.asarray(want[0]), np.asarray(want[1])))
    dead_pos = set(np.flatnonzero(dead.numpy() < 0).tolist())
    assert not dead_pos & set(got[1].numpy().ravel().tolist())


def _assert_search_close(got, want):
    """Scores within TOL; ids equal wherever a score is more than TOL
    from its neighbours'. The last hit's id is left out: it may tie
    with the next candidate, which neither list shows."""
    (s_g, i_g), (s_w, i_w) = got, want
    assert s_g.shape == s_w.shape
    np.testing.assert_array_equal(np.isneginf(s_g), np.isneginf(s_w))
    live = np.isfinite(s_w)
    np.testing.assert_allclose(s_g[live], s_w[live], rtol=0, atol=TOL)
    with np.errstate(invalid="ignore"):       # -inf - -inf past the hits
        gap = np.abs(np.diff(s_w, axis=1)) > TOL
    sep = np.ones_like(live)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    sep[:, -1] = False
    np.testing.assert_array_equal(i_g[sep & live], i_w[sep & live])


@pytest.mark.parametrize("layout,k,fast", [("fixed", 20, False),
                                           ("fixed", 130, None),
                                           ("legacy", 10, None),
                                           ("wide", 30, False)])
def test_non_fast_search_batched_matches_jax(request, layout, k, fast):
    """The non-fast branch (k above 128, a legacy layout, or fast=False):
    exact probes, top-m per (query, window), the 8k + 16 pre-selection,
    the rerank; hits as JAX's."""
    ix = request.getfixturevalue(layout)
    j, p = ix["j"], ix["port"]
    qs = ix["v"][:: len(ix["v"]) // 12][:12] + 0.01
    assert not (fast is None and p.batched_fast_ok(k))
    _assert_search_close(p.search_batched(qs, k, nprobe=3, fast=fast),
                         j.search_batched(qs, k, nprobe=3, fast=fast))


def _vec(v):
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


def test_routers_answer_top65_batches_alike(monkeypatch):
    """A JAX and a port router over one auto-IVF layout (the threshold
    lowered to 4,096 rows): a batch of 64 ``TOP 65`` queries, k_ivf 146,
    takes ``search_batched``'s non-fast branch in both engines (the port
    no longer sends it to the latency path) and gives equal hits."""
    n, d = 8192, 64
    vecs = _clustered(n, d, 24, 5)
    cfg = dict(ivf_auto_clusters=16, ivf_auto_nprobe=8, ivf_auto_max_batch=8)
    jr, tr = JRouter(), TRouter(device="cpu")
    jr.vector.config = JConfig(mesh_auto=False, **cfg)
    tr.vector.config = TConfig(**cfg)
    for r in (jr, tr):
        monkeypatch.setattr(r.vector.config, "ivf_auto_threshold", 4096)
        with r.vector.bulk_ingest():
            for i in range(n):
                r.vector.store_embedding(f"k{i}", vecs[i])
    jr.execute(f"SIMILAR {_vec(vecs[0])} TOP 3")
    jc, tc = jr.vector._corpora[""][d], tr.vector._corpora[""][d]
    tc.slab.watch("auto_ivf")
    tc._auto_ivf = tivf.DeviceIVFInt8.from_state(
        ivf_state_from_jax(jc._auto_ivf), "cpu")
    calls = []
    monkeypatch.setattr(tc._auto_ivf, "search",
                        lambda *a, **kw: calls.append(a) or None)
    qs = vecs[np.random.default_rng(6).choice(n, 64)] + 0.02
    got = tr.vector.batch_search(qs, 65)
    want = jr.vector.batch_search(qs, 65)
    assert not calls                         # not the latency path
    assert len(got) == len(want) == 64
    for g, w in zip(got, want):
        s_g = np.array([[h.score for h in g]])
        s_w = np.array([[h.score for h in w]])
        i_g = np.array([[int(h.key[1:]) for h in g]])
        i_w = np.array([[int(h.key[1:]) for h in w]])
        _assert_search_close((s_g, i_g), (s_w, i_w))

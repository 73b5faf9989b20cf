"""The port's ops (scan, quant, rerank, partitioner, window centroids)
against the JAX package on the same numpy inputs.

Tolerances: f32 sums taken in another order differ by a few ulps, so
scores are compared with rtol=atol=1e-5 and ids only where the scores
are separated by more than that (the two frameworks break ties
differently). int8 quantization is the same arithmetic in both: exact.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumann_tpu.ops import quant as jq
from neumann_tpu.ops import rerank as jr
from neumann_tpu.ops import scan as js
from neumann_tpu.ops.ivf import window_mean_centroids as j_window_means
from neumann_tpu.parallel import partitioner as jp
from neumann_tpu_torch.ops import kernels as tk
from neumann_tpu_torch.ops import quant as tq
from neumann_tpu_torch.ops import rerank as tr
from neumann_tpu_torch.ops import scan as ts
from neumann_tpu_torch.ops.ivf import window_mean_centroids
from neumann_tpu_torch.parallel import partitioner as tp

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_topk_close(s_got, i_got, s_want, i_want, tol=TOL):
    s_got, i_got = np.asarray(s_got), np.asarray(i_got)
    s_want, i_want = np.asarray(s_want), np.asarray(i_want)
    assert s_got.shape == s_want.shape
    np.testing.assert_array_equal(np.isneginf(s_got), np.isneginf(s_want))
    live = np.isfinite(s_want)
    np.testing.assert_allclose(s_got[live], s_want[live], rtol=tol,
                               atol=tol)
    for r in range(s_want.shape[0]):
        fin = s_want[r][np.isfinite(s_want[r])]
        if fin.size == 0:
            continue
        # ids clearly inside the top-k (not tied with its boundary)
        sure = s_want[r] > fin.min() + 4 * tol
        assert set(i_got[r][sure].tolist()) == set(i_want[r][sure].tolist())


@pytest.fixture(scope="module")
def scan_data():
    rng = np.random.default_rng(0)
    n, d, q = 300, 16, 4
    c = rng.standard_normal((n, d)).astype(np.float32)
    c[rng.random((n, d)) < 0.3] = 0.0       # supports for jaccard/overlap
    c[7] = 0.0                               # a zero row
    qs = c[[3, 50, 120, 299]] + 0.1 * rng.standard_normal(
        (q, d)).astype(np.float32)
    qs[qs.__abs__() < 0.15] = 0.0
    mask = rng.random(n) < 0.8
    return c, qs, mask


@pytest.mark.parametrize("block_rows", [65536, 64])
@pytest.mark.parametrize("metric", js.METRICS)
def test_topk_scan_matches_jax(scan_data, metric, block_rows):
    c, qs, mask = scan_data
    for m in (None, mask):
        want = js.topk_scan(jnp.asarray(c), jnp.asarray(qs), 10, metric,
                            None if m is None else jnp.asarray(m),
                            block_rows=block_rows)
        got = ts.topk_scan(_t(c), _t(qs), 10, metric,
                           None if m is None else _t(m),
                           block_rows=block_rows)
        assert got[1].dtype == torch.int32
        _assert_topk_close(got[0].numpy(), got[1].numpy(), *want)


def test_topk_scan_short_corpus_and_dim_check(scan_data):
    c, qs, _ = scan_data
    s, i = ts.topk_scan(_t(c[:5]), _t(qs[0]), 10, "cosine",
                        _t(np.array([1, 1, 0, 1, 1], bool)))
    assert s.shape == (1, 5) and int(i[0, -1]) == -1
    assert np.isneginf(s[0, -1].item())
    with pytest.raises(ValueError, match="query dim"):
        ts.topk_scan(_t(c), _t(qs[:, :8]), 3)


def test_score_all_and_finalize(scan_data):
    c, qs, mask = scan_data
    want = np.asarray(js.score_all(jnp.asarray(c), jnp.asarray(qs),
                                   "euclidean", jnp.asarray(mask)))
    got = ts.score_all(_t(c), _t(qs), "euclidean", _t(mask)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    live = np.isfinite(want)
    np.testing.assert_allclose(got[live], want[live], rtol=TOL, atol=1e-4)
    for metric in ("euclidean", "angular", "cosine"):
        x = np.array([[0.5, -0.25, -np.inf]], np.float32)
        np.testing.assert_allclose(
            ts._finalize(_t(x), metric).numpy(),
            np.asarray(js._finalize(jnp.asarray(x), metric)), rtol=1e-6)


def test_host_pull_returns_numpy():
    a, b = ts.host_pull(torch.arange(3), np.ones(2))
    assert isinstance(a, np.ndarray) and a.tolist() == [0, 1, 2]
    assert isinstance(b, np.ndarray)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def test_scalar_quantize_bit_exact():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((200, 96)).astype(np.float32) * 3
    x[5] = 0.0
    x[6, :] = 127.0 * 0.5                    # exact .5 ties -> half-even
    q_j, s_j = jq.scalar_quantize(jnp.asarray(x))
    q_t, s_t = tq.scalar_quantize(_t(x))
    assert q_t.dtype == torch.int8
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(
        tq.scalar_dequantize(q_t, s_t).numpy(),
        np.asarray(jq.scalar_dequantize(q_j, s_j)))
    np.testing.assert_allclose(
        tq.int8_cosine_row_mult(q_t, s_t).numpy(),
        np.asarray(jq.int8_cosine_row_mult(q_j, s_j)), rtol=1e-6)
    rq_j, rs_j = jr.residual_quantize(jnp.asarray(x), q_j, s_j)
    rq_t, rs_t = tr.residual_quantize(_t(x), q_t, s_t)
    np.testing.assert_array_equal(rq_t.numpy(), np.asarray(rq_j))
    np.testing.assert_array_equal(rs_t.numpy(), np.asarray(rs_j))


def test_fma_f32_rounds_once():
    """The batched kernel's plain version needs a single-rounding f32
    fused multiply-add; check it against exact rational arithmetic."""
    rng = np.random.default_rng(2)
    a = np.round(rng.standard_normal(4000) * 5e6).astype(np.float32)
    b = (rng.standard_normal(4000) * 10.0 ** rng.integers(-12, -4, 4000)
         ).astype(np.float32)
    got = tk._fma_f32(_t(a), _t(b), 2.0).numpy()
    for x, y, g in zip(a.tolist(), b.tolist(), got.tolist()):
        exact = Fraction(x) * Fraction(y) + 2
        lo = np.float32(float(exact))
        # correctly rounded: no f32 neighbour is strictly closer
        for cand in (np.nextafter(lo, np.float32(-np.inf)), lo,
                     np.nextafter(lo, np.float32(np.inf))):
            assert abs(Fraction(float(cand)) - exact) >= \
                abs(Fraction(g) - exact)


# ---------------------------------------------------------------------------
# rerank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rerank_data():
    rng = np.random.default_rng(3)
    n, d, q, c = 500, 32, 6, 40
    x = rng.standard_normal((n, d)).astype(np.float32)
    qj, sj = jq.scalar_quantize(jnp.asarray(x))
    rqj, rsj = jr.residual_quantize(jnp.asarray(x), qj, sj)
    rm = np.asarray(jq.int8_cosine_row_mult(qj, sj)).copy()
    rm[11] = 0.0
    pos = rng.integers(-1, n, (q, c)).astype(np.int32)
    pos[:, 5] = pos[:, 6]                    # duplicates
    first = rng.standard_normal((q, c)).astype(np.float32)
    first[:, 9] = -np.inf
    qs = x[rng.integers(0, n, q)] + 0.2 * rng.standard_normal(
        (q, d)).astype(np.float32)
    return dict(x=x, q8=np.asarray(qj), sc=np.asarray(sj),
                rq=np.asarray(rqj), rs=np.asarray(rsj), rm=rm, pos=pos,
                first=first, qs=qs)


# the three rerank branches: the precomputed-row_mult cosine fast path,
# the int8 + scale (+ residual) reconstruction, and an f32 gather source;
# dot/euclidean ride the general branch
RERANK_CASES = {
    "rowmult": dict(src="q8", metric="cosine", row_mult=True),
    "residual": dict(src="q8", metric="cosine", scale=True, residual=True),
    "int8_scale": dict(src="q8", metric="cosine", scale=True),
    "f32_dot": dict(src="x", metric="dot"),
    "f32_euclidean": dict(src="x", metric="euclidean", valid=True),
}


def _rerank_args(D, case, lib):
    cv = (lambda a: jnp.asarray(a)) if lib == "jax" else _t
    kw = {}
    if case.get("scale"):
        kw["scale"] = cv(D["sc"])
    if case.get("residual"):
        kw["residual_q"] = cv(D["rq"])
        kw["residual_scale"] = cv(D["rs"])
    if case.get("row_mult"):
        kw["row_mult"] = cv(D["rm"])
    if case.get("valid"):
        kw["valid_rows"] = cv(D["rm"])
    return cv(D[case["src"]]), cv(D["pos"]), cv(D["qs"]), kw


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("name", sorted(RERANK_CASES))
def test_gather_rerank_matches_jax(rerank_data, name, dedup):
    case = RERANK_CASES[name]
    D = rerank_data
    corpus, pos, qs, kw = _rerank_args(D, case, "jax")
    want = jr.gather_rerank_topk(corpus, pos, qs, 8, case["metric"],
                                 first_scores=jnp.asarray(D["first"]),
                                 dedup=dedup, **kw)
    corpus, pos, qs, kw = _rerank_args(D, case, "torch")
    got = tr.gather_rerank_topk(corpus, pos, qs, 8, case["metric"],
                                first_scores=_t(D["first"]), dedup=dedup,
                                **kw)
    _assert_topk_close(got[0].numpy(), got[1].numpy(), *want, tol=1e-4)
    if dedup:
        p = got[1].numpy()
        for r in range(p.shape[0]):
            live = p[r][p[r] >= 0]
            assert len(set(live.tolist())) == live.size


@pytest.mark.parametrize("variant", ["preselect", "preselect_residual",
                                     "all_candidates"])
def test_gather_rerank_chunked_matches_jax(rerank_data, variant):
    D = rerank_data
    kw = {"preselect": dict(pre_select=12),
          "preselect_residual": dict(pre_select=12, residual=True),
          "all_candidates": dict(pre_select=None)}[variant]
    residual = kw.pop("residual", False)
    pos = np.where(D["pos"] >= 0, D["pos"] % 256, -1).astype(np.int32)
    want = jr.gather_rerank_topk_chunked(
        jnp.asarray(D["q8"]), jnp.asarray(pos), jnp.asarray(D["qs"]), 5,
        "cosine", scale=jnp.asarray(D["sc"]),
        residual_q=jnp.asarray(D["rq"]) if residual else None,
        residual_scale=jnp.asarray(D["rs"]) if residual else None,
        first_scores=jnp.asarray(D["first"]), dedup=True, chunk=4, **kw)
    got = tr.gather_rerank_topk_chunked(
        _t(D["q8"]), _t(pos), _t(D["qs"]), 5, "cosine", scale=_t(D["sc"]),
        residual_q=_t(D["rq"]) if residual else None,
        residual_scale=_t(D["rs"]) if residual else None,
        first_scores=_t(D["first"]), dedup=True, chunk=4, **kw)
    assert got[0].shape == (pos.shape[0], 5)
    _assert_topk_close(got[0].numpy(), got[1].numpy(), *want, tol=1e-4)


def test_dedup_sorted_matches_jax():
    s = np.array([[0.5, 0.9, 0.1, 0.7]], np.float32)
    p = np.array([[3, 1, 3, -1]], np.int32)
    ws, wp = jr._dedup_sorted(jnp.asarray(s), jnp.asarray(p))
    gs, gp = tr._dedup_sorted(_t(s), _t(p))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# ---------------------------------------------------------------------------
# k-means and window centroids
# ---------------------------------------------------------------------------

def _modes(n, d, k, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((k, d)).astype(np.float32) * 4
    return (m[rng.integers(0, k, n)]
            + 0.3 * rng.standard_normal((n, d))).astype(np.float32)


@pytest.mark.parametrize("n,d", [(600, 16), (4096, 64)])
def test_kmeans_matches_jax_from_same_seeding(n, d):
    """Same numpy k-means++ seeding in both; below 262,144 elements both
    run numpy Lloyd (identical), above it XLA vs torch Lloyd (f32
    sums in another order)."""
    x = _modes(n, d, 8, 4)
    want = jp.kmeans(x, 8, iters=6)
    got = tp.kmeans(x, 8, iters=6, device="cpu")
    if n * d < tp._DEVICE_KMEANS_MIN_ELEMS:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_kmeans_device_generator_and_balance():
    x = torch.from_numpy(_modes(3000, 32, 6, 5))
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    a = tp.kmeans_device(x, 6, iters=8, generator=g1)
    b = tp.kmeans_device(x, 6, iters=8, generator=g2)
    assert a.shape == (6, 32)
    torch.testing.assert_close(a, b, rtol=0, atol=0)   # same generator
    # every mode ends up owning a centroid (balance reseeding)
    d2 = ((x[:, None, :] - a[None]) ** 2).sum(-1)
    counts = torch.bincount(d2.argmin(1), minlength=6)
    assert int(counts.min()) > 0


def test_window_mean_centroids_matches_jax():
    rng = np.random.default_rng(6)
    n, d, w = 2048, 64, 256
    x = _modes(n, d, 4, 6)
    q, s = jq.scalar_quantize(jnp.asarray(x))
    rm = np.asarray(jq.int8_cosine_row_mult(q, s)).copy()
    rm[w:2 * w] = 0.0                         # an all-padding window
    rm[rng.integers(0, n, 50)] = 0.0
    want = np.asarray(j_window_means(q, jnp.asarray(rm), w, chunk_rows=512))
    got = window_mean_centroids(_t(np.asarray(q)), _t(rm), w,
                                chunk_rows=512).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert not got[1].any()
    with pytest.raises(ValueError):
        window_mean_centroids(_t(np.asarray(q))[:-1], _t(rm)[:-1], w)


# ---------------------------------------------------------------------------
# embedding slab device views
# ---------------------------------------------------------------------------

def _slabs(rng, n=3000, dim=100):
    from neumann_tpu.store.embedding_slab import EmbeddingSlab as JSlab
    from neumann_tpu_torch.store.embedding_slab import EmbeddingSlab

    v = (rng.standard_normal((n, dim)) * rng.random((n, 1)) * 3
         ).astype(np.float32)
    v[7] = 0.0
    j, t = JSlab(dim), EmbeddingSlab(dim, device="cpu")
    for slab in (j, t):
        slab.set_rows(np.arange(n), v)
        slab.clear_row(11)
    return j, t, v


def test_slab_views_match_jax():
    j, t, v = _slabs(np.random.default_rng(7))
    emb, valid = t.device_view()
    emb_j, valid_j = j.device_view()
    np.testing.assert_array_equal(emb.numpy(), np.asarray(emb_j))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    # scatter flush of a few dirty rows; the view never aliases the host
    for slab in (j, t):
        slab.set_row(5, np.ones(100, np.float32))
    emb2, _ = t.device_view()
    np.testing.assert_array_equal(emb2.numpy(),
                                  np.asarray(j.device_view()[0]))
    t._host[5, 0] = 42.0
    assert emb2[5, 0].item() == 1.0
    t._host[5, 0] = 1.0
    q, sc, va = t.quantized_view("int8")
    qj, scj, _ = j.quantized_view("int8")
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    # the JAX view is jitted, and XLA turns absmax / 127 into a multiply
    # by the reciprocal: one ulp apart (eager JAX is bit-exact, above)
    np.testing.assert_allclose(sc.numpy(), np.asarray(scj), rtol=2.5e-7)
    assert t.quantized_view("int8")[0] is q          # cached by version
    np.testing.assert_allclose(t.quantized_view("int8c")[2].numpy(),
                               np.asarray(j.quantized_view("int8c")[2]),
                               rtol=1e-6)
    np.testing.assert_allclose(t.quantized_view("f32c")[1].numpy(),
                               np.asarray(j.quantized_view("f32c")[1]),
                               rtol=1e-6)
    bits, bvalid = t.quantized_view("binary")
    bits_j, _ = j.quantized_view("binary")
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  np.asarray(bits_j))
    np.testing.assert_array_equal(bvalid.numpy(), valid.numpy())


@pytest.mark.parametrize("residual", [False, True])
def test_slab_host_int8_matches_numpy_quantizer(monkeypatch, residual):
    """The port quantizes on its device; the planes equal the JAX
    package's numpy quantizer bit for bit (its native C quantizer
    multiplies by a reciprocal and is bypassed here)."""
    from neumann_tpu import native

    j, t, _ = _slabs(np.random.default_rng(8))
    monkeypatch.setattr(native, "available", lambda: False)
    want = j.host_int8(residual=residual)
    got = t.host_int8(chunk_rows=1000, residual=residual)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

"""The port's quantized scans (neumann_tpu_torch/ops/quant.py), the pooled
reranks of ops/rerank.py and the plain versions of kernels 3-6
(ops/kernels.py) against the JAX package on the CPU, on the same numpy
inputs. Pallas kernels run in interpret mode, as the JAX package's own
tests run them.

Tolerances:
* int8 dots, int8 scores (kernel 4), hamming distances (kernel 3),
  binary codes and the int8 pooled winner bits (kernel 5): bit for bit.
* hamming top-k (kernel 7 and the route above its k cap) and the int8
  scan's ids: the JAX package's ids in its order, equal scores by
  ascending row as ``lax.top_k`` returns them.
  The pooled bits match only with XLA's contraction of
  ``dots * qmult * rm + shift`` into fma(dots * qmult, rm, shift), which
  the port computes exactly rounded.
* f32 pooled winners (kernel 6): the dots are f32 sums in another order,
  so a decoded winner score may move by one truncation step of the
  packed mantissa, ``pool * 2^-22`` for scores in [1, 4), plus 1e-6 for
  the sum; the winning rows must agree on 99 % of the pools.
* scans and reranks: scores within 1e-5, ids equal wherever the scores
  are more than that apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumann_tpu.ops import pallas_kernels as pk
from neumann_tpu.ops import quant as jq
from neumann_tpu.ops import rerank as jrr
from neumann_tpu_torch.ops import kernels as tk
from neumann_tpu_torch.ops import quant as tq
from neumann_tpu_torch.ops import rerank as trr

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(pair):
    return tuple(np.asarray(x) for x in pair)


@pytest.fixture(scope="module")
def corpus():
    """4,096 x 128 rows around 16 centres (one zero row), 6 queries near
    corpus rows, a random 80 % row mask; int8 planes from the JAX
    quantizer."""
    rng = np.random.default_rng(11)
    n, d = 4096, 128
    cents = rng.standard_normal((16, d)).astype(np.float32) * 2
    v = (cents[rng.integers(0, 16, n)]
         + 0.5 * rng.standard_normal((n, d))).astype(np.float32)
    v[7] = 0.0
    qs = (v[rng.choice(n, 6)]
          + 0.1 * rng.standard_normal((6, d))).astype(np.float32)
    cq, cs = _np(jq.scalar_quantize(jnp.asarray(v)))
    rm = np.asarray(jq.int8_cosine_row_mult(jnp.asarray(cq), jnp.asarray(cs)))
    return dict(v=v, qs=qs, mask=rng.random(n) > 0.2, cq=cq, cs=cs, rm=rm)


def _assert_topk_close(got, want, tol=TOL):
    """Scores within tol; ids equal wherever the neighbouring scores are
    more than tol apart (equal scores leave the order open)."""
    s_g, i_g = (np.asarray(x) for x in got)
    s_w, i_w = (np.asarray(x) for x in want)
    assert s_g.shape == s_w.shape and i_g.shape == i_w.shape
    np.testing.assert_array_equal(np.isneginf(s_g), np.isneginf(s_w))
    fin = np.isfinite(s_w)
    np.testing.assert_allclose(s_g[fin], s_w[fin], rtol=0, atol=tol)
    np.testing.assert_array_equal(i_g[~fin], -1)
    for r in range(s_w.shape[0]):
        if not fin[r].any():
            continue
        # a tie at the last score may straddle the k cut
        above = fin[r] & (s_w[r] > s_w[r][fin[r]].min() + 2 * tol)
        for j in np.flatnonzero(above):
            if (np.abs(s_w[r] - s_w[r, j]) <= 2 * tol).sum() == 1:
                assert i_g[r, j] == i_w[r, j], (r, j)
        assert set(i_w[r][above]) == set(
            i_g[r][fin[r] & (s_g[r] > s_w[r][fin[r]].min() + 2 * tol)]), r


# ---------------------------------------------------------------------------
# kernel 4: int8 dot scores
# ---------------------------------------------------------------------------

def test_int8_dot_scores_plain_bit_exact_with_pallas(corpus):
    C = corpus
    qq, qsc = _np(jq.scalar_quantize(jnp.asarray(C["qs"])))
    want = np.asarray(pk.int8_dot_scores(
        jnp.asarray(C["cq"]), jnp.asarray(C["rm"])[None, :],
        jnp.asarray(qq), jnp.asarray(qsc)[:, None], tile=1024))
    before = dict(tk.LAUNCHES)
    got = tk.int8_dot_scores(_t(C["cq"]), _t(C["rm"])[None, :], _t(qq),
                             _t(qsc)[:, None]).numpy()
    assert tk.LAUNCHES == before          # the plain version never counts
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
@pytest.mark.parametrize("blocked", [False, True])
def test_int8_topk_scan_matches_jax(corpus, metric, blocked):
    C = corpus
    rows = 1000 if blocked else 512 * 1024
    want = jq.int8_topk_scan(jnp.asarray(C["cq"]), jnp.asarray(C["cs"]),
                             jnp.asarray(C["qs"]), 10, metric,
                             jnp.asarray(C["mask"]),
                             block_rows=1024 if blocked else 512 * 1024)
    got = tq.int8_topk_scan(_t(C["cq"]), _t(C["cs"]), _t(C["qs"]), 10,
                            metric, _t(C["mask"]), block_rows=rows)
    tol = TOL * (100 if metric == "euclidean" else 1)
    _assert_topk_close(got, _np(want), tol)
    assert set(np.asarray(got[1]).ravel()) <= set(np.flatnonzero(C["mask"]))


# ---------------------------------------------------------------------------
# kernels 5 and 6: pooled winner bits
# ---------------------------------------------------------------------------

def _grab_bits(monkeypatch, module):
    """Record the [Q, N/pool] winner bits a pooled scan hands to its
    final cut."""
    seen = {}
    orig = module._pooled_bits_select

    def grab(allbits, pool, k, *rest):
        seen["bits"] = np.asarray(allbits)
        return orig(allbits, pool, k, *rest)

    monkeypatch.setattr(module, "_pooled_bits_select", grab)
    return seen


@pytest.mark.parametrize("pool", [8, 64, 512])
@pytest.mark.parametrize("masked", [False, True])
def test_int8_pooled_bits_bit_exact_with_jax(monkeypatch, corpus, pool,
                                             masked):
    C = corpus
    mask = C["mask"] if masked else None
    j_bits = _grab_bits(monkeypatch, jq)
    t_bits = _grab_bits(monkeypatch, tq)
    want = jq.int8_pooled_topk(
        jnp.asarray(C["cq"]), jnp.asarray(C["cs"]), jnp.asarray(C["qs"]), 8,
        pool=pool, mask=None if mask is None else jnp.asarray(mask),
        row_mult=jnp.asarray(C["rm"]))
    before = dict(tk.LAUNCHES)
    got = tq.int8_pooled_topk(_t(C["cq"]), _t(C["cs"]), _t(C["qs"]), 8,
                              pool=pool,
                              mask=None if mask is None else _t(mask),
                              row_mult=_t(C["rm"]))
    assert tk.LAUNCHES == before
    # the JAX scan pads a batch under 8 queries with zero rows
    jb = j_bits["bits"][:C["qs"].shape[0]]
    assert t_bits["bits"].shape == jb.shape == (6, 4096 // pool)
    np.testing.assert_array_equal(t_bits["bits"], jb)
    _assert_topk_close(got, _np(want), tol=0)


def test_pooled_bits_plain_rounds_once():
    """The epilogue is fma(dots * qmult, rm, bias) with ONE rounding: on
    inputs where a separate product and sum round differently, the plain
    version gives the single-rounding bits."""
    qq = torch.tensor([[1] + [0] * 63], dtype=torch.int8)
    cq = torch.zeros((8, 64), dtype=torch.int8)
    cq[:, 0] = 1
    rm = torch.full((8,), 1.0 + 2.0 ** -23)
    a = 1.0 + 2.0 ** -23                     # the product a * rm needs 47 bits
    qm = torch.tensor([a])
    bits = tk.int8_pooled_bits(cq, rm, torch.full((8,), 2.0), qq, qm, 8)
    exact = np.float64(a) * np.float64(1.0 + 2.0 ** -23) + 2.0
    want = (np.array([exact], np.float32).view(np.int32) & ~7) | 7
    assert bits.shape == (1, 1) and int(bits[0, 0]) == int(want[0])


@pytest.mark.parametrize("pool", [8, 512])
def test_f32_pooled_bits_within_tolerance_of_jax(monkeypatch, corpus, pool):
    C = corpus
    j_bits = _grab_bits(monkeypatch, jq)
    t_bits = _grab_bits(monkeypatch, tq)
    jq.f32_pooled_topk(jnp.asarray(C["v"]), jnp.asarray(C["qs"]), 8,
                       pool=pool, mask=jnp.asarray(C["mask"]))
    tq.f32_pooled_topk(_t(C["v"]), _t(C["qs"]), 8, pool=pool,
                       mask=_t(C["mask"]))
    jb, tb = j_bits["bits"][:C["qs"].shape[0]], t_bits["bits"]
    assert tb.shape == jb.shape
    dec = lambda b: (b & ~(pool - 1)).view(np.float32).astype(np.float64)
    live = jb > 0
    np.testing.assert_array_equal(tb > 0, live)
    err = np.abs(dec(tb) - dec(jb))[live]
    assert err.max() <= pool * 2.0 ** -22 + 1e-6
    same_row = (tb & (pool - 1)) == (jb & (pool - 1))
    assert np.mean(same_row[live]) >= 0.99


def test_pooled_select_and_pool_pick_match_jax():
    rng = np.random.default_rng(5)
    for n, k, pool in ((1 << 20, 10, 512), (4096, 80, 512), (4096, 8, 4096),
                       (3000, 10, 64), (96, 20, 8), (1 << 20, 80, 4096),
                       (100, 20, 8)):
        want = jq._pick_pool_blocks(n, k, pool, 1 << 20)
        assert tq._pick_pool(n, k, pool) == (want and want[0])
    pool = 64
    f = rng.uniform(1.0, 3.0, (5, 200)).astype(np.float32)
    bits = (f.view(np.int32) & ~(pool - 1)) | rng.integers(0, pool, (5, 200),
                                                           dtype=np.int32)
    bits[:, ::7] = np.float32(-1e30).view(np.int32)      # dead pools
    bits[1, :] = 0                                       # nothing written
    want = jq._pooled_bits_select(jnp.asarray(bits), pool, 12, 5, "topk")
    got = tq._pooled_bits_select(_t(bits), pool, 12)
    _assert_topk_close(got, _np(want), tol=0)


def test_f32c_view_row_mult_is_the_scan_rule(corpus):
    """The slab's "f32c" multipliers are f32_pooled_topk's default
    (one rule for every cosine multiplier of the port), within float
    rounding of the JAX slab's, and 0 for the zero row."""
    from neumann_tpu.store.embedding_slab import EmbeddingSlab as JSlab
    from neumann_tpu_torch.store.embedding_slab import EmbeddingSlab as TSlab

    v = corpus["v"][:512]
    tslab, jslab = TSlab(128, device="cpu"), JSlab(128)
    tslab.set_rows(np.arange(512), v)
    jslab.set_rows(np.arange(512), v)
    emb, rm, _ = tslab.quantized_view("f32c")
    assert torch.equal(rm, tq.f32_cosine_row_mult(emb))
    want = np.asarray(jslab.quantized_view("f32c")[1])
    assert rm[7] == 0 and want[7] == 0
    np.testing.assert_allclose(rm.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["int8", "f32"])
@pytest.mark.parametrize("masked", [False, True])
def test_pooled_rerank_matches_jax(corpus, kind, masked):
    C = corpus
    mask = C["mask"] if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    if kind == "int8":
        want = jrr.int8_pooled_rerank_topk(
            jnp.asarray(C["cq"]), jnp.asarray(C["cs"]), jnp.asarray(C["qs"]),
            10, pool=64, mask=jm, row_mult=jnp.asarray(C["rm"]))
        got = trr.int8_pooled_rerank_topk(
            _t(C["cq"]), _t(C["cs"]), _t(C["qs"]), 10, pool=64, mask=tm,
            row_mult=_t(C["rm"]))
    else:
        want = jrr.f32_pooled_rerank_topk(
            jnp.asarray(C["v"]), jnp.asarray(C["qs"]), 10, pool=64, mask=jm)
        got = trr.f32_pooled_rerank_topk(_t(C["v"]), _t(C["qs"]), 10,
                                         pool=64, mask=tm)
    _assert_topk_close(got, _np(want))
    if masked:
        assert set(np.asarray(got[1]).ravel()) <= set(np.flatnonzero(mask))


# ---------------------------------------------------------------------------
# binary codes and kernel 3: hamming
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [128, 100])
def test_binary_quantize_bit_for_bit(d):
    x = np.random.default_rng(d).standard_normal((300, d)).astype(np.float32)
    x[0] = 0.0
    want = np.asarray(jq.binary_quantize(jnp.asarray(x)))
    got = tq.binary_quantize(_t(x))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_hamming_scores_plain_matches_pallas(corpus):
    C = corpus
    cb = np.asarray(jq.binary_quantize(jnp.asarray(C["v"])))
    qb = np.asarray(jq.binary_quantize(jnp.asarray(C["qs"])))
    want = np.asarray(pk.hamming_scores(jnp.asarray(cb), jnp.asarray(qb),
                                        tile=1024))
    before = dict(tk.LAUNCHES)
    got = tk.hamming_scores(_t(cb.view(np.int32)), _t(qb.view(np.int32)))
    assert tk.LAUNCHES == before
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
def test_hamming_topk_matches_pallas(corpus, masked):
    """A ragged corpus (3,000 rows: not a tile or block multiple), blocks
    of 1,024 rows, and the row mask: distances and ids equal, in the
    same order."""
    C = corpus
    cb = np.asarray(jq.binary_quantize(jnp.asarray(C["v"][:3000])))
    qb = np.asarray(jq.binary_quantize(jnp.asarray(C["qs"])))
    mask = C["mask"][:3000] if masked else None
    want = pk.hamming_topk_pallas(
        jnp.asarray(cb), jnp.asarray(qb), 9,
        None if mask is None else jnp.asarray(mask), block_rows=1024,
        tile=512)
    got = tq.hamming_topk(_t(cb.view(np.int32)), _t(qb.view(np.int32)), 9,
                          None if mask is None else _t(mask),
                          block_rows=1024)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if masked:
        assert mask[got[1].numpy().ravel()].all()


# tie-heavy binary cases: (k, live rows); 64 is the fused kernel's cap
HAMMING_TIE_CASES = {"k10_masked": (10, None), "k_above_live": (9, 6),
                     "k_above_cap": (tk.HAMMING_TOPK_CAP + 1, None)}


@pytest.fixture(scope="module")
def hamming_ties():
    """Per (d, case): sign bits of 3,000 rows (d 128 and 768; every
    third row repeats an earlier one, so equal distances are everywhere),
    6 queries, a row mask (80 % live, or only a few live rows), k, and
    the JAX package's top-k by ``ops/quant.hamming_topk`` and by
    ``hamming_topk_pallas`` (interpret mode)."""
    out = {}
    for d in (128, 768):
        rng = np.random.default_rng(d)
        x = rng.standard_normal((3000, d)).astype(np.float32)
        x[2::3] = x[rng.integers(0, 1000, 1000)]
        qs = (x[rng.choice(3000, 6)]
              + 0.5 * rng.standard_normal((6, d))).astype(np.float32)
        cb = np.asarray(jq.binary_quantize(jnp.asarray(x)))
        qb = np.asarray(jq.binary_quantize(jnp.asarray(qs)))
        for case, (k, live) in HAMMING_TIE_CASES.items():
            mask = rng.random(3000) > 0.2
            if live is not None:
                mask[:] = False
                mask[rng.choice(3000, live, replace=False)] = True
            args = (jnp.asarray(cb), jnp.asarray(qb), k, jnp.asarray(mask))
            out[d, case] = dict(
                cb=cb.view(np.int32), qb=qb.view(np.int32), mask=mask, k=k,
                xla=_np(jq.hamming_topk(*args, block_rows=1024)),
                pallas=_np(pk.hamming_topk_pallas(*args, block_rows=1024,
                                                  tile=512)))
    return out


@pytest.mark.parametrize("route", ["plain", "quant"])
@pytest.mark.parametrize("case", list(HAMMING_TIE_CASES))
@pytest.mark.parametrize("d", [128, 768])
def test_hamming_topk_tie_order_matches_jax(hamming_ties, d, case, route):
    """The JAX package's ids in its order, (distance, row), wherever
    distances tie: through the fused kernel's plain version and through
    ``quant.hamming_topk`` (which takes ``hamming_scores`` above the
    cap), against both JAX routes."""
    T = hamming_ties[d, case]
    args = (_t(T["cb"]), _t(T["qb"]))
    if route == "plain":
        got = tk.hamming_topk_plain(*args, _t(T["mask"]), T["k"])
    else:
        got = tq.hamming_topk(*args, T["k"], _t(T["mask"]), block_rows=700)
    s, i = (x.numpy() for x in got)
    for want in (T["xla"], T["pallas"]):
        np.testing.assert_array_equal(s, want[0])
        np.testing.assert_array_equal(i, want[1])
    fin = np.isfinite(s)
    if case == "k_above_live":
        assert (fin.sum(1) == 6).all() and (i[~fin] == -1).all()
    else:   # the data is tie-heavy: equal distances inside every top-k
        assert all(len(set(r)) < len(r) for r in s)


# wide binary rows: W 96 (3,072-d, as text-embedding-3-large) and W 128,
# past the 2,048-d rows the hamming kernels once took
WIDE_DIMS = (3072, 4096)


@pytest.fixture(scope="module")
def wide_bits():
    """Per d: sign bits of 512 rows drawn from 64 base rows (so equal
    distances fill every top-k), 5 queries near stored rows, an 80 % row
    mask."""
    out = {}
    for d in WIDE_DIMS:
        rng = np.random.default_rng(d)
        base = rng.standard_normal((64, d)).astype(np.float32)
        x = base[rng.integers(0, 64, 512)]
        qs = (x[rng.choice(512, 5)]
              + 0.5 * rng.standard_normal((5, d))).astype(np.float32)
        out[d] = dict(cb=np.asarray(jq.binary_quantize(jnp.asarray(x))),
                      qb=np.asarray(jq.binary_quantize(jnp.asarray(qs))),
                      mask=rng.random(512) > 0.2)
    return out


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_hamming_scores_plain_matches_pallas_wide(wide_bits, d):
    B = wide_bits[d]
    assert B["cb"].shape == (512, d // 32)
    want = np.asarray(pk.hamming_scores(jnp.asarray(B["cb"]),
                                        jnp.asarray(B["qb"]), tile=256))
    got = tk.hamming_scores(_t(B["cb"].view(np.int32)),
                            _t(B["qb"].view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k", [10, tk.HAMMING_TOPK_CAP + 1])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_hamming_topk_wide_matches_jax(wide_bits, d, k):
    """``quant.hamming_topk`` on wide tie-heavy rows, below the fused
    kernel's k cap and above it (``hamming_scores`` in blocks): the JAX
    package's distances and ids, in its order."""
    B = wide_bits[d]
    want = _np(jq.hamming_topk(jnp.asarray(B["cb"]), jnp.asarray(B["qb"]), k,
                               jnp.asarray(B["mask"]), block_rows=200))
    got = tq.hamming_topk(_t(B["cb"].view(np.int32)),
                          _t(B["qb"].view(np.int32)), k, _t(B["mask"]),
                          block_rows=200)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert all(len(set(r)) < len(r) for r in want[0])   # ties in every row


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "dot", "euclidean"])
def test_int8_topk_scan_tie_order_matches_jax(metric, blocked):
    """Duplicated rows score exactly equal: the scan returns the JAX
    package's ids in its order (equal scores by ascending row)."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((300, 128)).astype(np.float32)
    v = base[rng.integers(0, 300, 3000)]
    qs = (v[rng.choice(3000, 8)]
          + 0.3 * rng.standard_normal((8, 128))).astype(np.float32)
    mask = rng.random(3000) > 0.2
    cq, cs = _np(jq.scalar_quantize(jnp.asarray(v)))
    rows = 1024 if blocked else 512 * 1024
    want = _np(jq.int8_topk_scan(jnp.asarray(cq), jnp.asarray(cs),
                                 jnp.asarray(qs), 10, metric,
                                 jnp.asarray(mask), block_rows=rows))
    got = tq.int8_topk_scan(_t(cq), _t(cs), _t(qs), 10, metric, _t(mask),
                            block_rows=rows)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert all(len(set(r)) < 10 for r in want[0])      # ties in every row


def test_wrappers_check_inputs(corpus):
    C = corpus
    cq, rm = _t(C["cq"]), _t(C["rm"])
    qq = cq[:2].clone()
    with pytest.raises(ValueError):                 # pool does not divide N
        tk.int8_pooled_bits(cq[:1000], rm[:1000], torch.full((1000,), 2.0),
                            qq, torch.ones(2), 64)
    with pytest.raises(ValueError):                 # pool not a power of two
        tk.f32_pooled_bits(_t(C["v"]), rm, torch.full((4096,), 2.0),
                           _t(C["qs"]), torch.ones(6), 48)
    with pytest.raises(ValueError):                 # wrong dtype
        tk.hamming_scores(cq, cq[:1])
    with pytest.raises(ValueError):                 # q_mult of the wrong size
        tk.int8_dot_scores(cq, rm, qq, torch.ones(3))


def test_launch_counters_cover_every_kernel():
    assert set(tk.LAUNCHES) == {"ivf_probe", "batched_probe",
                                "batched_probe_top1", "int8_dot_scores",
                                "int8_pooled_bits", "f32_pooled_bits",
                                "hamming_scores", "hamming_topk", "pq_adc",
                                "pq_adc_select", "int8_exact_select",
                                "int8_exact_scores"}

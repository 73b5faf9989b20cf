"""The ADC scan's select mode (row 8, ``ops/kernels.pq_adc_topk``: the
top-k inside the kernel) through its plain version against the JAX
package's ADC search, on the CPU; the kernel's plan; and the
``VectorEngineConfig.low_memory()`` preset through both routers.

* ``pq_adc_topk_plain`` against the JAX ``_adc_search_fn`` (the sums and
  ``lax.top_k`` in one function, what the kernel replaces) on the same
  codes and tables of a JAX codebook of 8 subspaces: rows copied (exact
  ties), 1 % dead rows, fewer live rows than k, k 1, 10 and 64. Scores
  and ids equal after the -inf / -1 masking (XLA sums 8 subspaces in
  order, as the kernel does; at M 96 its sum takes another order and
  moves scores by a few ulps, so M 96 is held to 1e-5).
* ``pq_topk`` on JAX's state carried by ``convert.pq_from_jax`` against
  the JAX ``pq_topk`` at k 10 and 64 (the select mode) and 65 (the scores
  mode and ``_topk_stable``): ids equal, scores within 1e-5 (each package
  computes its tables in its own order).
* The gathered mode through ``IVFIndex``'s pq storage against the JAX
  ``IVFIndex`` (``convert.ivf_index_from_jax``) at k 1, 10, 64 and 65, and
  against ``_topk_stable`` of the plain scores with -1 and repeated
  candidates (ties by column) and -inf / NaN scores (bits equal).
* The plan (``_pq_adc_plan``, ``_pq_smem``): shared memory within a
  block's 232,448 bytes and a grid within its limits for M 8-392, Q
  1-65,535, k 1-64.
* ``low_memory()`` and ``search_timeout_s``: the JAX engine accepts both
  and enforces neither; a port router built on them answers SIMILARs
  (the default namespace, a filter, a pq collection) with the JAX
  router's hits.
"""

import numpy as np
import pytest
import torch

from neumann_tpu.engines.vector import VectorEngineConfig as JConfig
from neumann_tpu.ops import ivf as jivf
from neumann_tpu.ops import pq as jpq
from neumann_tpu.router import QueryRouter as JRouter
from neumann_tpu_torch.convert import ivf_index_from_jax, pq_from_jax
from neumann_tpu_torch.engines.vector import VectorEngineConfig as TConfig
from neumann_tpu_torch.ops import kernels as tk
from neumann_tpu_torch.ops import pq as tpq
from neumann_tpu_torch.ops.scan import _topk_stable
from neumann_tpu_torch.router import QueryRouter as TRouter

TOL = 1e-5


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((12, d)) * 2
    x = (c[rng.integers(0, 12, n)]
         + 0.5 * rng.standard_normal((n, d))).astype(np.float32)
    x[40:48] = x[3]                    # copies: equal codes, exact ties
    x[900:904] = x[3]
    q = (x[rng.integers(0, n, 6)]
         + 0.1 * rng.standard_normal((6, d))).astype(np.float32)
    return x, np.concatenate([q, x[3:4]])


@pytest.fixture(scope="module")
def jax_state():
    x, q = _data(2048, 64, 0)
    jb = jpq.PQCodebook(64, jpq.PQConfig(n_subspaces=8))
    jb.train(x)
    return x, q, jb, jb.encode(x)


def _masked(s, i):
    """pq_topk's masking: ids of -inf scores are -1."""
    s, i = np.asarray(s), np.asarray(i)
    return s, np.where(np.isneginf(s), -1, i)


def _mask(n, seed, live=None):
    rng = np.random.default_rng(seed)
    if live is not None:
        mask = np.zeros(n, bool)
        mask[rng.choice(n, live, replace=False)] = True
        return mask
    mask = rng.random(n) > 0.01
    mask[[3, *range(40, 48)]] = True
    return mask


@pytest.mark.parametrize("live", [None, 5])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_select_plain_equals_the_jax_adc_search(jax_state, k, live):
    import jax.numpy as jnp

    x, q, jb, codes = jax_state
    mask = _mask(len(x), k, live)
    tables = np.stack([jb.compute_adc_table(qq) for qq in q])
    js, ji = jpq._adc_search_fn()(jnp.asarray(codes.astype(np.int32)),
                                  jnp.asarray(tables), jnp.asarray(mask), k)
    ts, ti = tk.pq_adc_topk_plain(torch.from_numpy(codes.astype(np.uint8)),
                                  torch.from_numpy(tables),
                                  torch.from_numpy(mask), k)
    js, ji = _masked(js, ji)
    ts, ti = _masked(ts, ti)
    assert ts.dtype == np.float32 and ti.shape == (len(q), k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    if live is not None:
        assert (ti[:, live:] == -1).all() and np.isneginf(ts[:, live:]).all()
    else:   # the copies of row 3 come out by ascending row
        assert ti[-1, :min(k, 13)].tolist() == \
            [3, *range(40, 48), *range(900, 904)][:min(k, 13)]


def test_select_plain_at_m96_within_tolerance():
    """At M 96 XLA sums the subspaces in another order than the kernel's
    (and the plain version's) m = 0 .. M-1: ids equal, scores within
    1e-5 relative."""
    import jax.numpy as jnp

    rng = np.random.default_rng(96)
    codes = rng.integers(0, 256, (3000, 96)).astype(np.int32)
    codes[100:110] = codes[5]
    tables = (rng.random((5, 96, 256)) * 4).astype(np.float32)
    mask = rng.random(3000) > 0.01
    for k in (1, 10, 64):
        js, ji = jpq._adc_search_fn()(jnp.asarray(codes), jnp.asarray(tables),
                                      jnp.asarray(mask), k)
        ts, ti = tk.pq_adc_topk_plain(
            torch.from_numpy(codes.astype(np.uint8)),
            torch.from_numpy(tables), torch.from_numpy(mask), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOL)


@pytest.mark.parametrize("k", [10, 64, 65])
def test_pq_topk_routes_by_k_on_jax_state(jax_state, k, monkeypatch):
    """k up to the cap takes the select mode, 65 the scores mode and
    _topk_stable: either gives the JAX pq_topk's ids."""
    x, q, jb, codes = jax_state
    mask = _mask(len(x), 7)
    book, tcodes = pq_from_jax(jb, codes, device="cpu")
    calls = []
    for name in ("pq_adc_topk", "pq_adc_scores"):
        fn = getattr(tk, name)
        monkeypatch.setattr(tk, name, lambda *a, _f=fn, _n=name:
                            calls.append(_n) or _f(*a))
    js, ji = jpq.pq_topk(jb, codes, q, k, mask)
    ts, ti = tpq.pq_topk(book, tcodes, q, k, torch.from_numpy(mask))
    assert calls == ["pq_adc_topk" if k <= tk.PQ_ADC_TOPK_CAP
                     else "pq_adc_scores"]
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(ts.numpy(), js, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k", [1, 10, 64, 65])
def test_gathered_mode_through_ivf_index_like_jax(k):
    """IVFIndex's pq storage (the gathered mode: each query its probed
    rows, ties by probe order) carried from a JAX index."""
    rng = np.random.default_rng(k)
    c = rng.standard_normal((16, 64)).astype(np.float32)
    x = (c[rng.integers(0, 16, 3000)]
         + 0.3 * rng.standard_normal((3000, 64))).astype(np.float32)
    x[60:66] = x[9]
    q = np.concatenate([x[rng.integers(0, 3000, 6)]
                        + 0.02 * rng.standard_normal((6, 64)), x[9:10]]
                       ).astype(np.float32)
    j = jivf.IVFIndex(64, jivf.IVFConfig(n_clusters=16, nprobe=4,
                                         storage="pq", pq_subspaces=8))
    j.train(x)
    j.add(x)
    t = ivf_index_from_jax(j, device="cpu")
    js, ji = j.search(q, k)
    ts, ti = t.search(q, k)
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(js)
    assert np.array_equal(fin, np.isfinite(ts))
    np.testing.assert_allclose(ts[fin], js[fin], rtol=TOL, atol=TOL)


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("gathered", [False, True])
def test_select_plain_is_topk_stable_of_the_scores(gathered):
    """The plain select (column steps merged by key) against
    _topk_stable over the plain scores: -1 and repeated candidates,
    dead rows, tables with +inf (a live row scored -inf) and NaN (a
    sign-bit NaN, below -inf), k past the columns. Scores bit for bit."""
    g = torch.Generator().manual_seed(5)
    n, m, q = 5000, 12, 4
    codes = torch.randint(0, 256, (n, m), generator=g, dtype=torch.uint8)
    codes[3000:3050] = codes[7]
    tables = torch.rand(q, m, 256, generator=g) * 3
    tables[0, 2, 17] = float("inf")
    tables[1, 5, 200] = float("nan")
    valid = torch.rand(n, generator=g) > 0.3
    cand = None
    if gathered:
        cand = torch.randint(-1, n, (q, 1111), generator=g,
                             dtype=torch.int32)
        cand[:, 50:60] = cand[:, :10]
        cand[:, 100:140] = 3000 + torch.arange(40, dtype=torch.int32)
    cols = n if cand is None else cand.shape[1]
    scores = tk.pq_adc_scores_plain(codes, tables, valid, cand)
    assert torch.isneginf(scores).any() and torch.isnan(scores).any()
    for k in (1, 10, 64):
        ws, wi = _topk_stable(scores, min(k, cols))
        ts, ti = tk.pq_adc_topk_plain(codes, tables, valid, k, cand)
        assert torch.equal(ti, wi) and _bits_equal(ts, ws), k
        # the CPU wrapper takes the plain version
        ws2, wi2 = tk.pq_adc_topk(codes, tables, valid, k, cand)
        assert torch.equal(wi2, wi) and _bits_equal(ws2, ws)
    short = tk.pq_adc_topk_plain(codes[:20], tables, valid[:20], 64)
    assert short[1].shape == (q, 20)
    with pytest.raises(ValueError, match="1 <= k"):
        tk.pq_adc_topk(codes, tables, valid, 65)
    with pytest.raises(ValueError, match="1 <= k"):
        tk.pq_adc_topk(codes, tables, valid, 0)
    with pytest.raises(ValueError):
        tk.pq_adc_topk(codes, tables[:, :m - 1], valid, 10)


@pytest.mark.parametrize("sms", [132, 78])
@pytest.mark.parametrize("q", [1, 7, 8, 9, 85, 1025, 65535])
@pytest.mark.parametrize("m", [8, 13, 96, 192, 384, 392])
def test_plan_fits_the_card(m, q, sms):
    """Every plan fits a block's shared memory and the grid's limits,
    covers the columns with whole passes, and takes the shared layout
    exactly for full scans of 8 queries or more."""
    for k in (1, 10, 64):
        for cols in (1, 3001, 4096, 20_011, 1 << 20, (1 << 26) + 5):
            for gathered in (False, True):
                for select in (False, True):
                    shared, chunk, parts, span = tk._pq_adc_plan(
                        cols, q, m, k, gathered, select, sms)
                    assert shared == (not gathered
                                      and q >= tk._PQ_SHARED_MIN_Q)
                    assert chunk == (1 if shared else min(48, m))
                    assert tk._pq_smem(shared, chunk, k, select) <= \
                        tk._PQ_SMEM
                    per = tk._PQ_SHARED_PASS if shared else \
                        tk._PQ_LANE_PASS
                    assert span % per == 0 and 1 <= parts < 1 << 31
                    assert (parts - 1) * span < cols <= parts * span
                    assert (-(-q // tk._PQ_QB) if shared else q) <= 65535
                    if shared:   # whole passes a block: the grid fills
                        passes = -(-cols // per)   # half the SMs or more
                        assert 2 * parts * -(-q // tk._PQ_QB) >= min(
                            sms, passes * -(-q // tk._PQ_QB))


def _lit(v):
    return "[" + ", ".join(map(repr, np.asarray(v, np.float64).tolist())) \
        + "]"


@pytest.mark.parametrize("preset", ["low_memory", "search_timeout"])
def test_low_memory_routers_give_equal_hits(preset):
    """The JAX engine accepts max_keys_per_scan and search_timeout_s and
    reads neither: a port router on the same config answers alike."""
    if preset == "low_memory":
        jc, tc = JConfig.low_memory(), TConfig.low_memory()
    else:
        jc, tc = (JConfig(search_timeout_s=1.0),
                  TConfig(search_timeout_s=1.0))
    x, q = _data(1500, 64, 3)
    jr, tr = JRouter(), TRouter(device="cpu")
    jr.vector.config = jc
    tr.vector.config = tc
    for r in (jr, tr):
        r.execute("CREATE COLLECTION c DIM 64 QUANTIZATION pq")
        with r.vector.bulk_ingest():
            for i, v in enumerate(x):
                r.vector.store_embedding(f"k{i}", v, {"cat": i % 4})
                r.vector.store_in_collection("c", f"k{i}", v)
    stmts = []
    for qq in q[:3]:
        stmts += [f"SIMILAR {_lit(qq)} TOP 10",
                  f"SIMILAR {_lit(qq)} WHERE cat = 2 TOP 5",
                  f"SIMILAR {_lit(qq)} IN c TOP 10"]
    for st in stmts:
        a, b = (r.execute(st).results for r in (jr, tr))
        assert [h["key"] for h in a] == [h["key"] for h in b], st
        np.testing.assert_allclose([h["score"] for h in a],
                                   [h["score"] for h in b], rtol=TOL,
                                   atol=TOL)

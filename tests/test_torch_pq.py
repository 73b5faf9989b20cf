"""The port's product quantization (neumann_tpu_torch/ops/pq.py, the ADC
kernel's plain version, the engine's pq and tt routes) against the JAX
package's, on the CPU.

* Codebooks: equal to the JAX package's below the device k-means
  threshold (both run the same numpy k-means from the same seed per
  subspace). Codes: equal except where a vector's two nearest centroids
  are within 1e-5 (an argmin of f32 sums taken in another order).
* ``pq_topk`` on the JAX package's codebook and codes (carried across by
  ``convert.pq_from_jax``): scores within rtol 1e-5, ids equal in
  ``lax.top_k``'s order, on data with duplicated rows (equal codes tie
  exactly, so their order is part of the result).
* ``pq_adc_scores_plain`` (the kernel's bit-exact twin): the f32 sum of
  the looked-up values in subspace order, in full and gathered modes.
* Both routers through ``CREATE COLLECTION … QUANTIZATION pq|tt`` and
  ``SIMILAR … IN``, filtered and not, single and batched, and after a
  write (which retrains): equal keys, scores within 1e-5.
"""

import numpy as np
import pytest
import torch

from neumann_tpu.ops import pq as jpq
from neumann_tpu.router import QueryRouter as JRouter
from neumann_tpu_torch.convert import pq_from_jax
from neumann_tpu_torch.ops import kernels as tk
from neumann_tpu_torch.ops import pq as tpq
from neumann_tpu_torch.router import QueryRouter as TRouter

TOL = 1e-5


def _data(n, d, seed, dups=True):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((12, d)) * 2
    x = (c[rng.integers(0, 12, n)]
         + 0.5 * rng.standard_normal((n, d))).astype(np.float32)
    if dups:
        x[40:48] = x[3]
        x[100:104] = x[200]
    q = (x[rng.integers(0, n, 6)]
         + 0.1 * rng.standard_normal((6, d))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def trained():
    x, q = _data(2048, 64, 0)
    jb = jpq.PQCodebook(64, jpq.PQConfig(n_subspaces=8))
    jb.train(x)
    tb = tpq.PQCodebook(64, tpq.PQConfig(n_subspaces=8), device="cpu")
    tb.train(x)
    return x, q, jb, tb


def test_codebooks_equal_below_device_kmeans(trained):
    x, _, jb, tb = trained
    assert np.array_equal(jb.codebooks, tb.codebooks)
    assert tb.codebooks.shape == (8, 256, 8)


def test_codes_equal_except_near_ties(trained):
    x, _, jb, tb = trained
    jc = jb.encode(x)
    tc = tb.encode(torch.from_numpy(x)).numpy()
    assert tc.dtype == np.uint8 and tc.shape == jc.shape
    books = jb.codebooks.astype(np.float64)
    sub = x.reshape(len(x), 8, 8).astype(np.float64)
    d2 = ((sub[:, :, None, :] - books[None]) ** 2).sum(-1)   # [N, M, 256]
    two = np.sort(d2, axis=-1)[:, :, :2]
    near = (two[:, :, 1] - two[:, :, 0]) <= TOL
    assert np.array_equal(jc[~near], tc[~near])
    # numpy input encodes alike
    assert np.array_equal(tb.encode(x).numpy(), tc)


def test_tables_and_decode_match(trained):
    x, q, jb, tb = trained
    for qq in q:
        np.testing.assert_allclose(tb.compute_adc_table(qq),
                                   jb.compute_adc_table(qq), rtol=TOL,
                                   atol=TOL)
    codes = jb.encode(x[:50])
    np.testing.assert_array_equal(tb.decode(codes).numpy(),
                                  jb.decode(codes))
    table = jb.compute_adc_table(q[0])
    assert tb.adc_distance(table, codes[0]) == \
        jb.adc_distance(table, codes[0])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_pq_topk_on_jax_state(trained, masked, k):
    x, q, jb, _ = trained
    codes = jb.encode(x)
    mask = None
    if masked:
        mask = np.random.default_rng(k).random(len(x)) > 0.3
        mask[3] = mask[40:48] = True
    book, tcodes = pq_from_jax(jb, codes, device="cpu")
    js, ji = jpq.pq_topk(jb, codes, q, k, mask)
    ts, ti = tpq.pq_topk(book, tcodes, q, k,
                         None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(ts.numpy(), js, rtol=TOL, atol=TOL)
    # a query equal to a duplicated row: its copies tie, by ascending row
    js, ji = jpq.pq_topk(jb, codes, x[3], 12, mask)
    ts, ti = tpq.pq_topk(book, tcodes, x[3], 12,
                         None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert ji[0][:9].tolist() == [3, *range(40, 48)]


def test_pq_topk_past_the_live_rows(trained):
    x, q, jb, _ = trained
    codes = jb.encode(x[:20])
    mask = np.zeros(20, bool)
    mask[[2, 5, 7]] = True
    book, tcodes = pq_from_jax(jb, codes, device="cpu")
    js, ji = jpq.pq_topk(jb, codes, q, 8, mask)
    ts, ti = tpq.pq_topk(book, tcodes, q, 8, torch.from_numpy(mask))
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert (ti.numpy()[:, 3:] == -1).all()
    assert np.isneginf(ts.numpy()[:, 3:]).all()


@pytest.mark.parametrize("m", [8, 13, 96])
def test_adc_plain_is_the_ordered_f32_sum(m):
    g = torch.Generator().manual_seed(m)
    n, q = 700, 3
    codes = torch.randint(0, 256, (n, m), generator=g, dtype=torch.uint8)
    tables = torch.rand(q, m, 256, generator=g) * 10
    valid = torch.rand(n, generator=g) > 0.2
    got = tk.pq_adc_scores(codes, tables, valid)
    t, c = tables.numpy(), codes.numpy().astype(np.int64)
    want = np.zeros((q, n), np.float32)
    for j in range(m):
        want = want + t[:, j, c[:, j]]
    want = np.where(valid.numpy()[None, :], -want, -np.inf)
    assert np.array_equal(got.numpy(), want.astype(np.float32))
    cand = torch.randint(-1, n, (q, 57), generator=g, dtype=torch.int32)
    gathered = tk.pq_adc_scores(codes, tables, valid, cand)
    ok = (cand >= 0) & valid[cand.clamp_min(0).long()]
    full = torch.gather(got, 1, cand.clamp_min(0).long())
    assert torch.equal(gathered, torch.where(
        ok, full, torch.full_like(full, float("-inf"))))
    with pytest.raises(ValueError):
        tk.pq_adc_scores(codes.int(), tables, valid)
    with pytest.raises(ValueError):
        tk.pq_adc_scores(codes, tables[:, :m - 1], valid)


def _lit(v):
    return "[" + ", ".join(map(repr, np.asarray(v, np.float64).tolist())) \
        + "]"


def _hits(res):
    return [(h["key"], h["score"]) for h in res.results]


def _same(a, b):
    """Equal keys in order, scores within TOL. Two keys may trade places
    only where their scores are within TOL (a tt reconstruction differs
    from numpy's by about 1e-7, which can reorder a near tie; pq scores
    of equal codes tie exactly and keep their order)."""
    assert len(a) == len(b), (a, b)
    if not a:
        return
    sa, sb = np.array([s for _, s in a]), np.array([s for _, s in b])
    assert np.abs(sa - sb).max() <= TOL, (a, b)
    pos = {k: i for i, (k, _) in enumerate(a)}
    for i, ((ka, _), (kb, _)) in enumerate(zip(a, b)):
        if ka != kb:
            # kb sits elsewhere in a at a near-equal score, or (past the
            # last hit) both lists end in a near tie
            j = pos.get(kb)
            assert (abs(sa[j] - sa[i]) if j is not None
                    else abs(sa[i] - sa[-1])) <= TOL, (i, a, b)


@pytest.mark.parametrize("quant,metric", [("pq", "cosine"),
                                          ("tt", "cosine")])
def test_routers_agree_on_quantized_collections(quant, metric):
    x, q = _data(2048 if quant == "pq" else 4096, 64, 1)
    routers = (JRouter(), TRouter(device="cpu"))
    for r in routers:
        r.execute(f"CREATE COLLECTION c DIM 64 METRIC {metric} "
                  f"QUANTIZATION {quant}")
        with r.vector.bulk_ingest():
            for i, v in enumerate(x):
                r.vector.store_in_collection("c", f"k{i}", v,
                                             {"cat": i % 4})
    stmts = []
    for qq in q[:3]:
        stmts += [f"SIMILAR {_lit(qq)} IN c TOP 10",
                  f"SIMILAR {_lit(qq)} IN c WHERE cat = 1 TOP 7"]
    stmts.append(f"SIMILAR {_lit(x[3])} IN c TOP 12")
    for st in stmts:
        _same(*(_hits(r.execute(st)) for r in routers))
    batches = [r.vector.batch_search_ns(q, 10, ns="col/c")
               for r in routers]
    for a, b in zip(*batches):
        _same([(h.key, h.score) for h in a], [(h.key, h.score) for h in b])
    # a write moves the slab's version: both retrain / re-decompose
    for r in routers:
        r.vector.store_in_collection("c", "k5", q[0], {"cat": 1})
        r.vector.delete_from_collection("c", "k9")
    st = f"SIMILAR {_lit(q[0])} IN c TOP 5"
    got = [_hits(r.execute(st)) for r in routers]
    _same(*got)
    assert got[1][0][0] == "k5"


@pytest.mark.parametrize("quant", ["pq", "tt"])
def test_a_delete_under_a_cached_state_is_masked(quant):
    """A row deleted after a search took its cached pq / tt state (the
    state re-stamped with the slab's new version, as when the delete
    lands between the version check and the scan) is masked, and the
    search still fills k, as the JAX engine's does."""
    x, q = _data(1024, 64, 2, dups=False)
    routers = (JRouter(), TRouter(device="cpu"))
    st = f"SIMILAR {_lit(q[0])} IN c TOP 8"
    for r in routers:
        r.execute(f"CREATE COLLECTION c DIM 64 QUANTIZATION {quant}")
        with r.vector.bulk_ingest():
            for i, v in enumerate(x):
                r.vector.store_in_collection("c", f"k{i}", v)
    before = [_hits(r.execute(st)) for r in routers]
    _same(*before)
    dead = before[1][0][0]
    for r in routers:
        corpus = r.vector._corpora["col/c"][64]
        state = getattr(corpus, f"_{quant}")
        r.vector.delete_from_collection("c", dead)
        setattr(corpus, f"_{quant}", (corpus.slab.version, *state[1:]))
    after = [_hits(r.execute(st)) for r in routers]
    _same(*after)
    assert len(after[1]) == 8 and dead not in [k for k, _ in after[1]]

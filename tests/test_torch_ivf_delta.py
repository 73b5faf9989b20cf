"""The port's IVF delta plane (``DeviceIVFInt8.add`` / ``delete`` /
``compact`` and the exact delta merge) and ``int8_exact_topk``, against
the JAX package's.

The scenario of tests/test_compress_ivf.py::
test_device_ivf_incremental_add_delete, mirrored: a JAX index of 8,192 x
64 clustered rows (16 k-means clusters, 256-row fixed windows) takes 10 %
more rows through ``add`` and loses 5 % through ``delete``. The port gets
it through ``convert.ivf_state_from_jax`` (delta plane and tombstones
included), and a second port index, carried over before the mutation,
repeats the same calls itself. Both then search as JAX does. The JAX
side runs on the CPU as its own tests run it.

Tolerance: scores within 1e-5 (f32 sums in another order); ids equal
wherever a score is more than that from its neighbours'. The planes a
mutation writes are compared bit for bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumann_tpu.ops import ivf as jivf
from neumann_tpu.ops import quant as jquant
from neumann_tpu_torch.convert import ivf_state_from_jax
from neumann_tpu_torch.ops import ivf as tivf
from neumann_tpu_torch.ops import quant as tquant
from tests.test_torch_ivf_batched import _assert_search_close

TOL = 1e-5
N, D, K = 8192, 64, 10


@pytest.mark.parametrize("n,block,live", [(5000, 1024, 0.9), (300, 4096, 0.02),
                                          (2048, 2048, 1.0)])
def test_int8_exact_topk_matches_jax(n, block, live):
    """Scores within 1e-5 and ids in ``lax.top_k``'s order, equal rows
    (duplicated rows score alike) by ascending row, across blocks; -1
    past the live rows (300 rows at 2 % live: fewer than k)."""
    rng = np.random.default_rng(n)
    q8 = rng.integers(-127, 128, (n, D)).astype(np.int8)
    q8[1::7] = q8[0]                              # ties across blocks
    sc = (rng.random(n) * 0.02 + 0.01).astype(np.float32)
    sc[1::7] = sc[0]
    rm = np.asarray(jquant.int8_cosine_row_mult(jnp.asarray(q8),
                                                jnp.asarray(sc)))
    rm = np.where(rng.random(n) < live, rm, 0.0).astype(np.float32)
    qs = rng.standard_normal((9, D)).astype(np.float32)
    qs[0] = q8[0]
    s_w, i_w = jax.jit(jquant.int8_exact_topk,
                       static_argnames=("k", "block_rows"))(
        jnp.asarray(q8), jnp.asarray(rm), jnp.asarray(qs), K,
        block_rows=block)
    s_g, i_g = tquant.int8_exact_topk(torch.from_numpy(q8),
                                      torch.from_numpy(rm),
                                      torch.from_numpy(qs), K,
                                      block_rows=block)
    s_w, i_w = np.asarray(s_w), np.asarray(i_w)
    np.testing.assert_array_equal(np.isneginf(s_g.numpy()), np.isneginf(s_w))
    fin = np.isfinite(s_w)
    np.testing.assert_allclose(s_g.numpy()[fin], s_w[fin], rtol=0, atol=TOL)
    np.testing.assert_array_equal(i_g.numpy(), i_w)
    if live == 1.0:
        assert i_g[0].tolist() == [0] + list(range(1, 7 * K - 7, 7))


@pytest.fixture(scope="module")
def scenario():
    rng = np.random.default_rng(0)
    modes = rng.standard_normal((16, D)).astype(np.float32) * 3
    assign = rng.integers(0, 16, N + N // 10)
    allv = (modes[assign] + 0.3 * rng.standard_normal(
        (N + N // 10, D))).astype(np.float32)
    base, extra = allv[:N], allv[N:]
    cq, scale = jquant.scalar_quantize(jnp.asarray(base))
    j = jivf.DeviceIVFInt8(D, n_clusters=16, nprobe=16, iters=8)
    j.build(np.asarray(cq), np.asarray(scale), sample_rows=2000,
            fixed_window=256)
    port = tivf.DeviceIVFInt8.from_state(ivf_state_from_jax(j), "cpu")
    dead = rng.choice(N + len(extra), size=(N + len(extra)) // 20,
                      replace=False)
    assert list(j.add(extra)) == list(port.add(extra)) \
        == list(range(N, N + len(extra)))
    assert j.delete(dead) == port.delete(dead) == len(dead)
    assert j.delete(dead[:3]) == port.delete(dead[:3]) == 0
    live = np.setdiff1d(np.arange(N + len(extra)), dead)
    qs = allv[rng.choice(live, 128, replace=False)] \
        + 0.05 * rng.standard_normal((128, D)).astype(np.float32)
    carried = tivf.DeviceIVFInt8.from_state(ivf_state_from_jax(j), "cpu")
    return dict(j=j, port=port, carried=carried, allv=allv, extra=extra,
                dead=dead, live=live, qs=qs)


def test_mutations_write_the_same_planes(scenario):
    """add / delete on the port write the bits JAX's write: the delta
    rows, scales and multipliers, the delta ids, the tombstoned main
    multipliers; the counts agree."""
    j, p = scenario["j"], scenario["port"]
    for a, b in (("_dbuf", "_dbuf"), ("_drmult", "_drmult"),
                 ("_dscale", "_dscale"), ("_rmult", "_rmult")):
        np.testing.assert_array_equal(getattr(p, a).numpy(),
                                      np.asarray(getattr(j, b)))
    np.testing.assert_array_equal(p._dids, j._dids)
    assert (p._dn, p._deleted, p._next_id, p.n_live) == \
        (j._dn, j._deleted, j._next_id, j.n_live)
    assert p._dead_ids == j._dead_ids
    assert p._dbuf.shape[0] == 1024          # 820 rows: one doubling
    c = scenario["carried"]
    assert (c._dn, c._deleted, c._next_id, c.n_live) == \
        (j._dn, j._deleted, j._next_id, j.n_live)


@pytest.mark.parametrize("which", ["port", "carried"])
@pytest.mark.parametrize("path", ["search", "search_batched"])
def test_mutated_index_searches_as_jax(scenario, which, path):
    """Both the port's own mutations and a mutated JAX index carried
    over: hits as JAX's on the single and the batched path, no deleted
    id among them."""
    j, p, qs = scenario["j"], scenario[which], scenario["qs"]
    got = getattr(p, path)(qs, K, nprobe=8)
    want = getattr(j, path)(qs, K, nprobe=8)
    _assert_search_close(got, want)
    assert not np.isin(got[1], scenario["dead"]).any()


def test_added_rows_are_found_at_once(scenario):
    p, extra = scenario["port"], scenario["extra"]
    ok = ~np.isin(np.arange(N, N + len(extra)), scenario["dead"])
    rows = np.flatnonzero(ok)[:32]
    for path in ("search", "search_batched"):
        _, ids = getattr(p, path)(extra[rows], 1)
        assert ids[:, 0].tolist() == (N + rows).tolist(), path


def test_compact_folds_the_delta_back(scenario):
    """compact() on both: the live rows, their ids kept through the sort
    permutation, no delta left; JAX's and the port's rebuilt layouts
    agree (the same numpy k-means at this sample size) and search
    alike; recall against the exact oracle over the live rows stays
    within JAX's own bound (0.01) of a fresh build's."""
    j = copy.deepcopy(scenario["j"])
    p = tivf.DeviceIVFInt8.from_state(ivf_state_from_jax(j), "cpu")
    live = scenario["live"]
    assert j.compact(sample_rows=2000) == p.compact(sample_rows=2000) \
        == len(live)
    assert p._dn == 0 and p._dbuf is None and p._next_id == N + N // 10
    assert sorted(p._row_ids.tolist()) == live.tolist()
    np.testing.assert_array_equal(p._row_ids, j._row_ids)
    qs = scenario["qs"]
    for path in ("search", "search_batched"):
        got = getattr(p, path)(qs, K, nprobe=8)
        _assert_search_close(got, getattr(j, path)(qs, K, nprobe=8))
        assert not np.isin(got[1], scenario["dead"]).any()
    lv = scenario["allv"][live]
    ln = lv / np.linalg.norm(lv, axis=1, keepdims=True)
    qn = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    oracle = live[np.argsort(-(qn @ ln.T), axis=1)[:, :K]]

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, oracle)])

    q8, sc, _ = p._quant_rows(lv)
    fresh = tivf.DeviceIVFInt8(D, n_clusters=16, nprobe=16, iters=8,
                               device="cpu")
    fresh.build(q8, sc, sample_rows=2000, fixed_window=256)
    r_fresh = recall(live[fresh.search(qs, K, nprobe=8)[1]])
    assert recall(p.search(qs, K, nprobe=8)[1]) >= r_fresh - 0.01


def test_deleted_rows_never_come_back():
    """Nearly every row tombstoned: fewer live rows are probed than k,
    and the hits end in -1 / -inf rather than a deleted row."""
    rng = np.random.default_rng(3)
    v = rng.standard_normal((1024, D)).astype(np.float32)
    q8, sc = (np.asarray(a) for a in jquant.scalar_quantize(jnp.asarray(v)))
    j = jivf.DeviceIVFInt8(D, n_clusters=4, nprobe=4)
    j.build(q8, sc, sample_rows=1024, fixed_window=256)
    p = tivf.DeviceIVFInt8.from_state(ivf_state_from_jax(j), "cpu")
    keep = np.array([5, 700])
    dead = np.setdiff1d(np.arange(1024), keep)
    for ix in (j, p):
        ix.add(v[:3])
        ix.delete(dead)
        ix.delete([1024])
    for path in ("search", "search_batched"):
        s_g, i_g = getattr(p, path)(v[:4], K)
        _assert_search_close((s_g, i_g), getattr(j, path)(v[:4], K))
        assert set(i_g[i_g >= 0].tolist()) <= {5, 700, 1025, 1026}
        assert (i_g == -1).any() and np.isneginf(s_g[i_g == -1]).all()


def test_delete_leaves_a_shared_layout_alone():
    """An index assembled from another's tensors (``from_device_layout``)
    tombstones into its own copy of the multipliers."""
    rng = np.random.default_rng(4)
    v = rng.standard_normal((512, D)).astype(np.float32)
    q8, sc, _ = tivf.DeviceIVFInt8._quant_rows(v)
    a = tivf.DeviceIVFInt8(D, n_clusters=2, nprobe=2, device="cpu")
    a.build(q8, sc, sample_rows=512, fixed_window=256)
    b = tivf.DeviceIVFInt8.from_device_layout(
        D, a.centroids, a._buf, a._rmult, a._starts, a._row_ids, a._window,
        scale=a._scale, fixed=True)
    before = a._rmult.clone()
    assert b.delete(np.arange(100)) == 100 and b._next_id == 512
    assert torch.equal(a._rmult, before)
    assert int((b._rmult == 0).sum()) == 100

"""The port's windowed int8 IVF (neumann_tpu_torch/ops/ivf.py) against
the JAX package's DeviceIVFInt8 on one layout.

A JAX-built index is carried over with convert.ivf_state_from_jax and
DeviceIVFInt8.from_state, so both packages search the same layout
(their device k-means inits differ by construction). The JAX side runs
on the CPU as its own tests run it: the XLA windowed core for
``search``, the Pallas top-2 kernel in interpret mode for
``search_batched``.

Tolerance: scores within 1e-5 (exact f32 rerank in both, summed in
another order); ids must match wherever scores differ by more than that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumann_tpu.ops import ivf as jivf
from neumann_tpu_torch.convert import IVF_STATE_KEYS, ivf_state_from_jax
from neumann_tpu_torch.ops import ivf as tivf

TOL = 1e-5


def _clustered(n, d, k, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((k, d)).astype(np.float32) * 3
    return (m[rng.integers(0, k, n)]
            + 0.3 * rng.standard_normal((n, d))).astype(np.float32)


def _int8(v):
    am = np.max(np.abs(v), axis=1)
    sc = np.where(am > 0, am / 127.0, 1.0).astype(np.float32)
    q8 = np.clip(np.round(v / sc[:, None]), -127, 127).astype(np.int8)
    res = v - q8.astype(np.float32) * sc[:, None]
    ram = np.max(np.abs(res), axis=1)
    rsc = np.where(ram > 0, ram / 127.0, 1.0).astype(np.float32)
    rq = np.clip(np.round(res / rsc[:, None]), -127, 127).astype(np.int8)
    return q8, sc, rq, rsc


@pytest.fixture(scope="module")
def built():
    """8,192 x 64 clustered rows, 16 k-means clusters -> 512-row fixed
    windows (pool 4), residual plane on; queries near corpus rows."""
    v = _clustered(8192, 64, 24, 0)
    q8, sc, rq, rsc = _int8(v)
    j = jivf.DeviceIVFInt8(64, n_clusters=16, nprobe=4)
    j.build(q8, sc, residual=(rq, rsc))
    rng = np.random.default_rng(1)
    qs = v[rng.choice(len(v), 40)] + 0.05 * rng.standard_normal(
        (40, 64)).astype(np.float32)
    port = tivf.DeviceIVFInt8.from_state(ivf_state_from_jax(j), "cpu")
    return dict(v=v, q8=q8, sc=sc, rq=rq, rsc=rsc, j=j, port=port, qs=qs)


def _assert_search_close(got, want):
    (s_g, i_g), (s_w, i_w) = got, want
    assert s_g.shape == s_w.shape
    np.testing.assert_array_equal(np.isneginf(s_g), np.isneginf(s_w))
    live = np.isfinite(s_w)
    np.testing.assert_allclose(s_g[live], s_w[live], rtol=0, atol=TOL)
    sep = np.ones_like(live)
    sep[:, 1:] &= np.abs(np.diff(s_w, axis=1)) > TOL
    sep[:, :-1] &= np.abs(np.diff(s_w, axis=1)) > TOL
    np.testing.assert_array_equal(i_g[sep & live], i_w[sep & live])


def test_state_round_trip(built):
    state = ivf_state_from_jax(built["j"])
    assert set(state) == set(IVF_STATE_KEYS)
    p = built["port"]
    assert p._window == built["j"]._window == 512
    assert p.nprobe == built["j"].nprobe and p._fixed
    np.testing.assert_array_equal(p._buf.numpy(), np.asarray(built["j"]._buf))
    assert p._rbuf is not None and p._buf.dtype == torch.int8


def test_search_matches_jax(built):
    qs = built["qs"][:5]
    _assert_search_close(built["port"].search(qs, 10),
                         built["j"].search(qs, 10))


def test_search_batched_matches_jax(built):
    qs = built["qs"]
    got = built["port"].search_batched(qs, 10)
    want = built["j"].search_batched(qs, 10)
    assert got[0].shape == (40, 10)
    _assert_search_close(got, want)


@pytest.mark.parametrize("presel", [0, 40])
def test_batched_ivf_topk_matches_jax(built, presel):
    """The candidate pass itself, probe_mode "exact", before rerank.
    The kernels are bit-identical (test_torch_kernels.py), but the
    query normalization sums in another order, so an int8 query scale
    may move by an ulp: scores within 1e-5, candidates (nearly) equal."""
    j, p = built["j"], built["port"]
    qs = built["qs"][:16]
    window, nprobe, q_cap = j._window, 4, 16
    s_w, p_w, o_w = jivf.batched_ivf_topk(
        j._buf, j._rmult, j.centroids, j._starts, jnp.asarray(qs), nprobe,
        window, 16, q_cap, selection=window // 128, fused="pallas",
        probe_mode="exact", presel=presel)
    s_g, p_g, o_g = tivf.batched_ivf_topk(
        p._buf, p._rmult, p.centroids, p._starts, torch.from_numpy(qs),
        nprobe, window, 16, q_cap, selection=window // 128, fused="pallas",
        probe_mode="exact", presel=presel)
    assert o_g == int(o_w) == 0
    s_w, p_w = np.asarray(s_w), np.asarray(p_w)
    s_g, p_g = s_g.numpy(), p_g.numpy()
    assert s_g.shape == s_w.shape
    same = []
    for r in range(qs.shape[0]):
        np.testing.assert_allclose(np.sort(s_g[r]), np.sort(s_w[r]),
                                   rtol=0, atol=TOL)
        same.append(len(set(p_g[r].tolist()) & set(p_w[r].tolist()))
                    / len(set(p_w[r].tolist())))
    assert np.mean(same) >= 0.99, np.mean(same)


def test_query_tables_overflow_and_ranks():
    probe = torch.tensor([[0, 1], [1, 2], [1, 0], [3, 1]], dtype=torch.int32)
    tbl, rank_of, overflow = tivf._query_tables(probe, 3, 2)
    # window 1 is probed by queries 0, 1, 2 and 3: the last two overflow
    # q_cap=2; window 3 is the drop sentinel (n_c = 3), never counted
    assert overflow == 2
    assert tbl[1].tolist() == [0, 1] and tbl[0].tolist() == [0, 2]
    assert rank_of.tolist() == [[0, 0], [1, 0], [2, 1], [0, 2]]


def test_port_build_matches_jax_layout(built):
    """Small samples train numpy k-means in both packages from the same
    seeding, and the f32 window assignment agrees: the same layout."""
    p = tivf.DeviceIVFInt8(64, n_clusters=16, nprobe=4, device="cpu")
    p.build(built["q8"], built["sc"], residual=(built["rq"], built["rsc"]))
    j = built["j"]
    assert (p._window, p.nprobe, p.n_clusters) == \
        (j._window, j.nprobe, j.n_clusters)
    same = np.mean(p._row_ids == np.asarray(j._row_ids))
    assert same > 0.99, same
    np.testing.assert_allclose(p.centroids.numpy(), np.asarray(j.centroids),
                               atol=1e-4)
    # recall@10 of the port's own index against the exact f32 oracle
    v, qs = built["v"], built["qs"]
    vn = v / np.linalg.norm(v, axis=1, keepdims=True)
    truth = np.argsort(-(qs @ vn.T), axis=1)[:, :10]
    _, ids = p.search(qs, 10)
    rec = np.mean([len(set(truth[r]) & set(ids[r])) / 10
                   for r in range(len(qs))])
    assert rec >= 0.95, rec


def test_legacy_layout_dedups():
    v = _clustered(3000, 32, 6, 2)
    q8, sc, _, _ = _int8(v)
    p = tivf.DeviceIVFInt8(32, n_clusters=6, nprobe=3, device="cpu")
    p.build(q8, sc, fixed_window=None)
    assert not p._fixed and p._window % 128 == 0
    s, ids = p.search(v[:4], 10)
    for r in range(4):
        live = ids[r][ids[r] >= 0]
        assert len(set(live.tolist())) == live.size
        assert ids[r][0] == r
    # the batched path takes the non-fast variant here (windows overlap)
    # and dedups the same way
    s, ids = p.search_batched(v[:40], 10)
    for r in range(40):
        live = ids[r][ids[r] >= 0]
        assert len(set(live.tolist())) == live.size
        assert ids[r][0] == r


def test_unported_paths_raise(built):
    """Every path of the JAX index is ported now (mutation, k above the
    fast path's 128): what still raises is what raises in JAX too."""
    p = tivf.DeviceIVFInt8.from_state(ivf_state_from_jax(built["j"]), "cpu")
    assert p.add(built["v"][:2]).tolist() == [8192, 8193]
    assert p.delete([1]) == 1 and p.n_live == 8193
    assert p.search_batched(built["qs"], 129)[1].shape == (40, 129)
    no_scale = tivf.DeviceIVFInt8.from_device_layout(
        64, p.centroids, p._buf, p._rmult, p._starts, p._row_ids,
        p._window, fixed=True)
    with pytest.raises(ValueError, match="per-row scales"):
        no_scale.compact()
    with pytest.raises(ValueError, match="build"):
        tivf.DeviceIVFInt8(64, device="cpu").add(built["v"][:2])
    j2 = jivf.DeviceIVFInt8(64, n_clusters=4, nprobe=2)
    with pytest.raises(ValueError, match="not built"):
        ivf_state_from_jax(j2)

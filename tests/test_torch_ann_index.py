"""The port's legacy IVF index (neumann_tpu_torch/ops/ivf.IVFIndex) and the
engine's ANN index APIs (build_ivf_index, search_with_ivf_nprobe,
save_index / load_index) against the JAX package's, on the CPU.

Below the device k-means threshold both packages train the same numpy
k-means from the same seed, so an index built from the same rows has the
same centroids, layout and row ids; a JAX index is also carried across
with ``convert.ivf_index_from_jax``. Searches in the flat, pq and binary
storages must give equal ids in ``lax.top_k``'s order (ties by candidate
position) with scores within 1e-5; the pq storage runs the ADC kernel's
plain version in its gathered mode here. A JAX engine's ``save_index``
``.npz`` loads into the port's ``load_index`` (and back) with the same
hits; corrupt files raise VectorError.
"""

import numpy as np
import pytest
import torch

from neumann_tpu.engines.vector import VectorEngine as JEngine
from neumann_tpu.ops import ivf as jivf
from neumann_tpu.utils.errors import VectorError as JVectorError
from neumann_tpu_torch.convert import ivf_index_from_jax
from neumann_tpu_torch.engines.vector import VectorEngine as TEngine
from neumann_tpu_torch.ops import ivf as tivf
from neumann_tpu_torch.utils.errors import VectorError

TOL = 1e-5
STORAGES = ("flat", "pq", "binary")


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((16, d)).astype(np.float32)
    x = (c[rng.integers(0, 16, n)]
         + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    x[60:66] = x[9]                    # duplicated rows tie exactly
    q = (x[rng.integers(0, n, 8)]
         + 0.02 * rng.standard_normal((8, d))).astype(np.float32)
    return x, np.concatenate([q, x[9:10]])


def _cfg(mod, storage):
    return mod.IVFConfig(n_clusters=16, nprobe=4, storage=storage,
                         pq_subspaces=8)


def _same(js, ji, ts, ti):
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(js)
    assert np.array_equal(fin, np.isfinite(ts))
    np.testing.assert_allclose(ts[fin], js[fin], rtol=TOL, atol=TOL)


def test_padded_layout_matches_jax():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((300, 8)).astype(np.float32)
    assign = rng.integers(0, 7, 300)
    assign[assign == 5] = 4                       # an empty cluster
    jb, jids, jstride = jivf._padded_layout(v, assign, 7)
    tb, tids, tstride = tivf._padded_layout(
        torch.from_numpy(v), torch.from_numpy(assign), 7)
    assert jstride == tstride
    assert np.array_equal(jb, tb.numpy()) and np.array_equal(jids,
                                                             tids.numpy())
    _, _, wide = tivf._padded_layout(torch.from_numpy(v),
                                     torch.from_numpy(assign), 7, 101)
    assert wide == 104


@pytest.mark.parametrize("storage", STORAGES)
def test_ivf_index_builds_and_searches_like_jax(storage):
    """Train, a first add (the layout), an append into the slack, and an
    add that overflows a cluster (the stride-doubling relayout): equal
    state and equal searches after each."""
    x, q = _data(4096, 64, 1)
    j = jivf.IVFIndex(64, _cfg(jivf, storage))
    t = tivf.IVFIndex(64, _cfg(tivf, storage), device="cpu")
    for ix in (j, t):
        ix.train(x)
    assert np.array_equal(j.centroids, t.centroids)
    extra = np.repeat(x[:1], 1200, axis=0) + 0.01   # all in one cluster
    for part in (x[:3000], x[3000:3100], extra):
        assert np.array_equal(j.add(part), t.add(part))
        assert j._stride == t._stride and j.n_vectors == t.n_vectors
        assert np.array_equal(j._row_ids, t._row_ids)
        for k, nprobe in ((10, 4), (30, 2)):
            _same(*j.search(q, k, nprobe), *t.search(q, k, nprobe))
    assert j._stride >= 2 * 1200
    assert t.add(x[0]) == j.add(x[0]) == j.n_vectors - 1
    _same(*j.search_with_nprobe(q[0], 7, 3),
          *t.search_with_nprobe(q[0], 7, 3))


@pytest.mark.parametrize("storage", STORAGES)
def test_ivf_index_from_jax_state(storage):
    x, q = _data(3000, 64, 2)
    j = jivf.IVFIndex(64, _cfg(jivf, storage))
    j.train(x)
    j.add(x[:2500])
    t = ivf_index_from_jax(j, device="cpu")
    plane = {"flat": t._reordered, "pq": t._codes, "binary": t._bits}
    assert plane[storage].dtype == {"flat": torch.float32,
                                    "pq": torch.uint8,
                                    "binary": torch.int32}[storage]
    _same(*j.search(q, 12), *t.search(q, 12))
    for ix in (j, t):
        ix.add(x[2500:])
    _same(*j.search(q, 12, 6), *t.search(q, 12, 6))


def _engines(n=2048, d=64):
    x, q = _data(n, d, 3)
    engines = (JEngine(), TEngine(device="cpu"))
    for e in engines:
        with e.bulk_ingest():
            for i, v in enumerate(x):
                e.store_embedding(f"k{i}", v)
    return x, q, engines


def _hits(res):
    return [(h.key, h.score) for h in res]


def _same_hits(a, b):
    assert [k for k, _ in a] == [k for k, _ in b], (a, b)
    for (_, s), (_, t) in zip(a, b):
        assert abs(s - t) <= TOL


def test_engine_ivf_api_and_saved_index(tmp_path):
    x, q, (je, te) = _engines()
    with pytest.raises(VectorError):
        te.search_with_ivf_nprobe(q[0], 5, 2)
    with pytest.raises(VectorError):
        te.save_index(tmp_path / "none.npz")
    assert je.build_ivf_index(16, 4) == te.build_ivf_index(16, 4) == 2048
    q = q[-4:]
    for qq in q:
        for nprobe in (1, 4):
            _same_hits(_hits(je.search_with_ivf_nprobe(qq, 10, nprobe)),
                       _hits(te.search_with_ivf_nprobe(qq, 10, nprobe)))
        # no HNSW graph: the hnsw entry falls through to the IVF index
        _same_hits(_hits(je.search_with_hnsw(qq, 6)),
                   _hits(te.search_with_hnsw(qq, 6)))
    je.save_index(tmp_path / "j.npz")
    te.save_index(tmp_path / "t.npz")
    _, _, (je2, te2) = _engines()
    assert te2.load_index(tmp_path / "j.npz") == 2048
    assert je2.load_index(tmp_path / "t.npz") == 2048
    for qq in q:
        want = _hits(je.search_with_ivf_nprobe(qq, 10, 4))
        _same_hits(want, _hits(te2.search_with_ivf_nprobe(qq, 10, 4)))
        _same_hits(want, _hits(je2.search_with_ivf_nprobe(qq, 10, 4)))


def test_load_index_errors(tmp_path):
    _, q, (je, te) = _engines(600)
    je.build_ivf_index(8, 2)
    je.save_index(tmp_path / "ok.npz")
    blob = (tmp_path / "ok.npz").read_bytes()
    (tmp_path / "torn.npz").write_bytes(blob[: len(blob) // 2])
    (tmp_path / "junk.npz").write_bytes(b"not a zip file at all")
    np.savez(tmp_path / "partial.npz", dim=np.int64(64))
    for name in ("torn.npz", "junk.npz", "partial.npz"):
        with pytest.raises(JVectorError):
            je.load_index(tmp_path / name)
        with pytest.raises(VectorError):
            te.load_index(tmp_path / name)
    # an index of a dimension the engine does not hold
    other = TEngine(device="cpu")
    other.store_embedding("a", np.ones(32, np.float32))
    with pytest.raises(VectorError):
        other.load_index(tmp_path / "ok.npz")
    with pytest.raises(VectorError):
        TEngine(device="cpu").build_ivf_index()

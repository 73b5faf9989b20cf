"""The port's HNSW index (neumann_tpu_torch/ops/hnsw.py, its native core
neumann_tpu_torch/native/hnsw_native.cpp) and the engine's HNSW API
against the JAX package's, on the CPU.

Both packages' native cores are the same C++ and their fallbacks the
same Python, so the same seed and the same inserts give the same
``to_bytes()`` (native against native, fallback against fallback) in
every insert mode: dense, quantized, binary, sparse, auto and TT. Either
package reads the other's bytes, native or fallback, and the searches,
stats and memory accounting agree. The engine's ``build_hnsw_index`` /
``search_with_hnsw(_ef)`` / ``save_index`` / ``load_index`` give the same
hits through both engines, and a saved index loads across packages.
"""

import numpy as np
import pytest

from neumann_tpu import native as jnative
from neumann_tpu.engines.vector import VectorEngine as JEngine
from neumann_tpu.ops import hnsw as jh
from neumann_tpu.store.sparse import SparseVector as JSparse
from neumann_tpu_torch import native as tnative
from neumann_tpu_torch.convert import hnsw_from_jax
from neumann_tpu_torch.engines.vector import VectorEngine as TEngine
from neumann_tpu_torch.ops import hnsw as th
from neumann_tpu_torch.store.sparse import SparseVector as TSparse
from neumann_tpu_torch.utils.errors import VectorError

D = 64
MODES = ("dense", "quantized", "binary", "sparse", "auto", "tt", "mixed")


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((8, D)).astype(np.float32)
    x = (c[rng.integers(0, 8, n)]
         + 0.4 * rng.standard_normal((n, D))).astype(np.float32)
    sparse = x.copy()
    sparse[rng.random((n, D)) < 0.8] = 0.0        # past the auto threshold
    x[1::5] = sparse[1::5]
    return x, sparse


def _fill(mod, sparse_cls, mode, x, sparse, cfg=None):
    ix = mod.HNSWIndex(D, cfg or mod.HNSWConfig(m=8, ef_construction=64),
                       seed=1234)
    for i, (v, s) in enumerate(zip(x, sparse)):
        pick = mode if mode != "mixed" else MODES[i % 6]
        if pick == "dense":
            ix.insert(v)
        elif pick == "quantized":
            ix.insert_quantized(v)
        elif pick == "binary":
            ix.insert_binary(v)
        elif pick == "sparse":
            ix.insert_sparse(sparse_cls.from_dense(s))
        elif pick == "auto":
            ix.insert_auto(v)
        else:
            ix.insert_tt(v)
    return ix


def _searches(ix, q, sparse_cls, sparse):
    out = [ix.search(qq, 10) for qq in q]
    out += [ix.search_with_ef(qq, 5, 80) for qq in q[:3]]
    out.append(ix.search_sparse(sparse_cls.from_dense(sparse[0]), 7))
    return out


@pytest.fixture
def fallback(monkeypatch):
    """Both packages without their native library (the pure-Python
    _PyHnsw)."""
    monkeypatch.setattr(jnative, "load", lambda: None)
    monkeypatch.setattr(tnative, "load", lambda: None)


@pytest.mark.parametrize("mode", MODES)
def test_native_bytes_and_hits_equal(mode):
    assert jnative.load() is not None and tnative.load() is not None
    x, sparse = _data(400, 1)
    q = x[:6] + 0.05
    j = _fill(jh, JSparse, mode, x, sparse)
    t = _fill(th, TSparse, mode, x, sparse)
    assert t._py is None and j.to_bytes() == t.to_bytes()
    assert _searches(j, q, JSparse, sparse) == _searches(t, q, TSparse,
                                                         sparse)
    assert j.memory_stats() == t.memory_stats()
    assert j.access_stats() == t.access_stats()
    assert np.array_equal(j.get(7), t.get(7)) and t.get(10 ** 6) is None


@pytest.mark.parametrize("mode", ("dense", "quantized", "binary", "mixed"))
def test_fallback_bytes_and_hits_equal(fallback, mode):
    x, sparse = _data(150, 2)
    q = x[:4] + 0.05
    j = _fill(jh, JSparse, mode, x, sparse)
    t = _fill(th, TSparse, mode, x, sparse)
    assert t._py is not None and j.to_bytes() == t.to_bytes()
    assert _searches(j, q, JSparse, sparse) == _searches(t, q, TSparse,
                                                         sparse)
    assert j.memory_stats() == t.memory_stats()


@pytest.mark.parametrize("metric", ("cosine", "euclidean", "dot"))
def test_cross_loads_both_ways(metric, monkeypatch, tmp_path):
    x, sparse = _data(300, 3)
    q = x[:5] + 0.05
    cfg = jh.HNSWConfig(m=8, ef_construction=64, metric=metric)
    j = _fill(jh, JSparse, "mixed", x, sparse, cfg)
    t = hnsw_from_jax(j)
    want = _searches(j, q, JSparse, sparse)
    assert _searches(t, q, TSparse, sparse) == want
    assert t.to_bytes() == j.to_bytes()
    j.save(tmp_path / "j.hnsw")
    back = jh.HNSWIndex.load(tmp_path / "j.hnsw")
    t.save(tmp_path / "t.hnsw")
    assert (tmp_path / "t.hnsw").read_bytes() == \
        (tmp_path / "j.hnsw").read_bytes()
    assert _searches(jh.HNSWIndex.load(tmp_path / "t.hnsw"), q, JSparse,
                     sparse) == _searches(back, q, JSparse, sparse)
    # native bytes into either fallback, and back
    monkeypatch.setattr(jnative, "load", lambda: None)
    monkeypatch.setattr(tnative, "load", lambda: None)
    tp = th.HNSWIndex.from_bytes(j.to_bytes())
    jp = jh.HNSWIndex.from_bytes(t.to_bytes())
    assert tp._py is not None and jp._py is not None
    assert tp.to_bytes() == jp.to_bytes()
    assert [h[0] for h in tp.search(q[0], 10)] == \
        [h[0] for h in jp.search(q[0], 10)]
    monkeypatch.undo()
    assert th.HNSWIndex.from_bytes(tp.to_bytes()).to_bytes() == \
        jh.HNSWIndex.from_bytes(jp.to_bytes()).to_bytes()


def test_corrupt_blobs_raise():
    x, sparse = _data(50, 4)
    blob = _fill(th, TSparse, "mixed", x, sparse).to_bytes()
    for bad in (b"XXXX" + blob[4:], blob[:40], blob[:24] + b"\xff" * 8):
        with pytest.raises(ValueError):
            th.HNSWIndex.from_bytes(bad)
    ix = th.HNSWIndex(D)
    with pytest.raises(ValueError):
        ix.insert(np.ones(D + 1, np.float32))
    with pytest.raises(ValueError):
        ix.insert(np.full(D, np.nan, np.float32))
    with pytest.raises(ValueError):
        th.HNSWConfig(metric="manhattan")
    full = th.HNSWIndex(D, th.HNSWConfig(max_nodes=2))
    full.insert(x[0])
    full.insert(x[1])
    with pytest.raises(OverflowError):
        full.insert(x[2])


def _engines(n=1500):
    x, _ = _data(n, 5)
    engines = (JEngine(), TEngine(device="cpu"))
    for e in engines:
        with e.bulk_ingest():
            for i, v in enumerate(x):
                e.store_embedding(f"k{i}", v)
    return x, engines


def _hits(res):
    return [(h.key, h.score) for h in res]


@pytest.mark.parametrize("storage,metric", [
    ("dense", "cosine"), ("quantized", "euclidean"), ("binary", "dot"),
    ("auto", "cosine")])
def test_engine_hnsw_api_and_saved_index(storage, metric, tmp_path):
    x, (je, te) = _engines(800)
    q = x[:6] + 0.03
    for e in (je, te):
        assert e.build_hnsw_index(m=8, ef_construction=80, metric=metric,
                                  storage=storage) == 800
    assert je._hnsw[0].to_bytes() == te._hnsw[0].to_bytes()
    for qq in q:
        assert _hits(je.search_with_hnsw(qq, 10)) == \
            _hits(te.search_with_hnsw(qq, 10))
        assert _hits(je.search_with_hnsw_ef(qq, 4, 120)) == \
            _hits(te.search_with_hnsw_ef(qq, 4, 120))
    je.save_index(tmp_path / "j.npz")
    te.save_index(tmp_path / "t.npz")
    _, (je2, te2) = _engines(800)
    assert te2.load_index(tmp_path / "j.npz") == 800
    assert je2.load_index(tmp_path / "t.npz") == 800
    for qq in q:
        want = _hits(je.search_with_hnsw(qq, 10))
        assert _hits(te2.search_with_hnsw(qq, 10)) == want
        assert _hits(je2.search_with_hnsw(qq, 10)) == want


def test_engine_hnsw_errors():
    _, (je, te) = _engines(50)
    for kw in ({"storage": "tt"}, {"metric": "manhattan"}):
        with pytest.raises(VectorError):
            te.build_hnsw_index(**kw)
    with pytest.raises(VectorError):
        TEngine(device="cpu").build_hnsw_index()

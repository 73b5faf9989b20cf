"""The port's compress package (neumann_tpu_torch/compress) against the
JAX package's (neumann_tpu/compress).

``tensor_train``, ``codecs`` and ``streaming_tt`` are copies: the same
inputs give bit-identical cores and equal bytes. ``tt_batch`` decomposes
many rows at once in torch (the engine's tt route): its reconstructions
must be within 1e-5 (relative to the row's largest entry) of numpy's
``tt_reconstruct(tt_decompose(row))``, on random rows, low-rank rows,
zero rows and rows whose singular values sit at the rank cut.
Cores are never compared across the two: SVD signs are free.
"""

import numpy as np
import pytest
import torch

from neumann_tpu.compress import codecs as jcodecs
from neumann_tpu.compress import streaming_tt as jstream
from neumann_tpu.compress import tensor_train as jtt
from neumann_tpu_torch.compress import codecs as tcodecs
from neumann_tpu_torch.compress import streaming_tt as tstream
from neumann_tpu_torch.compress import tensor_train as ttt
from neumann_tpu_torch.compress.tt_batch import tt_decompose_batch, tt_rank

RTOL = 1e-5
CONFIGS = ("for_dim", "high_compression", "high_accuracy")


def _cfg(mod, name, dim):
    return getattr(mod.TTConfig, name)(dim)


def _rows(n, dim, seed):
    """Random rows, low-rank rows (rank 1 and 2 outer products), a zero
    row and duplicated rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    x[: n // 4] = np.outer(rng.standard_normal(n // 4),
                           rng.standard_normal(dim))
    x[n // 4: n // 2] += np.outer(rng.standard_normal(n // 4),
                                  rng.standard_normal(dim)) * 5
    x[3] = 0.0
    x[7:10] = x[11]
    return x.astype(np.float32)


def _rel_err(got, want):
    scale = np.maximum(np.abs(want).max(axis=1), 1e-30)
    return (np.abs(got - want).max(axis=1) / scale).max()


@pytest.mark.parametrize("dim", [64, 100, 768])
@pytest.mark.parametrize("cfg", CONFIGS)
def test_tt_cores_equal_between_copies(dim, cfg):
    for row in _rows(16, dim, dim):
        a = jtt.tt_decompose(row, _cfg(jtt, cfg, dim))
        b = ttt.tt_decompose(row, _cfg(ttt, cfg, dim))
        assert len(a.cores) == len(b.cores)
        for ca, cb in zip(a.cores, b.cores):
            assert ca.dtype == cb.dtype and np.array_equal(ca, cb)
        assert np.array_equal(jtt.tt_reconstruct(a), ttt.tt_reconstruct(b))
        assert jtt.tt_dot(a, a) == ttt.tt_dot(b, b)
        assert jtt.tt_cosine_similarity(a, a) == \
            ttt.tt_cosine_similarity(b, b)


@pytest.mark.parametrize("dim", [64, 128, 100, 768])
@pytest.mark.parametrize("cfg", CONFIGS)
def test_tt_batch_reconstructs_like_numpy(dim, cfg):
    x = _rows(96, dim, 7 + dim)
    config = _cfg(ttt, cfg, dim)
    tb = tt_decompose_batch(torch.from_numpy(x), config, chunk_rows=40)
    got = tb.reconstruct().numpy()
    want = np.stack([jtt.tt_reconstruct(jtt.tt_decompose(
        r, _cfg(jtt, cfg, dim))) for r in x])
    assert got.shape == want.shape and got.dtype == np.float32
    assert _rel_err(got, want) <= RTOL
    assert tb.n == 96 and sorted(torch.cat(
        [g.rows for g in tb.groups]).tolist()) == list(range(96))
    # the per-row ranks are numpy's wherever the cut is not at a tie
    for g in tb.groups:
        for r in g.rows.tolist()[:4]:
            assert jtt.tt_decompose(x[r], _cfg(jtt, cfg, dim)).ranks == \
                list(g.ranks)


def test_tt_rank_rule_at_the_cutoff():
    """The batched cut is tt_decompose's: strictly above max(s0 * tol,
    1e-12), capped, at least 1 — checked on singular values exactly at
    the cutoff, one ulp above it and at the absolute floor."""
    tol, cap = 1e-3, 16
    cut = 1.0 * tol
    cases = [
        [1.0, cut, 0.0],
        [1.0, np.nextafter(cut, 1.0), 0.0],
        [1.0, np.nextafter(cut, 0.0), 0.0],
        [1e-13, 1e-14, 0.0],
        [1e-9, 1e-12, 0.0],
        [1e-9, np.nextafter(1e-12, 1.0), 0.0],
        [0.0, 0.0, 0.0],
        [5.0] * 20,
    ]
    for s in cases:
        s = np.asarray(s, np.float64)
        cutoff = max(s[0] * tol, 1e-12)
        want = max(min(cap, int(np.sum(s > cutoff)), len(s)), 1)
        got = int(tt_rank(torch.from_numpy(s)[None, :], tol, cap)[0])
        assert got == want, (s, got, want)


def test_tt_batch_row_at_the_rank_cutoff():
    """Rows whose trailing singular values sit at the cut (the 1e-12
    floor, or s0 * tol): either rank reconstructs within the tolerance,
    and rows cut at tol agree with numpy's cut row."""
    dim = 64
    cfg = ttt.TTConfig.for_dim(dim)
    g0 = cfg.grid[0]
    rng = np.random.default_rng(3)
    rows = []
    for second in (1e-12, 1e-12 * (1 + 1e-15), 0.5e-3, 2e-3):
        u, _ = np.linalg.qr(rng.standard_normal((g0, 2)))
        v, _ = np.linalg.qr(rng.standard_normal((dim // g0, 2)))
        m = u @ np.diag([1.0, second]) @ v.T
        rows.append(m.reshape(dim))
    x = np.asarray(rows, np.float32)
    got = tt_decompose_batch(torch.from_numpy(x), cfg).reconstruct().numpy()
    want = np.stack([jtt.tt_reconstruct(jtt.tt_decompose(r, cfg))
                     for r in x])
    assert _rel_err(got, want) <= RTOL


def test_codecs_equal_bytes():
    rng = np.random.default_rng(0)
    values = [0, 1, 127, 128, 300, 2 ** 35] + rng.integers(
        0, 2 ** 40, 200).tolist()
    ids = sorted(set(rng.integers(0, 10 ** 6, 300).tolist()))
    data = bytes(rng.integers(0, 3, 1000).astype(np.uint8)) + b"\x07" * 600
    for fn, arg in (("varint_encode", values), ("delta_encode_ids", ids),
                    ("rle_encode", data)):
        a, b = getattr(jcodecs, fn)(arg), getattr(tcodecs, fn)(arg)
        assert a == b, fn
    assert tcodecs.varint_decode(jcodecs.varint_encode(values)) == values
    assert tcodecs.delta_decode_ids(jcodecs.delta_encode_ids(ids)) == ids
    assert tcodecs.rle_decode(jcodecs.rle_encode(data)) == data
    with pytest.raises(ValueError):
        tcodecs.varint_decode(b"\x80")


def test_streaming_tt_equal_files_both_ways(tmp_path):
    x = _rows(12, 96, 5)
    paths = []
    for mod, name in ((jstream, "j.ntts"), (tstream, "t.ntts")):
        path = tmp_path / name
        with mod.StreamingTTWriter(path, 96) as w:
            for i, row in enumerate(x):
                w.add(f"k{i}", row)
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    got = list(tstream.stream_dense(paths[0]))
    want = list(jstream.stream_dense(paths[1]))
    assert [k for k, _ in got] == [k for k, _ in want] == [
        f"k{i}" for i in range(12)]
    for (_, a), (_, b) in zip(got, want):
        assert np.array_equal(a, b)
    # a torn tail stops both readers at the same record
    blob = paths[1].read_bytes()
    torn = tmp_path / "torn.ntts"
    torn.write_bytes(blob[:-7])
    assert len(list(tstream.stream_tt(torn))) == \
        len(list(jstream.stream_tt(torn))) == 11

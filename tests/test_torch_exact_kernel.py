"""The exact int8 scan (``ops/quant.int8_exact_topk``, kernel 9:
``csrc/int8_exact.cu`` on the card, its plain version here) against the
JAX package's jitted ``int8_exact_topk``, and the IVF delta plane that
scans its filled slots with it.

The same numpy inputs go through both packages on the CPU: k 1, 10, 64
and 65 (both sides of the kernel's select-mode cap), Q 1, 16 and 17
(both sides of its stream / batch switch), d 64 and 100 (d % 16 != 0),
N 700 (not a multiple of its 128- and 256-row tiles), 10 % dead rows, a
plane with fewer live rows than k, and one row copied 80 times from row
120 on, so its copies straddle a 128-row tile and the k-th place at
every k. The kernel's arithmetic runs on the card only; its edges
against the plain version are in tests/test_torch_kernel_edges.py.

Tolerance: scores within 1e-5 (f32 sums in another order); ids equal
wherever a score is more than that from its neighbours'; rows of equal
scores (the copies: bit-equal in one package) in ascending order, with
no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumann_tpu.ops import ivf as jivf
from neumann_tpu.ops import quant as jquant
from neumann_tpu_torch.convert import ivf_state_from_jax
from neumann_tpu_torch.ops import ivf as tivf
from neumann_tpu_torch.ops import kernels as tk
from neumann_tpu_torch.ops import quant as tquant
from tests.test_torch_ivf_batched import _assert_search_close

TOL = 1e-5
N = 700
COPY0, COPIES = 120, 80

_jax_exact = jax.jit(jquant.int8_exact_topk,
                     static_argnames=("k", "block_rows"))


def _plane(d: int, live: float, seed: int):
    """(int8 rows, cosine multipliers, queries 0..16): row COPY0 copied
    COPIES times in a row, its copies live; query 0 that row itself."""
    rng = np.random.default_rng(seed)
    q8 = rng.integers(-127, 128, (N, d)).astype(np.int8)
    q8[COPY0:COPY0 + COPIES] = q8[COPY0]
    sc = (rng.random(N) * 0.02 + 0.01).astype(np.float32)
    sc[COPY0:COPY0 + COPIES] = sc[COPY0]
    rm = np.asarray(jquant.int8_cosine_row_mult(jnp.asarray(q8),
                                                jnp.asarray(sc)))
    dead = rng.random(N) >= live
    dead[COPY0:COPY0 + COPIES] = live < 0.5
    rm = np.where(dead, 0.0, rm).astype(np.float32)
    qs = rng.standard_normal((17, d)).astype(np.float32)
    qs[0] = q8[COPY0]
    return q8, rm, qs


def _ties_ascend(s: np.ndarray, i: np.ndarray) -> None:
    """Within each run of bit-equal finite scores, rows ascend."""
    for srow, irow in zip(s, i):
        same = (srow[1:] == srow[:-1]) & np.isfinite(srow[1:])
        assert (irow[1:][same] > irow[:-1][same]).all(), (srow, irow)


@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("q", [1, 16, 17])
@pytest.mark.parametrize("k", [1, 10, 64, 65])
def test_exact_topk_matches_jax(k, q, d):
    """Scores within 1e-5, ids in ``lax.top_k``'s order: the copies of
    row COPY0 first for query 0, by ascending row, across the k-th
    place; equal scores ascend everywhere."""
    q8, rm, qs = _plane(d, 0.9, seed=d + k)
    s_w, i_w = _jax_exact(jnp.asarray(q8), jnp.asarray(rm),
                          jnp.asarray(qs[:q]), k, block_rows=256)
    s_g, i_g = tquant.int8_exact_topk(torch.from_numpy(q8),
                                      torch.from_numpy(rm),
                                      torch.from_numpy(qs[:q]), k)
    s_g, i_g = s_g.numpy(), i_g.numpy()
    _assert_search_close((s_g, i_g), (np.asarray(s_w), np.asarray(i_w)))
    _ties_ascend(s_g, i_g)
    want = list(range(COPY0, COPY0 + min(k, COPIES)))
    assert i_g[0, :len(want)].tolist() == want
    assert np.asarray(i_w)[0, :len(want)].tolist() == want


@pytest.mark.parametrize("k", [10, 64, 65])
def test_exact_topk_fewer_live_rows_than_k(k):
    """5 % live rows and the copies dead: the live rows' hits, then
    -inf / -1, as the JAX package gives them."""
    q8, rm, qs = _plane(64, 0.05, seed=k)
    rm[np.flatnonzero(rm > 0)[k // 2:]] = 0.0      # fewer than k live
    n_live = int((rm > 0).sum())
    assert 0 < n_live <= k // 2
    s_w, i_w = _jax_exact(jnp.asarray(q8), jnp.asarray(rm), jnp.asarray(qs),
                          k, block_rows=128)
    s_g, i_g = tquant.int8_exact_topk(torch.from_numpy(q8),
                                      torch.from_numpy(rm),
                                      torch.from_numpy(qs), k)
    s_w, i_w = np.asarray(s_w), np.asarray(i_w)
    _assert_search_close((s_g.numpy(), i_g.numpy()), (s_w, i_w))
    assert (i_g.numpy()[:, n_live:] == -1).all()
    np.testing.assert_array_equal(i_g.numpy() == -1, i_w == -1)


def test_exact_topk_all_dead_and_empty():
    q8, rm, qs = _plane(64, 0.0, seed=1)
    rm[:] = 0.0
    s, i = tquant.int8_exact_topk(torch.from_numpy(q8), torch.from_numpy(rm),
                                  torch.from_numpy(qs[:3]), 10)
    assert np.isneginf(s.numpy()).all() and (i.numpy() == -1).all()
    s, i = tk.int8_exact_topk(torch.from_numpy(q8[:0]),
                              torch.from_numpy(rm[:0]),
                              torch.from_numpy(qs[:3]), 10)
    assert s.shape == i.shape == (3, 0)


@pytest.mark.parametrize("block_rows", [1, 128, 333, 1 << 20])
def test_block_rows_changes_no_result(block_rows):
    """``block_rows`` steps the plain version (and on the card the
    scores mode): the carry across blocks keeps the hits (the CPU's
    matmul may sum a block of one row in another order: scores within
    1e-5), equal scores ascending."""
    q8, rm, qs = _plane(64, 0.9, seed=2)
    args = (torch.from_numpy(q8), torch.from_numpy(rm),
            torch.from_numpy(qs), 65)
    s0, i0 = tquant.int8_exact_topk(*args)
    s1, i1 = tquant.int8_exact_topk(*args, block_rows=block_rows)
    _assert_search_close((s1.numpy(), i1.numpy()), (s0.numpy(), i0.numpy()))
    _ties_ascend(s1.numpy(), i1.numpy())
    assert i1[0, :65].tolist() == list(range(COPY0, COPY0 + 65))


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    """A CPU tensor gets the plain version (no launch counted); a tensor
    on another device is refused, not taken by the plain version."""
    q8, rm, qs = _plane(64, 0.9, seed=3)
    qf = torch.nn.functional.normalize(torch.from_numpy(qs), dim=1)
    before = dict(tk.LAUNCHES)
    got = tk.int8_exact_topk(torch.from_numpy(q8), torch.from_numpy(rm),
                             qf, 10)
    want = tk.int8_exact_topk_plain(torch.from_numpy(q8),
                                    torch.from_numpy(rm), qf, 10)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tk.LAUNCHES == before
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.int8_exact_topk(torch.from_numpy(q8).to(meta),
                           torch.from_numpy(rm).to(meta), qf.to(meta), 10)
    with pytest.raises(ValueError, match="shapes"):
        tk.int8_exact_topk(torch.from_numpy(q8), torch.from_numpy(rm[1:]),
                           qf, 10)


@pytest.mark.parametrize("n", [1, 255, 256, 700, 419_430, 1 << 22])
@pytest.mark.parametrize("q", [1, 4, 16, 17, 1024, 5000])
@pytest.mark.parametrize("k,select", [(10, True), (64, True), (0, False)])
def test_exact_plan_covers_the_rows(n, q, k, select):
    """The plan the kernel validates, one for both modes and every k (the
    selection's shared memory does not grow with k): every row in one
    part, no empty part, whole 128-row tiles a part, at most one wave
    where the rows allow it: two blocks of 8 or 16 queries a SM up to 16
    queries, one block of 128 above."""
    parts, span = tk._exact_plan(n, q, sms=132)
    assert span % 128 == 0 and span >= 128
    assert parts * span >= n and (parts - 1) * span < n
    qblocks = 1 if q <= 16 else -(-q // 128)
    per_sm = 2 if q <= 16 else 1
    assert parts * qblocks <= max(per_sm * 132, qblocks)
    if n >= 1 << 22:
        assert parts * qblocks > (per_sm * 132) // 2
    nq = 8 if q <= 8 else (16 if q <= 16 else 128)
    assert tk._exact_block_queries(q) == (nq, qblocks * nq)


@pytest.fixture(scope="module")
def few_added():
    """A JAX index of 2,048 x 64 rows (8 clusters, 256-row windows) takes
    3 rows through ``add`` and loses one of them: 3 filled delta slots
    (2 live) in a plane of 1,024, fewer than k. The port gets it through
    ``convert.ivf_state_from_jax``."""
    rng = np.random.default_rng(5)
    modes = rng.standard_normal((8, 64)).astype(np.float32) * 3
    v = (modes[rng.integers(0, 8, 2051)]
         + 0.3 * rng.standard_normal((2051, 64))).astype(np.float32)
    cq, scale = jquant.scalar_quantize(jnp.asarray(v[:2048]))
    j = jivf.DeviceIVFInt8(64, n_clusters=8, nprobe=8, iters=8)
    j.build(np.asarray(cq), np.asarray(scale), sample_rows=2048,
            fixed_window=256)
    j.add(v[2048:])
    j.delete([2049])
    p = tivf.DeviceIVFInt8.from_state(ivf_state_from_jax(j), "cpu")
    assert p._dn == 3 and p._dbuf.shape[0] > p._dn
    qs = np.concatenate([v[2048:], v[:14] + 0.05]).astype(np.float32)
    return j, p, qs


@pytest.mark.parametrize("k", [10, 65])
@pytest.mark.parametrize("path", ["search", "search_batched"])
def test_delta_plane_with_fewer_filled_slots_than_k(few_added, path, k):
    """The delta scan runs over the filled slots only (3 of 1,024, fewer
    than k): the merged hits are the JAX index's, the added rows first
    for their own vectors, the deleted one never."""
    j, p, qs = few_added
    got = getattr(p, path)(qs, k, nprobe=4)
    _assert_search_close(got, getattr(j, path)(qs, k, nprobe=4))
    assert got[1][0, 0] == 2048 and got[1][2, 0] == 2050
    assert not (got[1] == 2049).any()

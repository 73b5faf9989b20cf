"""The port's two kernels (neumann_tpu_torch/ops/kernels.py) against the
JAX package's Pallas kernels, run in interpret mode on the CPU as the
JAX package's own tests run them.

On the CPU every wrapper takes its plain PyTorch version, so these
tests pin the plain versions to the Pallas semantics; the CUDA kernels
are held to the plain versions on the card (test_torch_nojax.py and
chip_smoke.py).

Tolerances: the probe scores a bf16-rounded query against int8 rows in
f32 — products are exact, only the summation order differs — so
atol=5e-3 (the JAX package's own bf16 tolerance for this kernel,
tests/test_pallas_kernels.py) with equal candidate sets and identical
-inf slots. The batched kernel's output is packed integer bits: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumann_tpu.ops import pallas_kernels as pk
from neumann_tpu_torch.ops import kernels as tk


@pytest.fixture(scope="module")
def probe_layout():
    """A JAX-built fixed-window index (int8 buf, rmult, starts) plus
    queries, shared by both packages as numpy arrays."""
    from neumann_tpu.ops.ivf import DeviceIVFInt8

    rng = np.random.default_rng(0)
    n, d, kc = 4096, 128, 8
    cents = rng.standard_normal((kc, d)).astype(np.float32) * 3
    v = (cents[rng.integers(0, kc, n)]
         + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    am = np.max(np.abs(v), axis=1)
    scale = np.where(am > 0, am / 127.0, 1.0).astype(np.float32)
    q8 = np.clip(np.round(v / scale[:, None]), -127, 127).astype(np.int8)
    ivf = DeviceIVFInt8(d, n_clusters=kc, nprobe=4)
    ivf.build(q8, scale, fixed_window=256)
    rm = np.asarray(ivf._rmult).copy()
    rm[::97] = 0.0                         # dead rows -> -inf slots
    qs = v[rng.choice(n, 5)] + 0.05 * rng.standard_normal(
        (5, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    return dict(buf=np.asarray(ivf._buf), rm=rm,
                cents=np.asarray(ivf.centroids),
                starts=np.asarray(ivf._starts), qs=qs, window=ivf._window)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_probe_scores_plain_matches_pallas(probe_layout):
    L = probe_layout
    rng = np.random.default_rng(1)
    n_blocks = L["buf"].shape[0] // 128
    sb = rng.integers(0, n_blocks - L["window"] // 128 + 1,
                      (L["qs"].shape[0], 3)).astype(np.int32)
    want = np.asarray(pk.ivf_probe_scores_pallas(
        jnp.asarray(L["buf"]), jnp.asarray(L["rm"])[None, :],
        jnp.asarray(sb), jnp.asarray(L["qs"]), L["window"]))
    before = dict(tk.LAUNCHES)
    got = tk.ivf_probe_scores(_t(L["buf"]), _t(L["rm"]), _t(sb),
                              _t(L["qs"]), L["window"]).numpy()
    assert tk.LAUNCHES == before          # the plain version never counts
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    live = np.isfinite(want)
    np.testing.assert_allclose(got[live], want[live], atol=5e-3)
    # 1-D start blocks: one query's probe list
    one = tk.ivf_probe_scores(_t(L["buf"]), _t(L["rm"]), _t(sb[0]),
                              _t(L["qs"][:1]), L["window"]).numpy()
    np.testing.assert_array_equal(one, got[:1])


def test_windowed_topk_candidates_match_pallas(probe_layout):
    L = probe_layout
    k, nprobe = 10, 4
    s_p, p_p = pk.ivf_windowed_topk_pallas(
        jnp.asarray(L["buf"]), jnp.asarray(L["rm"]),
        jnp.asarray(L["cents"]), jnp.asarray(L["starts"]),
        jnp.asarray(L["qs"]), k, nprobe, L["window"])
    s_t, p_t = tk.ivf_windowed_topk(
        _t(L["buf"]), _t(L["rm"]), _t(L["cents"]), _t(L["starts"]),
        _t(L["qs"]), k, nprobe, L["window"])
    s_p, p_p = np.asarray(s_p), np.asarray(p_p)
    for r in range(s_p.shape[0]):
        assert set(p_t[r].tolist()) == set(p_p[r].tolist()), r
    np.testing.assert_allclose(s_t.numpy(), s_p, atol=5e-3)


@pytest.fixture(scope="module")
def batched_inputs():
    """Per-window int8 query tables over a fixed-window layout, as
    ops/ivf._batched_core builds them (numpy, handed to both)."""
    rng = np.random.default_rng(2)
    n_win, window, d, q_cap, nq = 12, 512, 64, 6, 9
    modes = rng.standard_normal((4, d)).astype(np.float32) * 3
    v = (modes[np.sort(rng.integers(0, 4, n_win * window))]
         + 0.3 * rng.standard_normal((n_win * window, d))
         ).astype(np.float32)
    am = np.max(np.abs(v), axis=1)
    sc = np.where(am > 0, am / 127.0, 1.0).astype(np.float32)
    cq = np.clip(np.round(v / sc[:, None]), -127, 127).astype(np.int8)
    sq = np.sum(cq.astype(np.float32) ** 2, axis=1) * sc ** 2
    rm = np.where(sq > 0, sc / np.sqrt(np.maximum(sq, 1e-30)), 0.0
                  ).astype(np.float32)
    rm[::53] = 0.0                          # dead rows
    qs = v[rng.choice(len(v), nq)]
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    qam = np.max(np.abs(qs), axis=1)
    qsc = (qam / 127.0).astype(np.float32)
    qq = np.clip(np.round(qs / qsc[:, None]), -127, 127).astype(np.int8)
    tbl = rng.integers(-1, nq, (n_win, q_cap))   # -1 = empty slot
    qsel = qq[np.maximum(tbl, 0)]
    scm = np.where(tbl >= 0, qsc[np.maximum(tbl, 0)], 0.0
                   ).astype(np.float32)
    return dict(buf=cq, rm2=rm.reshape(n_win, window), qsel=qsel, scm=scm,
                window=window)


@pytest.mark.parametrize("top2", [False, True])
def test_batched_probe_plain_bit_exact(batched_inputs, top2):
    B = batched_inputs
    want = np.asarray(pk.batched_probe_pallas(
        jnp.asarray(B["buf"]), jnp.asarray(B["rm2"]),
        jnp.asarray(B["qsel"]), jnp.asarray(B["scm"]), B["window"],
        top2=top2))
    before = dict(tk.LAUNCHES)
    got = tk.batched_probe(_t(B["buf"]), _t(B["rm2"]), _t(B["qsel"]),
                           _t(B["scm"]), B["window"], top2=top2).numpy()
    assert tk.LAUNCHES == before
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    s_want, p_want = pk.decode_strided_pool_bits(jnp.asarray(want),
                                                 B["window"])
    s_got, p_got = tk.decode_strided_pool_bits(torch.from_numpy(got),
                                               B["window"])
    np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_want))
    np.testing.assert_array_equal(p_got.numpy(), np.asarray(p_want))


def test_wrappers_check_inputs(batched_inputs):
    B = batched_inputs
    with pytest.raises(ValueError):
        tk.batched_probe(_t(B["buf"]).float(), _t(B["rm2"]), _t(B["qsel"]),
                         _t(B["scm"]), B["window"])
    with pytest.raises(ValueError):           # window not a pool multiple
        tk.batched_probe(_t(B["buf"]), _t(B["rm2"]), _t(B["qsel"]),
                         _t(B["scm"]), B["window"] + 64)
    with pytest.raises(ValueError):
        tk.ivf_probe_scores(_t(B["buf"]), _t(B["rm2"][0]),
                            torch.zeros((1, 1), dtype=torch.int32),
                            torch.zeros((1, 64)), 128)


def test_launch_counters_reset():
    tk.LAUNCHES["ivf_probe"] = 3
    tk.reset_launch_counts()
    assert {"ivf_probe", "batched_probe"} <= set(tk.LAUNCHES)
    assert set(tk.LAUNCHES.values()) == {0}

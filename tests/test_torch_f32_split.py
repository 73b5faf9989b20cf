"""The arithmetic of the f32 pooled-bits scan's tensor-core kernel
(``csrc/f32_pooled.cu``, row 6, above 16 queries) on the CPU, where the
kernel cannot run.

* The split (``ops/kernels._tf32_split``): each f32 value as two TF32
  values (the low 13 bits zero, as the tensor core reads them), big =
  rna(x) and small = rna(x - big), within max(2^-22 |x|, 2^-137) of x;
  zero, subnormal, large, inf and NaN entries.
* The layout (``_f32_parts``): the K places of the wgmma A fragment that
  each lane builds from the row floats it reads meet the query columns
  the permuted parts hold there; the block's queries by Q
  (``_f32_block_queries``: 32, 64 or 128), zero past Q and past d.
* The kernel's passes emulated in plain torch (the parts, their exact
  f32 products, a stage of 32 K summed from a fresh zero in the order
  small rows x big queries, big x small, big x big, then added to the
  running sum): within the note's 2^-18 sum |x_k c_k| of float64 dots;
  copies of one row placed at different offsets bit-equal; and through
  the port's ``f32_pooled_topk`` against the JAX package's on the CPU,
  decoded winners within ``pool * 2**-22 + 1e-6`` and the winners equal
  on at least 99 % of live pools, as tests/test_torch_quant.py holds the
  plain version. The emulation adds in f32 to nearest; the tensor cores
  truncate inside a stage, which the bound allows for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumann_tpu.ops import quant as jq
from neumann_tpu_torch.ops import kernels as tk
from neumann_tpu_torch.ops import quant as tq

BOUND = 2.0 ** -18     # of sum |x_k c_k|, csrc/f32_pooled.cu's note
MIN_AGREE = 0.99


def _low_bits(t):
    return t.view(torch.int32) & 0x1FFF


def test_split_parts_are_tf32_and_reconstruct():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32)
    x *= (10.0 ** rng.uniform(-30, 30, 4096)).astype(np.float32)
    special = np.array([0.0, -0.0, 1e-40, -3e-39, 1.4e-45, 1.1754942e-38,
                        1e38, -3e38, 1.0 + 2.0 ** -12, 1.0 - 2.0 ** -13,
                        2.0 ** -12 + 2.0 ** -25], np.float32)
    t = torch.from_numpy(np.concatenate([x, special]))
    big, small = tk._tf32_split(t)
    assert big.dtype == small.dtype == torch.float32
    assert not _low_bits(big).any() and not _low_bits(small).any()
    resid = (t.double() - big.double() - small.double()).abs()
    assert (resid <= torch.maximum(2.0 ** -22 * t.double().abs(),
                                   torch.full_like(resid, 2.0 ** -137))).all()
    # small is at most half a TF32 ulp of big
    assert (small.abs() <= big.abs() * 2.0 ** -11).all()
    assert torch.equal(tk._tf32_split(torch.zeros(3))[1], torch.zeros(3))
    # rounding to nearest, ties away from zero, carries into the exponent
    b, s = tk._tf32_split(torch.tensor([2.0 - 2.0 ** -23, 1.0 + 2.0 ** -11,
                                        -(1.0 + 2.0 ** -11)]))
    assert b.tolist() == [2.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    assert s.tolist() == [-2.0 ** -23, -2.0 ** -11, 2.0 ** -11]


def test_split_keeps_non_finite_in_big():
    t = torch.tensor([float("inf"), float("-inf"), float("nan"), 1.5])
    big, small = tk._tf32_split(t)
    assert big[0] == float("inf") and big[1] == float("-inf")
    assert torch.isnan(big[2]) and big[3] == 1.5
    assert torch.equal(small, torch.zeros(4))


@pytest.mark.parametrize("q,nq,qp", [(17, 32, 32), (32, 32, 32),
                                     (33, 64, 64), (64, 64, 64),
                                     (65, 128, 128), (128, 128, 128),
                                     (129, 128, 256), (1025, 128, 1152)])
def test_block_queries_by_q(q, nq, qp):
    assert tk._f32_block_queries(q) == (nq, qp)


@pytest.mark.parametrize("q,d", [(17, 768), (40, 80), (129, 64)])
def test_parts_layout_is_the_fragment(q, d):
    """Lane t's row float 8 t + 2 j + e of each 32 meets the parts'
    column 8 j + 4 e + t: K place t + 4 e of K step j."""
    x = (torch.arange(q * d, dtype=torch.float32).reshape(q, d) + 1.0)
    parts = tk._f32_parts(x)
    _, qp = tk._f32_block_queries(q)
    ldq = -(-d // 32) * 32
    assert parts.shape == (2, qp, ldq)
    big, small = tk._tf32_split(x)
    padded = torch.zeros((2, qp, ldq))
    padded[0, :q, :d], padded[1, :q, :d] = big, small
    for b0 in range(0, ldq, 32):
        for t in range(4):
            for j in range(4):
                for e in range(2):
                    assert torch.equal(parts[:, :, b0 + 8 * j + 4 * e + t],
                                       padded[:, :, b0 + 8 * t + 2 * j + e])
    # zero past Q, and past d wherever the permutation puts those columns
    assert not parts[:, q:].any()
    assert parts.count_nonzero() == padded.count_nonzero()


def _tf32_dots(corpus, queries):
    """The kernel's dots [Q, N] in plain torch: per stage of 32 K, the 8
    K places of each of 4 K steps in order, pass by pass (small rows x
    big queries, big rows x small queries, big x big) from a fresh zero,
    then the stage added to the running sum; every product exact in f32
    (11 x 11 significant bits), every add rounded."""
    n, d = corpus.shape
    # K-major copies: row k of each is every operand's K place k
    bc, sc = (p.T.contiguous() for p in tk._tf32_split(corpus))
    bx, sx = (p.T.contiguous() for p in tk._tf32_split(queries))
    total = None
    for k0 in range(0, d, 32):
        stage = torch.zeros((queries.shape[0], n))
        for xs, cs in ((bx, sc), (sx, bc), (bx, bc)):
            for k in range(k0, min(k0 + 32, d)):
                stage += xs[k, :, None] * cs[k, None, :]
        total = stage if total is None else total + stage
    return total


def _mixture(seed, n, q, d):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((16, d)).astype(np.float32) * 2
    v = (cents[rng.integers(0, 16, n)]
         + 0.5 * rng.standard_normal((n, d))).astype(np.float32)
    qs = (v[rng.choice(n, q)]
          + 0.1 * rng.standard_normal((q, d))).astype(np.float32)
    return v, qs


@pytest.mark.parametrize("d", [768, 80, 64])
def test_emulation_within_bound_of_float64(d):
    v, qs = _mixture(d, 512, 24, d)
    v[7] *= 1e20
    v[9] *= 1e-20
    got = _tf32_dots(torch.from_numpy(v), torch.from_numpy(qs)).double()
    exact = torch.from_numpy(qs).double() @ torch.from_numpy(v).double().T
    scale = torch.from_numpy(np.abs(qs)).double() @ \
        torch.from_numpy(np.abs(v)).double().T
    rel = ((got - exact).abs() / scale).max().item()
    assert rel <= BOUND
    # what seeded data sees: far inside the bound
    assert rel <= 2.0 ** -21


def test_copies_of_a_row_are_bit_equal():
    v, qs = _mixture(3, 1000, 20, 768)
    for at in (1, 8, 15, 16, 63, 64, 127, 128, 129, 511, 512, 999):
        v[at] = v[0]
    dots = _tf32_dots(torch.from_numpy(v), torch.from_numpy(qs))
    bits = dots.view(torch.int32)
    for at in (1, 8, 15, 16, 63, 64, 127, 128, 129, 511, 512, 999):
        assert torch.equal(bits[:, at], bits[:, 0]), at


def _emulated_pooled_bits(corpus, row_mult, bias, queries, q_mult, pool):
    a = _tf32_dots(corpus, queries) * q_mult[:, None]
    return tk._pack_pool_max(a, row_mult, bias, 0, pool)


def _grab_bits(monkeypatch, module):
    seen = {}
    orig = module._pooled_bits_select

    def grab(allbits, pool, k, *rest):
        seen["bits"] = np.asarray(allbits)
        return orig(allbits, pool, k, *rest)

    monkeypatch.setattr(module, "_pooled_bits_select", grab)
    return seen


# Q x N within torch's grain of 32,768 elements: each of the emulation's
# thousands of ops runs on one thread, which keeps it cheap on a machine
# whose cores the other test workers hold
@pytest.mark.parametrize("d,q", [(128, 6), (768, 8)])
@pytest.mark.parametrize("pool", [8, 512])
def test_emulation_within_tolerance_of_jax(monkeypatch, d, q, pool):
    v, qs = _mixture(d + q, 4096, q, d)
    v[7] = 0.0
    mask = np.random.default_rng(d).random(4096) > 0.2
    j_bits = _grab_bits(monkeypatch, jq)
    t_bits = _grab_bits(monkeypatch, tq)
    monkeypatch.setattr(tk, "f32_pooled_bits", _emulated_pooled_bits)
    jq.f32_pooled_topk(jnp.asarray(v), jnp.asarray(qs), 8, pool=pool,
                       mask=jnp.asarray(mask))
    tq.f32_pooled_topk(torch.from_numpy(v), torch.from_numpy(qs), 8,
                       pool=pool, mask=torch.from_numpy(mask))
    jb, tb = j_bits["bits"][:q], t_bits["bits"]
    assert tb.shape == jb.shape == (q, 4096 // pool)
    dec = lambda b: (b & ~(pool - 1)).view(np.float32).astype(np.float64)
    live = jb > 0
    np.testing.assert_array_equal(tb > 0, live)
    np.testing.assert_array_equal(tb[~live], jb[~live])
    err = np.abs(dec(tb) - dec(jb))[live]
    assert err.max() <= pool * 2.0 ** -22 + 1e-6
    same_row = (tb & (pool - 1)) == (jb & (pool - 1))
    assert np.mean(same_row[live]) >= MIN_AGREE

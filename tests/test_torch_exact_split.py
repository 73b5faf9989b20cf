"""The arithmetic of the exact int8 scan's tensor-core kernel
(``csrc/int8_exact.cu``, row 9) on the CPU, where the kernel cannot run.

* The split (``ops/kernels._exact_split``): each f32 unit query as three
  bf16 parts whose f32 sum is the query bit for bit, at d 768, 100 and
  77. The condition: every entry zero or of magnitude at least 2^-110,
  so the last part stays above bf16's subnormal range; seeded unit
  queries meet it, and an entry far below it breaks the split.
* The layout (``_exact_parts``; the kernel lays out a few queries'
  parts the same way itself): the K places of the wgmma A fragment that
  each lane builds from the row bytes it reads meet the query columns
  the permuted parts hold there, so the fragment products are the dot;
  ``_exact_queries`` hands the kernel the parts, or up to 16 queries in
  f32 at d <= 768.
* The three passes emulated in plain torch (bf16 parts, their f32
  products with the rows, the stage order lo, mid, hi, a stage of 64 K
  at a time added to the running sum) against the JAX package's jitted
  ``int8_exact_topk``, run as tests/test_torch_exact_kernel.py runs it:
  scores within EXACT_TOL = 1e-5, ids equal wherever no other score of
  the query is within that, copies of one row bit-equal and by
  ascending row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neumann_tpu.ops import quant as jquant
from neumann_tpu_torch.ops import kernels as tk
from neumann_tpu_torch.ops.scan import _topk_stable
from tests.test_torch_exact_kernel import _plane, _ties_ascend
from tests.test_torch_ivf_batched import _assert_search_close

EXACT_TOL = 1e-5
_jax_exact = jax.jit(jquant.int8_exact_topk,
                     static_argnames=("k", "block_rows"))


def _unit(seed: int, q: int, d: int) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal((q, d)).astype(
        np.float32)
    t = torch.from_numpy(x)
    return t / t.norm(dim=1, keepdim=True).clamp_min(1e-30)


@pytest.mark.parametrize("d", [768, 100, 77])
def test_split_is_exact(d):
    qf = _unit(d, 64, d)
    nz = qf[qf != 0].abs()
    assert nz.min() >= 2.0 ** -110
    hi, mid, lo = tk._exact_split(qf)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    back = (hi.float() + mid.float()) + lo.float()
    assert torch.equal(back.view(torch.int32), qf.view(torch.int32))
    # each part at most half an ulp of bf16 of the one before
    assert (mid.float().abs() <= hi.float().abs() * 2.0 ** -8).all()
    assert (lo.float().abs() <= mid.float().abs() * 2.0 ** -8).all()
    # far below the condition the last part leaves bf16's normal range
    small = qf.clone()
    small[0, 0] = 1.2345678e-36
    hi, mid, lo = tk._exact_split(small)
    assert not torch.equal((hi.float() + mid.float()) + lo.float(), small)


@pytest.mark.parametrize("d", [768, 100, 77])
def test_fragment_layout_is_the_dot(d):
    """Per 32 K block and lane t: row bytes 8 t + 4 c + {0, 2} and {1, 3}
    meet the parts' columns 16 c + 2 t + {0, 1} and + 8 + {0, 1}."""
    qf = _unit(1 + d, 5, d)
    rng = np.random.default_rng(d)
    rows = torch.from_numpy(rng.integers(-127, 128, (9, d)).astype(np.int8))
    padded = tk._exact_rows(rows)
    dk = padded.shape[1]
    assert dk % 16 == 0 and dk >= 64 and torch.equal(padded[:, :d], rows)
    x = tk._exact_parts(qf, dk)
    assert x.shape == (3, 8, -(-dk // 64) * 64)
    assert torch.equal(tk._exact_queries(qf, dk)[:, :d], qf)   # f32
    many = qf.repeat(4, 1)                                   # 20: the parts
    assert torch.equal(tk._exact_queries(many, dk),
                       tk._exact_parts(many, dk))
    xf = x.double().sum(0)[:5]
    rf = torch.zeros(9, x.shape[2], dtype=torch.float64)
    rf[:, :dk] = padded.double()
    got = torch.zeros(5, 9, dtype=torch.float64)
    for b0 in range(0, x.shape[2], 32):
        for c in range(2):
            for t in range(4):
                for h in range(2):
                    for e in range(2):
                        col = b0 + 16 * c + 2 * t + 8 * h + e
                        byte = b0 + 8 * t + 4 * c + h + 2 * e
                        got += xf[:, col, None] * rf[None, :, byte]
    want = qf.double() @ rows.double().T
    assert torch.equal(got, want)


def _three_pass_scores(corpus_q, row_mult, qf):
    """The kernel's arithmetic in plain torch: [Q, N] masked scores."""
    n, d = corpus_q.shape
    rows = corpus_q.float()
    parts = [p.float() for p in tk._exact_split(qf)]
    total = None
    for k0 in range(0, d, 64):
        r = rows[:, k0:k0 + 64]
        stage = None
        for part in reversed(parts):          # lo, mid, hi
            prod = part[:, k0:k0 + 64] @ r.T
            stage = prod if stage is None else stage + prod
        total = stage if total is None else total + stage
    return torch.where(row_mult > 0, total * row_mult,
                       torch.full_like(total, float("-inf")))


@pytest.mark.parametrize("d", [768, 100])
@pytest.mark.parametrize("k", [10, 65])
def test_three_pass_emulation_matches_jax(d, k):
    q8, rm, qs = _plane(d, 0.9, seed=d + k)
    want = _jax_exact(jnp.asarray(q8), jnp.asarray(rm), jnp.asarray(qs), k=k)
    qf = torch.from_numpy(qs)
    qf = qf / qf.norm(dim=1, keepdim=True).clamp_min(1e-30)
    s = _three_pass_scores(torch.from_numpy(q8), torch.from_numpy(rm), qf)
    got_s, got_i = _topk_stable(s, k)
    got_i = got_i.masked_fill(torch.isneginf(got_s), -1)
    _assert_search_close((got_s.numpy(), got_i.numpy()),
                         (np.asarray(want[0]), np.asarray(want[1])))
    fin = np.isfinite(np.asarray(want[0]))
    assert np.abs(got_s.numpy()[fin] - np.asarray(want[0])[fin]).max() \
        <= EXACT_TOL
    _ties_ascend(got_s.numpy(), got_i.numpy())

"""Edge shapes of the tensor-core int8 kernels and the f32 pooled-bits
kernel against their plain PyTorch versions, on an NVIDIA card.

Every test here needs a card and ``nvcc`` (the kernels build from
``neumann_tpu_torch/csrc`` at first use) and skips elsewhere; the plain
versions' arithmetic is pinned to the JAX package by
``tests/test_torch_quant.py`` on the CPU. Run them on the card with
``python -m pytest --noconftest tests/test_torch_nojax.py
tests/test_torch_kernel_edges.py -m cuda`` (this file imports no JAX).

Shapes: query counts on both sides of every switch between kernels
(int8: mma.sync up to 8 queries, wgmma above; f32: stream kernels of 8
and 16 queries, batch kernel above) and past one 128-query batch block
(1, 8, 16, 17, 64 and 1,025), pools of 8 to 4,096 rows, N not a multiple
of the corpus tile where the pool allows it, 1 % dead rows plus one dead
pool, d of 64 and 768 (and 80 for the f32 kernel, whose batch kernel
steps 32 floats of K at a time, so d = 80 ends inside a step). The int8
outputs must be bit-identical; the f32 pooled
winners must decode within one packed-mantissa step of the plain
version's, with the winning rows equal on >= 99 % of the live pools.
"""

import pytest
import torch

QS = (1, 8, 16, 17, 64, 1025)
POOLS = (8, 128, 512, 4096)
DIMS = (64, 768)
F32_DIMS = (64, 80, 768)
MIN_AGREE = 0.99


def _rows(pool: int) -> int:
    """A corpus of whole pools that is not a multiple of the 128- and
    256-row corpus tiles where the pool allows it."""
    return pool * max(3, 1001 // pool * 2 + 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode; their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _inputs(dev, n, q, d, pool, seed):
    """Unit-scale clustered rows (queries near stored rows), cosine
    multipliers, and a bias with 1 % dead rows and a dead first pool."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=dev)
    qs = x[torch.randint(0, n, (q,), generator=g, device=dev)] \
        + 0.1 * torch.randn(q, d, generator=g, device=dev)
    dead = torch.rand(n, generator=g, device=dev) < 0.01
    dead[:pool] = True
    bias = torch.where(dead, torch.full((n,), -1e30, device=dev),
                       torch.full((n,), 2.0, device=dev))
    return x, qs, bias


def _int8(x, qs):
    from neumann_tpu_torch.ops.quant import (
        int8_cosine_row_mult,
        scalar_quantize,
    )

    cq, cs = scalar_quantize(x)
    qq, qsc = scalar_quantize(qs)
    qm = qsc / torch.sqrt(((qq.float() * qsc[:, None]) ** 2).sum(1))
    return cq, int8_cosine_row_mult(cq, cs), qq, qm


@pytest.mark.cuda
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("q", QS)
def test_int8_scores_edges_bit_exact(cuda, q, d):
    from neumann_tpu_torch.ops import kernels as tk

    n = 8 * 1001
    x, qs, _ = _inputs(cuda, n, q, d, 8, 10 + q)
    cq, rm, qq, qm = _int8(x, qs)
    rm[::97] = 0.0
    before = tk.LAUNCHES["int8_dot_scores"]
    got = tk.int8_dot_scores(cq, rm, qq, qm)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["int8_dot_scores"] == before + 1
    assert torch.equal(got, tk.int8_dot_scores_plain(cq, rm, qq, qm))


@pytest.mark.cuda
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("q", QS)
def test_int8_pooled_edges_bit_exact(cuda, q, pool, d):
    from neumann_tpu_torch.ops import kernels as tk

    n = _rows(pool)
    x, qs, bias = _inputs(cuda, n, q, d, pool, 20 + q)
    cq, rm, qq, qm = _int8(x, qs)
    before = tk.LAUNCHES["int8_pooled_bits"]
    got = tk.int8_pooled_bits(cq, rm, bias, qq, qm, pool)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["int8_pooled_bits"] == before + 1
    want = tk.int8_pooled_bits_plain(cq, rm, bias, qq, qm, pool)
    assert got.shape == (q, n // pool)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", F32_DIMS)
@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("q", QS)
def test_f32_pooled_edges_within_tolerance(cuda, q, pool, d):
    """Dots summed in another order: a decoded winner may move by one
    packed step (pool * 2^-22 for scores in [1, 4)) plus 1e-6, as
    ``chip_smoke.F32_POOLED_ATOL`` states for pool 512."""
    from neumann_tpu_torch.ops import kernels as tk

    n = _rows(pool)
    x, qs, bias = _inputs(cuda, n, q, d, pool, 30 + q)
    rm = torch.rsqrt((x * x).sum(1))
    qm = torch.rsqrt((qs * qs).sum(1))
    before = tk.LAUNCHES["f32_pooled_bits"]
    got = tk.f32_pooled_bits(x, rm, bias, qs, qm, pool)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["f32_pooled_bits"] == before + 1
    want = tk.f32_pooled_bits_plain(x, rm, bias, qs, qm, pool)
    assert got.shape == (q, n // pool)
    live = want > 0
    assert torch.equal(got > 0, live)
    assert not live[:, 0].any()
    assert torch.equal(got[~live], want[~live])
    dec = lambda b: (b & ~(pool - 1)).view(torch.float32).double()
    err = (dec(got) - dec(want)).abs()[live].max().item()
    assert err <= pool * 2.0 ** -22 + 1e-6
    same = ((got & (pool - 1)) == (want & (pool - 1)))[live]
    assert same.float().mean().item() >= MIN_AGREE

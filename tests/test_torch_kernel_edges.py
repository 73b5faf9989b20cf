"""Edge shapes of the tensor-core int8 kernels, the f32 pooled-bits
kernel, the fused hamming top-k, the batched top-2 probe and the PQ ADC
scan against their plain PyTorch versions, on an NVIDIA card.

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
Hamming top-k: Q 1, 5, 70 and 1,025 and both sides of the fused kernel's
16-query warp tile and 128-query block (15-17, 127-129), N 3,001 and
2^20, W 4 to 256 (d up to 8,192; every plan of query tiles, row slices
and stages the wrapper picks there, and the hamming_scores route), k 1,
10, the cap and the cap + 1; all rows masked and one live row; rows
copied across distant row groups, so the k-th distance ties across
blocks at the shared threshold; whole row groups dead; rows too wide for
the kernel's stages (W 1,408, the distances kernel); scores and ids
equal. Batched probe: q_cap
8 to 200, windows of 128 to 4,096 rows, d 64, 768, 784 (d % 32 = 16) and
4,096 (queries streamed with the rows), top-2 on and off; bit for bit.
ADC scan: M 8 to 392 (both sides of its 48-subspace shared-memory chunk,
M not a multiple of 4), Q 1 to 1,025, N not a multiple of a block's
rows, dead rows, the gathered mode with -1 and repeated candidates; bit
for bit, and ``pq_topk`` through it equal to the plain selection. Its
select mode at the same M, Q 1 to 1,025 on both sides of the switch
between the lane layout and the 8-query shared layout (3 / 4) and of a
shared block (8, 70), k 1, 10 and 64, codes copied across distant rows
(exact ties at the shared threshold), fewer live rows than k, a whole
block of dead rows, gathered candidates with -1; scores and columns
equal to ``pq_adc_topk_plain``. The batched probe's top-1 mode through
``batched_ivf_topk(fused="pallas", presel=0)``, and the plain-torch
non-fast first pass (exact int8 dots at d 768 and 3,072), equal to the
CPU's bits. ROLLBACK on a router whose corpora hold device views:
SIMILAR on the f32 pooled, int8 and binary routes gives the hits from
before the checkpoint, and their kernels launch.
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


# hamming top-k (kernel 7): every shape through quant.hamming_topk, which
# takes the fused kernel up to its k cap and hamming_scores above it
HAMMING_QS = (1, 5, 15, 16, 17, 70, 127, 128, 129, 1025)
HAMMING_NS = (3001, 1 << 20)
HAMMING_WS = (4, 8, 12, 24, 64, 96, 128, 256)


def _bits(g, dev, rows, w):
    return torch.randint(-(1 << 31), 1 << 31, (rows, w), generator=g,
                         device=dev, dtype=torch.int64).int()


def _hamming_case(dev, n, q, w, seed):
    """Random bits with every fourth row a copy of an earlier one (equal
    distances everywhere), queries near stored rows, 10 % dead rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cb = _bits(g, dev, n, w)
    cb[3::4] = cb[torch.randint(0, n, (n,), generator=g, device=dev)[3::4]]
    qb = cb[torch.randint(0, n, (q,), generator=g, device=dev)] ^ (
        _bits(g, dev, q, w) & _bits(g, dev, q, w) & _bits(g, dev, q, w))
    mask = torch.rand(n, generator=g, device=dev) > 0.1
    return cb, qb.contiguous(), mask


@pytest.mark.cuda
@pytest.mark.parametrize("w", HAMMING_WS)
@pytest.mark.parametrize("n", HAMMING_NS)
@pytest.mark.parametrize("q", HAMMING_QS)
def test_hamming_topk_edges_equal_plain(cuda, q, n, w):
    """Scores and ids equal to the plain version, k 1, 10, the cap and
    the cap + 1 (the hamming_scores route). The plain top-k is computed
    once, at the cap + 1: its keys are distinct and sorted, so the top-k
    for a smaller k is its first k columns."""
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.quant import hamming_topk

    cb, qb, mask = _hamming_case(cuda, n, q, w, 40 + q + w)
    ws_all, wi_all = tk.hamming_topk_plain(cb, qb, mask,
                                           tk.HAMMING_TOPK_CAP + 1)
    for k in (1, 10, tk.HAMMING_TOPK_CAP, tk.HAMMING_TOPK_CAP + 1):
        fused = k <= tk.HAMMING_TOPK_CAP
        before = dict(tk.LAUNCHES)
        s, i = hamming_topk(cb, qb, k, mask)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["hamming_topk"] == before["hamming_topk"] + fused
        assert (tk.LAUNCHES["hamming_scores"] > before["hamming_scores"]) \
            == (not fused)
        ws, wi = ws_all[:, :k], wi_all[:, :k]
        assert s.shape == ws.shape == (q, min(k, n))
        assert torch.equal(s, ws) and torch.equal(i, wi), k


@pytest.mark.cuda
@pytest.mark.parametrize("live", [0, 1])
def test_hamming_topk_masked_edges(cuda, live):
    """All rows masked (every slot -inf / -1) and one valid row."""
    from neumann_tpu_torch.ops import kernels as tk

    cb, qb, _ = _hamming_case(cuda, 3001, 70, 24, 7)
    mask = torch.zeros(3001, dtype=torch.bool, device=cuda)
    mask[1234] = bool(live)
    s, i = tk.hamming_topk(cb, qb, mask, 10)
    torch.cuda.synchronize()
    ws, wi = tk.hamming_topk_plain(cb, qb, mask, 10)
    assert torch.equal(s, ws) and torch.equal(i, wi)
    assert int(torch.isfinite(s).sum()) == 70 * live
    if live:
        assert (i[:, 0] == 1234).all() and (i[:, 1:] == -1).all()


def _assert_topk_equal(tk, cb, qb, mask, ks=(1, 10, 64)):
    """The fused kernel (one launch each) against the plain top-k."""
    ws_all, wi_all = tk.hamming_topk_plain(cb, qb, mask, max(ks))
    for k in ks:
        before = tk.LAUNCHES["hamming_topk"]
        s, i = tk.hamming_topk(cb, qb, mask, k)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["hamming_topk"] == before + 1
        assert torch.equal(s, ws_all[:, :k]), k
        assert torch.equal(i, wi_all[:, :k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 17, 129])
@pytest.mark.parametrize("w", [24, 96])
def test_hamming_topk_ties_across_groups(cuda, q, w):
    """64 base rows copied to 15 distant places of a 2^20-row corpus (one
    per row group or more apart), queries a few bits from a base row: a
    query's k best rows are copies at equal distances in many blocks,
    so the k-th distance ties across blocks at the shared threshold and
    the lower rows must win."""
    from neumann_tpu_torch.ops import kernels as tk

    n = 1 << 20
    g = torch.Generator(device=cuda).manual_seed(60 + q + w)
    cb = _bits(g, cuda, n, w)
    base = cb[:64].clone()
    for c in range(1, 16):
        r0 = c * (n // 16) + 37 * c
        cb[r0:r0 + 64] = base
    pick = torch.randint(0, 64, (q,), generator=g, device=cuda)
    qb = base[pick] ^ (_bits(g, cuda, q, w) & _bits(g, cuda, q, w)
                       & _bits(g, cuda, q, w) & _bits(g, cuda, q, w))
    mask = torch.rand(n, generator=g, device=cuda) > 0.01
    _assert_topk_equal(tk, cb, qb.contiguous(), mask)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [1, 17, 129])
def test_hamming_topk_dead_groups(cuda, q):
    """Whole row groups dead: the first half of a 2^20-row corpus and a
    run in the middle of the second, and a live run too short for k 64
    in a dead stretch; the rest 10 % dead."""
    from neumann_tpu_torch.ops import kernels as tk

    n = 1 << 20
    cb, qb, mask = _hamming_case(cuda, n, q, 24, 80 + q)
    mask[: n // 2] = False
    mask[n // 2 + 100_000: n // 2 + 300_000] = False
    mask[200_000:200_040] = True
    _assert_topk_equal(tk, cb, qb, mask)


@pytest.mark.cuda
def test_hamming_topk_too_wide_for_stages(cuda):
    """Rows of 1,408 words (45,056 bits) leave no plan that fits shared
    memory at k 64: the wrapper takes the distances kernel and the keyed
    merge, results equal."""
    from neumann_tpu_torch.ops import kernels as tk

    cb, qb, mask = _hamming_case(cuda, 3001, 5, 1408, 90)
    assert tk._hamming_groups(3001, 5, 1408, 64, 132) is None
    ws, wi = tk.hamming_topk_plain(cb, qb, mask, 64)
    before = dict(tk.LAUNCHES)
    s, i = tk.hamming_topk(cb, qb, mask, 64)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["hamming_topk"] == before["hamming_topk"]
    assert tk.LAUNCHES["hamming_scores"] > before["hamming_scores"]
    assert torch.equal(s, ws) and torch.equal(i, wi)


# batched top-2 probe (kernel 2): live slots 0 .. count - 1 per window,
# with a window of no live slot, one of all slots live, and one zero
# scale inside the live range
@pytest.mark.cuda
@pytest.mark.parametrize("top2", [False, True])
@pytest.mark.parametrize("d", (64, 768, 784, 4096))
@pytest.mark.parametrize("window", (128, 1024, 4096))
@pytest.mark.parametrize("q_cap", (8, 40, 64, 128, 200))
def test_batched_probe_edges_bit_exact(cuda, q_cap, window, d, top2):
    from neumann_tpu_torch.ops import kernels as tk

    g = torch.Generator(device=cuda).manual_seed(q_cap + window + d)
    n_win = max(4, (1 << 16) // window)
    buf = torch.randint(-127, 128, (n_win * window, d), generator=g,
                        device=cuda, dtype=torch.int8)
    qsel = torch.randint(-127, 128, (n_win, q_cap, d), generator=g,
                         device=cuda, dtype=torch.int8)
    rm = torch.rand(n_win, window, generator=g, device=cuda) * 1e-3
    rm[:, ::41] = 0.0
    count = torch.randint(0, q_cap + 1, (n_win, 1), generator=g, device=cuda)
    count[0], count[1] = 0, q_cap
    scm = (torch.rand(n_win, q_cap, generator=g, device=cuda) * 1e-2 + 1e-3
           ) * (torch.arange(q_cap, device=cuda) < count)
    scm[1, q_cap // 2] = 0.0
    name = "batched_probe" if top2 else "batched_probe_top1"
    before = tk.LAUNCHES[name]
    got = tk.batched_probe(buf, rm, qsel, scm, window, top2=top2)
    torch.cuda.synchronize()
    assert tk.LAUNCHES[name] == before + 1
    want = tk.batched_probe_plain(buf, rm, qsel, scm, window, top2=top2)
    assert torch.equal(got, want)


def _ivf_layout(dev, n_win, window, d, seed):
    """A fixed-window int8 layout with 2 % dead rows and a dead window,
    window-mean centroids, on ``dev``."""
    from neumann_tpu_torch.ops.ivf import window_mean_centroids
    from neumann_tpu_torch.ops.quant import (
        int8_cosine_row_mult,
        scalar_quantize,
    )

    g = torch.Generator().manual_seed(seed)
    cents = torch.randn(n_win // 4 + 1, d, generator=g)
    x = cents[torch.randint(0, cents.shape[0], (n_win * window,),
                            generator=g)] \
        + 0.3 * torch.randn(n_win * window, d, generator=g)
    buf, sc = scalar_quantize(x)
    rm = int8_cosine_row_mult(buf, sc)
    rm[torch.rand(n_win * window, generator=g) < 0.02] = 0.0
    rm[:window] = 0.0
    # odd integers near 2x stored rows: the same query norms, hence the
    # same int8 queries, on the card and on the CPU
    qs = 2 * torch.round(x[torch.randint(0, x.shape[0], (70,),
                                         generator=g)]) + 1
    starts = torch.arange(n_win, dtype=torch.int32) * window
    layout = (buf, rm, window_mean_centroids(buf, rm, window), starts, qs)
    return tuple(t.to(dev) for t in layout)


# row 2's top-1 mode through its route, batched_ivf_topk(fused="pallas",
# presel=0): windows of 1 (128 rows) to 16 pools, q_cap below the batch
# (probes dropped) and above it, nprobe up to every window; every (probe,
# pool) winner decoded equal to the plain version's on the CPU, bit for
# bit, one top-1 launch a call
@pytest.mark.cuda
@pytest.mark.parametrize("window,d", [(128, 64), (1024, 768), (2048, 784)])
@pytest.mark.parametrize("nprobe,q_cap", [(3, 8), (8, 64), (32, 200)])
def test_batched_top1_route_bit_exact(cuda, window, d, nprobe, q_cap):
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.ivf import batched_ivf_topk

    n_win = 32
    nprobe = min(nprobe, n_win)
    on_card = _ivf_layout(cuda, n_win, window, d, window + d)
    on_cpu = tuple(t.cpu() for t in on_card)
    kw = dict(selection=window // 128, fused="pallas", probe_mode="exact")
    before = dict(tk.LAUNCHES)
    s_g, p_g, o_g = batched_ivf_topk(*on_card, nprobe, window, 1, q_cap,
                                     **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["batched_probe_top1"] == \
        before["batched_probe_top1"] + 1
    assert tk.LAUNCHES["batched_probe"] == before["batched_probe"]
    s_w, p_w, o_w = batched_ivf_topk(*on_cpu, nprobe, window, 1, q_cap, **kw)
    assert o_g == o_w and s_g.shape == (70, nprobe * 128)
    assert torch.equal(s_g.cpu().view(torch.int32), s_w.view(torch.int32))
    assert torch.equal(p_g.cpu(), p_w)


# the non-fast batched first pass is plain torch: on the card its exact
# int8 dots (f32 products of up to 1,024 columns, TF32 off) and its top-m
# must give the CPU's bits; d 3,072 takes three column slices
@pytest.mark.cuda
@pytest.mark.parametrize("d", [768, 3072])
@pytest.mark.parametrize("selection", ["approx", 8])
def test_non_fast_first_pass_on_the_card_equals_the_cpu(cuda, d, selection):
    from neumann_tpu_torch.ops.ivf import _int8_dots, batched_ivf_topk

    g = torch.Generator().manual_seed(d)
    a = torch.randint(-127, 128, (4, 64, d), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (4, 1024, d), generator=g,
                      dtype=torch.int8)
    a[0, 0] = b[0, 0] = 127
    want = torch.einsum("gqd,gwd->gqw", a.long(), b.long()).int().float()
    assert torch.equal(_int8_dots(a.to(cuda), b.to(cuda)).cpu(), want)
    on_card = _ivf_layout(cuda, 16, 1024, d, d + 1)
    on_cpu = tuple(t.cpu() for t in on_card)
    got = batched_ivf_topk(*on_card, 6, 1024, 152, 64, selection=selection)
    want = batched_ivf_topk(*on_cpu, 6, 1024, 152, 64, selection=selection)
    assert got[2] == want[2]
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].view(torch.int32))
    assert torch.equal(got[1].cpu(), want[1])


# PQ ADC scan (kernel 8): M on both sides of the 48-subspace shared-memory
# chunk and of a block's 227 KB (M 192 tables are 192 KB, M 384 and 392
# are past it), M not a multiple of 4 (byte loads), N not a multiple of a
# block's 2,048 rows, 1 % dead rows, Q 1 to 1,025; the gathered mode with
# -1 candidates and candidates repeated; bit for bit
@pytest.mark.cuda
@pytest.mark.parametrize("q", (1, 8, 70, 1025))
@pytest.mark.parametrize("m", (8, 13, 96, 192, 384, 392))
def test_pq_adc_edges_bit_exact(cuda, m, q):
    from neumann_tpu_torch.ops import kernels as tk

    g = torch.Generator(device=cuda).manual_seed(m * 7 + q)
    n = 3001 if q > 70 else 20_011
    codes = torch.randint(0, 256, (n, m), generator=g, device=cuda,
                          dtype=torch.uint8)
    tables = torch.rand(q, m, 256, generator=g, device=cuda) * 4.0
    valid = torch.rand(n, generator=g, device=cuda) > 0.01
    before = tk.LAUNCHES["pq_adc"]
    got = tk.pq_adc_scores(codes, tables, valid)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["pq_adc"] == before + 1
    assert torch.equal(got, tk.pq_adc_scores_plain(codes, tables, valid))
    assert torch.isneginf(got[:, ~valid]).all()
    cand = torch.randint(-1, n, (q, 777), generator=g, device=cuda,
                         dtype=torch.int32)
    cand[:, 5:9] = cand[:, :4]
    got = tk.pq_adc_scores(codes, tables, valid, cand)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["pq_adc"] == before + 2
    assert torch.equal(got, tk.pq_adc_scores_plain(codes, tables, valid,
                                                   cand))
    assert torch.isneginf(got[cand < 0]).all()


@pytest.mark.cuda
def test_pq_topk_on_the_card_equals_plain(cuda):
    """pq_topk through the kernel against the same selection over the
    plain scores, with duplicated codes (exact ties, by ascending row)."""
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.pq import PQCodebook, PQConfig, pq_topk
    from neumann_tpu_torch.ops.scan import _topk_stable

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(50_000, 128, generator=g, device=cuda)
    x[100:140] = x[7]
    book = PQCodebook(128, PQConfig(n_subspaces=16), device=cuda)
    book.train(x[:8192])
    codes = book.encode(x)
    valid = torch.rand(50_000, generator=g, device=cuda) > 0.01
    valid[7] = True
    q = torch.cat([x[7:8], torch.randn(63, 128, generator=g, device=cuda)])
    s, i = pq_topk(book, codes, q, 64, valid)
    ws, wi = _topk_stable(tk.pq_adc_scores_plain(
        codes, book.adc_tables(q), valid), 64)
    assert torch.equal(s, ws) and torch.equal(i, wi.int())
    live = valid[100:140].nonzero().squeeze(1) + 100
    assert i[0, 1:1 + len(live)].tolist() == live.tolist()


def _tied_codes(g, dev, n, m):
    """[n, m] codes in which every row repeats one of n // 8 patterns:
    rows far apart tie exactly, so their order rests on the keys."""
    base = torch.randint(0, 256, (max(1, n // 8), m), generator=g,
                         device=dev, dtype=torch.uint8)
    return base[torch.randint(0, base.shape[0], (n,), generator=g,
                              device=dev)].contiguous()


def _assert_select_equal(tk, codes, tables, valid, cand=None,
                         ks=(1, 10, 64)):
    for k in ks:
        before = tk.LAUNCHES["pq_adc_select"]
        got = tk.pq_adc_topk(codes, tables, valid, k, cand)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["pq_adc_select"] == before + 1
        want = tk.pq_adc_topk_plain(codes, tables, valid, k, cand)
        for a, b, what in zip(got, want, ("scores", "columns")):
            assert torch.equal(a, b), (k, what, int((a != b).sum()))


# the select mode: scores and columns equal to the plain top-k
@pytest.mark.cuda
@pytest.mark.parametrize("q", (1, 3, 4, 8, 70, 1025))
@pytest.mark.parametrize("m", (8, 13, 96, 192, 384, 392))
def test_pq_adc_select_edges_equal_plain(cuda, m, q):
    from neumann_tpu_torch.ops import kernels as tk

    g = torch.Generator(device=cuda).manual_seed(m * 11 + q)
    n = 3001 if q > 70 else 20_011
    codes = _tied_codes(g, cuda, n, m)
    tables = torch.rand(q, m, 256, generator=g, device=cuda) * 4.0
    valid = torch.rand(n, generator=g, device=cuda) > 0.01
    _assert_select_equal(tk, codes, tables, valid)
    cand = torch.randint(-1, n, (q, 777), generator=g, device=cuda,
                         dtype=torch.int32)
    cand[:, 5:9] = cand[:, :4]
    _assert_select_equal(tk, codes, tables, valid, cand)


@pytest.mark.cuda
@pytest.mark.parametrize("q", (1, 8, 70))
def test_pq_adc_select_few_live_rows(cuda, q):
    """Fewer live rows than k, and a whole shared-layout pass (4,096 rows)
    and lane-layout pass (2,048) dead: the slots past the live rows hold
    -inf, as the plain top-k's."""
    from neumann_tpu_torch.ops import kernels as tk

    g = torch.Generator(device=cuda).manual_seed(300 + q)
    n, m = 3 * 4096 + 17, 16
    codes = _tied_codes(g, cuda, n, m)
    tables = torch.rand(q, m, 256, generator=g, device=cuda)
    valid = torch.zeros(n, dtype=torch.bool, device=cuda)
    valid[torch.randint(0, n, (20,), generator=g, device=cuda)] = True
    _assert_select_equal(tk, codes, tables, valid)
    s, _ = tk.pq_adc_topk(codes, tables, valid, 64)
    assert torch.isneginf(s[:, int(valid.sum()):]).all()
    valid = torch.rand(n, generator=g, device=cuda) > 0.5
    valid[4096:2 * 4096] = False
    _assert_select_equal(tk, codes, tables, valid)


@pytest.mark.cuda
def test_rollback_under_device_views(cuda, tmp_path, monkeypatch):
    """ROLLBACK on a router whose corpora hold device views (the f32
    pooled view, the int8 and binary collections' quantized views), then
    SIMILAR on each route: the hits taken before the checkpoint, keys
    and scores equal, and each route's kernel launched after the
    rollback."""
    import numpy as np

    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.router import QueryRouter

    monkeypatch.setenv("NEUMANN_POOLED_MIN_ROWS", "1024")
    monkeypatch.setenv("NEUMANN_POOLED_MIN_POOLS", "64")
    rng = np.random.default_rng(12)
    n, d = 8192, 768
    cents = rng.standard_normal((32, d)).astype(np.float32)
    x = (cents[rng.integers(0, 32, n)]
         + 0.25 * rng.standard_normal((n, d))).astype(np.float32)
    r = QueryRouter(device=cuda)
    r.init_checkpoints(str(tmp_path))
    r.execute(f"CREATE COLLECTION q8 DIM {d} QUANTIZATION int8")
    r.execute(f"CREATE COLLECTION bits DIM {d} QUANTIZATION binary")
    with r.vector.bulk_ingest():
        for i in range(n):
            r.vector.store_embedding(f"k{i}", x[i], {"cat": i % 4})
            r.vector.store_in_collection("q8", f"k{i}", x[i])
            r.vector.store_in_collection("bits", f"k{i}", x[i])

    def lit(v):
        return "[" + ", ".join(f"{a:.7g}" for a in v) + "]"

    stmts = {"f32_pooled_bits": [f"SIMILAR {lit(q)} TOP 10" for q in x[:4]],
             "int8_pooled_bits": [f"SIMILAR {lit(q)} IN q8 TOP 10"
                                  for q in x[:4]],
             "hamming_topk": [f"SIMILAR {lit(q)} IN bits TOP 10"
                              for q in x[:4]]}

    def hits():
        return {k: [[(h["key"], h["score"]) for h in r.execute(s).results]
                    for s in ss] for k, ss in stmts.items()}

    before = hits()
    r.execute("CHECKPOINT 'pre'")
    for i in range(0, n, 7):
        r.vector.store_embedding(f"k{i}", -x[i])
        r.vector.store_in_collection("q8", f"k{i}", -x[i])
        r.vector.store_in_collection("bits", f"k{i}", -x[i])
    assert hits() != before
    r.execute("ROLLBACK TO 'pre'")
    tk.reset_launch_counts()
    assert hits() == before
    for kernel in stmts:
        assert tk.LAUNCHES[kernel] >= len(stmts[kernel]), dict(tk.LAUNCHES)

"""The fused hamming top-k's launch plan (``ops/kernels._hamming_groups``),
on the CPU: the arithmetic that sizes ``csrc/hamming_topk.cu``'s grid,
its shared memory and its 32-bit keys, over a sweep of corpus rows N,
queries Q, words W, k and SM counts. The kernel itself runs only on a
card (``tests/test_torch_kernel_edges.py``)."""

import pytest

from neumann_tpu_torch.ops import kernels as tk

NS = (1, 7, 128, 3001, 65_536, 262_144, 1 << 20, 10_000_000)
QS = (1, 8, 15, 16, 17, 32, 127, 128, 129, 256, 1024, 1025, 20_000)
SMS = (1, 114, 132)


def _check_plan(n, q, w, k, sms):
    plan = tk._hamming_groups(n, q, w, k, sms)
    assert plan is not None, (n, q, w, k, sms)
    tiles, slices, rw, stages, groups, span = plan
    rows = slices * rw
    # a block: power-of-two tiles of 16 queries and row slices, at most
    # 8 consumer warps, n8 tiles of rows, a ring of 3-16 stages
    assert tiles in (1, 2, 4, 8) and slices in (1, 2, 4, 8)
    assert tiles * slices <= tk._HT_WARPS
    assert rw in tk._HT_ROWS_PER_WARP and rows <= tk._HT_MAX_STAGE_ROWS
    assert tk._HT_STAGES[0] <= stages <= tk._HT_STAGES[1]
    assert tk._ht_smem(w, k, tiles, slices, rw, stages) <= tk._HT_SMEM
    # no more tiles than the queries fill
    assert tiles == 1 or 16 * tiles // 2 < q
    # the groups cover the rows, none empty, each whole stages
    assert groups * span >= n and (groups - 1) * span < n
    assert span % rows == 0
    # 32-bit keys inside a warp: a distance (up to 32 W) above the row in
    # the group, whatever slice of whatever stage holds it
    assert span <= tk._ht_max_span(w)
    assert (32 * w + 1) * tk._ht_max_span(w) <= 1 << 32
    # the grid fills the card when the corpus is long enough
    qblocks = -(-q // (16 * tiles))
    assert qblocks <= 65535
    if qblocks <= sms and n >= 64 * sms * rows:
        assert groups * qblocks >= 0.9 * (sms // qblocks) * qblocks
    # the final torch.topk's input stays small at one query
    if q == 1 and k <= 10:
        assert groups * slices * k <= 16_384
    return plan


@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("w", [4, 8, 12, 24, 28, 64, 96, 128, 256, 1000])
def test_plan_fits_and_covers(w, k):
    for n in NS:
        for q in QS:
            for sms in SMS:
                _check_plan(n, q, w, k, sms)


def test_plan_of_the_cells():
    """D's and E's launches: 8 tiles of queries at the batches (the corpus
    crosses from L2 once per 128 queries), all 8 warps busy on row slices
    at one query, and the card's 132 SMs filled at both ends."""
    d_batch = _check_plan(1 << 20, 1024, 24, 10, 132)
    assert d_batch[:2] == (8, 1) and d_batch[4] * 8 >= 120
    d_one = _check_plan(1 << 20, 1, 24, 10, 132)
    assert d_one[:2] == (1, 8) and d_one[4] >= 120
    e_batch = _check_plan(262_144, 256, 96, 10, 132)
    assert e_batch[:2] == (8, 1) and e_batch[4] * 2 >= 120
    e_one = _check_plan(262_144, 1, 96, 10, 132)
    assert e_one[:2] == (1, 8) and e_one[4] >= 120


@pytest.mark.parametrize("w", [4, 12, 24, 28, 96, 256, 1000])
def test_ring_stride_free_of_bank_conflicts(w):
    """A half warp's B loads with several query tiles: rows g = 0..3 at words 2 t, 2 t + 1 (t =
    0..3) of a row stride that is >= W and 8 mod 16 words fall in 32
    distinct banks, and a row's words stay 16-byte aligned; one tile keeps
    rows unpadded (a stage is one copy)."""
    assert tk._ht_stride(w, 1) == w
    stride = tk._ht_stride(w, 2)
    assert stride >= w and stride % 16 == 8 and stride - w < 16
    banks = {(g * stride + 2 * t + e) % 32
             for g in range(4) for t in range(4) for e in range(2)}
    assert len(banks) == 32
    # the last K step reads up to 8 * ceil(W / 8) words: inside the stride
    assert 8 * -(-w // 8) <= stride


@pytest.mark.parametrize("k", [1, 10, 64])
def test_plan_none_only_past_the_widest_stage(k):
    """No plan exists only once one tile, one slice and 8 rows a stage no
    longer fit (then the wrapper takes the distances kernel), and the
    limit grows as k falls."""
    widest = max(w for w in range(4, 4000, 4)
                 if tk._hamming_groups(4096, 1, w, k, 132) is not None)
    assert 1000 < widest < 2000
    for w in range(4, widest + 1, 4):
        assert tk._hamming_groups(4096, 1, w, k, 132) is not None
    assert tk._hamming_groups(4096, 1, widest + 4, k, 132) is None
    assert tk._hamming_groups(4096, 1, tk._HT_MAX_WORDS + 4, k, 132) is None

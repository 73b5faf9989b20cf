"""Second-pass rerank: exact f32 rescoring of scan-selected candidates
(port of ``neumann_tpu/ops/rerank.py``), and the two pooled-bits routes
that end in it (``int8_pooled_rerank_topk``, ``f32_pooled_rerank_topk``).

The quantized first passes (int8 batched probe, bf16 windowed probe)
select candidates well but order them imprecisely; this pass gathers
the few survivors, reconstructs them at the highest stored precision
(int8, or int8 + int8 residual ~= int16) and rescores them in f32
against the unquantized query. Duplicate positions (overlapping IVF
windows) collapse on device: sort by position, mask equal neighbours.
"""

from __future__ import annotations

from typing import Optional

import torch

from neumann_tpu_torch.ops.quant import (
    f32_pooled_topk,
    int8_pooled_topk,
    int8_scale,
)
from neumann_tpu_torch.ops.scan import NEG_INF, _topk_stable


def residual_quantize(x: torch.Tensor, q: torch.Tensor,
                      scale: torch.Tensor, form: str = "divide"):
    """Quantize the int8 reconstruction error as a second int8 plane:
    returns (rq int8 [N, d], rscale f32 [N]) with
    ``x ~= q * scale + rq * rscale``; the residual's scale in ``form``
    (``ops/quant.int8_scale``), its values divided by it as
    ``scalar_quantize`` divides."""
    res = x.float() - q.float() * scale[..., None]
    rscale = int8_scale(res.abs().amax(dim=-1), form)
    rq = torch.round(res / rscale[..., None]).clamp(-127, 127).to(torch.int8)
    return rq, rscale


def _dedup_sorted(scores: torch.Tensor, pos: torch.Tensor):
    """Mask duplicate positions per row: sort by position, -inf every
    element equal to its left neighbour. Returns (scores, pos) sorted by
    position with dups (and -1 sentinels) at -inf."""
    ps, order = torch.sort(pos, dim=1, stable=True)
    sc = torch.gather(scores, 1, order)
    prev = torch.cat([torch.full_like(ps[:, :1], -2), ps[:, :-1]], dim=1)
    dead = (ps == prev) | (ps < 0)
    return sc.masked_fill(dead, NEG_INF), ps


def _select(scores, pos, k: int, dedup: bool):
    """Top-k of the rescored candidates in ``lax.top_k``'s order: equal
    scores by candidate slot, which with ``dedup`` is ascending row, and
    without it the first pass's order (the pooled routes' candidates
    come in their selection order, as the JAX package lays them out)."""
    if dedup:
        scores, pos = _dedup_sorted(scores, pos)
    s, i = _topk_stable(scores, min(k, scores.shape[1]))
    out_pos = torch.gather(pos, 1, i).masked_fill(torch.isneginf(s), -1)
    return s, out_pos.int()


def gather_rerank_topk(
    corpus_q: torch.Tensor,
    pos: torch.Tensor,
    queries: torch.Tensor,
    k: int,
    metric: str = "cosine",
    scale: Optional[torch.Tensor] = None,
    residual_q: Optional[torch.Tensor] = None,
    residual_scale: Optional[torch.Tensor] = None,
    first_scores: Optional[torch.Tensor] = None,
    dedup: bool = True,
    row_mult: Optional[torch.Tensor] = None,
    valid_rows: Optional[torch.Tensor] = None,
):
    """Exact f32 top-k over gathered candidate rows.

    corpus_q [N, d] int8 or f32 (the gather source); pos [Q, C]
    candidate positions (-1 = empty, duplicates allowed); queries [Q, d]
    f32 unquantized. scale [N] per-row int8 scale (cancels for cosine
    when no residual plane is given); residual_* the optional second
    int8 plane; first_scores [Q, C]: slots at -inf there stay -inf;
    row_mult [N] precomputed cosine multipliers (fast path: one f32
    pass over the gather); valid_rows [N] (<= 0 = dead).
    Returns (scores [Q, k] f32, positions [Q, k] int32, -1 for empty).
    """
    if residual_q is not None and scale is None:
        raise ValueError("residual rerank needs the first-pass scale")
    qf = queries.float()
    safe = pos.long().clamp_min(0)

    def dead_mask():
        dead = pos < 0
        if valid_rows is not None:
            dead = dead | (valid_rows[safe] <= 0)
        if first_scores is not None:
            dead = dead | torch.isneginf(first_scores)
        return dead

    if row_mult is not None and metric == "cosine" and residual_q is None:
        cand = corpus_q[safe].float()                       # [Q, C, d]
        dots = torch.einsum("qcd,qd->qc", cand, qf)
        qn = torch.sqrt((qf * qf).sum(-1, keepdim=True).clamp_min(1e-60))
        scores = (dots * row_mult[safe] / qn).masked_fill(dead_mask(),
                                                          NEG_INF)
        return _select(scores, pos, k, dedup)
    cand = corpus_q[safe].float()                           # [Q, C, d]
    if scale is not None:
        cand = cand * scale[safe][..., None]
    if residual_q is not None:
        cand = cand + (residual_q[safe].float()
                       * residual_scale[safe][..., None])
    dots = torch.einsum("qcd,qd->qc", cand, qf)
    if metric == "dot":
        scores = dots
    elif metric == "cosine":
        cn2 = (cand * cand).sum(-1)
        qn = torch.sqrt((qf * qf).sum(-1, keepdim=True).clamp_min(1e-60))
        scores = torch.where(
            cn2 > 0, dots * torch.rsqrt(cn2.clamp_min(1e-60)) / qn,
            torch.zeros_like(dots))
    elif metric == "euclidean":
        cn2 = (cand * cand).sum(-1)
        qn2 = (qf * qf).sum(-1, keepdim=True)
        scores = -(qn2 - 2.0 * dots + cn2).clamp_min(0.0)
    else:
        raise ValueError(f"unsupported rerank metric: {metric}")
    s, out_pos = _select(scores.masked_fill(dead_mask(), NEG_INF), pos, k,
                         dedup)
    if metric == "euclidean":
        s = -torch.sqrt((-s).clamp_min(0.0))
    return s, out_pos


def gather_rerank_topk_chunked(corpus_q, pos, queries, k, metric="cosine",
                               scale=None, residual_q=None,
                               residual_scale=None, first_scores=None,
                               dedup=True, chunk=128, pre_select=None,
                               expand_pool=1, row_mult=None,
                               expand_window=0, valid_rows=None):
    """gather_rerank_topk with the query axis in chunks of ``chunk``,
    so the [Q, C, d] f32 gather never exceeds one chunk's.

    pre_select: keep only the top-``pre_select`` candidates per query by
    FIRST-pass score before gathering, equal scores by column as
    ``lax.top_k`` keeps them (exact: the JAX package cuts wide lists
    with ``approx_max_k``, which torch does not have). Requires
    first_scores.

    expand_pool=p: each surviving candidate is a pool winner of a
    pooled-bits first pass (``ops/ivf.batched_ivf_topk`` with
    selection=p); it is expanded to all p rows of its pool before the
    rescore, each carrying the winner's first-pass score. A true top-k
    row lost to a pool collision is a pool-mate of a higher-scoring
    winner, so expansion makes the pooled selection collision-exact.
    Pools are p aligned rows; with ``expand_window`` = W they are the
    strided pools of the batched kernel instead (row i * 128 + b of a
    W-row window, for i < W / 128). Positions must come from disjoint
    fixed windows. Pass ``valid_rows`` with it: a tombstoned pool-mate
    was never scored by the first pass."""
    if (pre_select is not None and first_scores is not None
            and pos.shape[1] > pre_select):
        first_scores, ci = _topk_stable(first_scores, pre_select)
        pos = torch.gather(pos, 1, ci)
    if expand_pool > 1:
        off = torch.arange(expand_pool, dtype=pos.dtype, device=pos.device)
        live = (pos >= 0)[:, :, None]
        if expand_window:
            w = expand_window
            first = (pos // w) * w + (pos % w) % 128
            off = off * 128
        else:
            first = pos - pos % expand_pool
        pos = torch.where(live, first[:, :, None] + off, -1
                          ).reshape(pos.shape[0], -1)
        if first_scores is not None:
            first_scores = first_scores.repeat_interleave(expand_pool, dim=1)
    parts_s, parts_p = [], []
    for q0 in range(0, pos.shape[0], chunk):
        q1 = q0 + chunk
        s, p_ = gather_rerank_topk(
            corpus_q, pos[q0:q1], queries[q0:q1], k, metric, scale,
            residual_q, residual_scale,
            None if first_scores is None else first_scores[q0:q1],
            dedup, row_mult, valid_rows)
        parts_s.append(s)
        parts_p.append(p_)
    if not parts_s:
        kk = min(k, pos.shape[1])
        return (queries.new_empty((0, kk)),
                torch.empty((0, kk), dtype=torch.int32,
                            device=queries.device))
    return torch.cat(parts_s), torch.cat(parts_p)


def int8_pooled_rerank_topk(corpus_q: torch.Tensor,
                            corpus_scale: torch.Tensor,
                            queries: torch.Tensor, k: int,
                            oversample: int = 8, pool: int = 4096,
                            mask: Optional[torch.Tensor] = None,
                            n_valid=None,
                            row_mult: Optional[torch.Tensor] = None,
                            residual_q: Optional[torch.Tensor] = None,
                            residual_scale: Optional[torch.Tensor] = None):
    """Pooled-bits selection + exact rerank. The int8 pooled scan
    (kernel 5) selects C = max(oversample * k, 64) candidates, one per
    pool, so distinct; their rows are rescored in f32 against the
    unquantized queries (through the precomputed cosine multipliers
    when there is no residual plane)."""
    c = min(max(oversample * k, 64), corpus_q.shape[0])
    s1, pos = int8_pooled_topk(corpus_q, corpus_scale, queries, c,
                               pool=pool, mask=mask, n_valid=n_valid,
                               row_mult=row_mult)
    return gather_rerank_topk(
        corpus_q, pos, queries, k, "cosine", corpus_scale, residual_q,
        residual_scale, first_scores=s1, dedup=False,
        row_mult=row_mult if residual_q is None else None)


def f32_pooled_rerank_topk(corpus: torch.Tensor, queries: torch.Tensor,
                           k: int, oversample: int = 8, pool: int = 4096,
                           mask: Optional[torch.Tensor] = None,
                           n_valid=None,
                           row_mult: Optional[torch.Tensor] = None):
    """f32 pooled-bits selection (kernel 6) + exact f32 rerank of the
    C = max(oversample * k, 64) candidates, which removes the log2(pool)
    truncated mantissa bits from the final scores."""
    c = min(max(oversample * k, 64), corpus.shape[0])
    s1, pos = f32_pooled_topk(corpus, queries, c, pool=pool, mask=mask,
                              n_valid=n_valid, row_mult=row_mult)
    return gather_rerank_topk(corpus, pos, queries, k, "cosine",
                              first_scores=s1, dedup=False)

"""Exact brute-force similarity scan: matmul + top-k (port of
``neumann_tpu/ops/scan.py``).

The scoring product is ``torch.matmul``, as the JAX package left it to
XLA: a plain large matrix product, in full f32 (TF32 is off, see the
package docstring). This is the exact route and the recall oracle.

Two strategies, both exact:

* **flat**: one product giving the full ``[Q, N]`` score matrix, then
  a top-k in ``lax.top_k``'s order (``_topk_stable``);
* **blockwise**: a loop over row blocks with a running top-k carry and
  an exact merge, never holding more than ``[Q, block]`` scores.

Both return what ``lax.top_k`` over the whole row returns: the k best
scores, equal scores by ascending row, so duplicated rows come back in
the JAX package's order and a page of a longer top-k is a slice of it.

Score conventions match the reference: cosine in [-1, 1], dot
unbounded, euclidean returned as **negative distance** (higher =
closer; the engine maps it to 1/(1+dist)).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

METRICS = ("cosine", "dot", "euclidean", "manhattan", "composite",
           "weighted_jaccard", "angular", "geodesic", "jaccard", "overlap")

# GeometricConfig presets (distance.rs:140-168): (cosine, structural,
# magnitude) weights.
COMPOSITE_DEFAULT = (0.5, 0.3, 0.2)
COMPOSITE_ANGULAR_HEAVY = (0.8, 0.1, 0.1)
COMPOSITE_STRUCTURAL_HEAVY = (0.2, 0.7, 0.1)
COMPOSITE_CONFLICT_DETECTION = (0.4, 0.5, 0.1)

NEG_INF = float("-inf")

# Above this many rows the flat [Q, N] score matrix is avoided in favor
# of the blockwise scan (256K rows * 64 queries * 4 B = 64 MB of scores).
_FLAT_MAX_ROWS = 256 * 1024
_DEFAULT_BLOCK_ROWS = 64 * 1024


def _as2d(queries: torch.Tensor) -> torch.Tensor:
    return queries if queries.ndim == 2 else queries[None, :]


def _dot_scores(queries, corpus_block):
    """[Q, d] x [B, d] -> [Q, B], f32."""
    return queries @ corpus_block.T


def _block_scores(queries, corpus_block, metric, q_sqnorm, c_sqnorm_block,
                  weights=COMPOSITE_DEFAULT):
    """Similarity scores (higher = better) for one corpus block.

    q_sqnorm: [Q, 1] squared query norms; c_sqnorm_block: [B] squared
    corpus row norms."""
    if metric == "composite":
        return _composite_scores(queries, corpus_block, q_sqnorm,
                                 c_sqnorm_block, weights)
    if metric == "manhattan":
        diff = (queries[:, None, :] - corpus_block[None, :, :]).abs()
        return -diff.sum(-1)
    if metric == "weighted_jaccard":
        # sum(min(|a|,|b|)) / sum(max(|a|,|b|)) in one broadcast pass
        qa = queries.abs()[:, None, :]
        ca = corpus_block.abs()[None, :, :]
        tot = qa.sum(-1) + ca.sum(-1)
        diff = (qa - ca).abs().sum(-1)
        max_sum = (tot + diff) * 0.5
        min_sum = (tot - diff) * 0.5
        return torch.where(max_sum > 0.0, min_sum / max_sum,
                           torch.ones_like(max_sum))
    if metric in ("jaccard", "overlap"):
        nz_q = (queries != 0.0).float()
        nz_c = (corpus_block != 0.0).float()
        inter = _dot_scores(nz_q, nz_c)
        nq = nz_q.sum(1, keepdim=True)
        nc = nz_c.sum(1)[None, :]
        if metric == "jaccard":
            union = nq + nc - inter
            return torch.where(union > 0.0, inter / union.clamp_min(1.0),
                               torch.ones_like(inter))
        smaller = torch.minimum(nq, nc)
        return torch.where(smaller > 0.0,
                           inter / smaller.clamp_min(1.0),
                           torch.zeros_like(inter))
    dots = _dot_scores(queries, corpus_block)
    if metric == "dot":
        return dots
    if metric in ("cosine", "angular", "geodesic"):
        # arccos is monotone: scan orders by cosine, _finalize maps
        metric = "cosine"
    if metric == "cosine":
        q_inv = torch.rsqrt(q_sqnorm.clamp_min(1e-30))
        c_inv = torch.rsqrt(c_sqnorm_block.clamp_min(1e-30))
        scores = dots * q_inv * c_inv[None, :]
        zero = (q_sqnorm <= 0.0) | (c_sqnorm_block <= 0.0)[None, :]
        return scores.masked_fill(zero, 0.0)
    if metric == "euclidean":
        d2 = q_sqnorm - 2.0 * dots + c_sqnorm_block[None, :]
        return -d2.clamp_min(0.0)
    raise ValueError(f"unknown metric: {metric}")


def _composite_scores(queries, corpus_block, q_sqnorm, c_sqnorm_block,
                      weights):
    """Weighted composite geometric score in [0, 1]: cosine mapped to
    [0, 1], Jaccard overlap of the nonzero supports, 1/(1+euclidean)."""
    w_cos, w_struct, w_mag = (float(w) for w in weights)
    total = w_cos + w_struct + w_mag
    if total <= 0.0:
        return queries.new_zeros((queries.shape[0], corpus_block.shape[0]))
    dots = _dot_scores(queries, corpus_block)
    q_inv = torch.rsqrt(q_sqnorm.clamp_min(1e-30))
    c_inv = torch.rsqrt(c_sqnorm_block.clamp_min(1e-30))
    cos = dots * q_inv * c_inv[None, :]
    zero = (q_sqnorm <= 0.0) | (c_sqnorm_block <= 0.0)[None, :]
    cos01 = torch.where(zero, torch.full_like(cos, 0.5), (cos + 1.0) * 0.5)
    nz_q = (queries != 0.0).float()
    nz_c = (corpus_block != 0.0).float()
    inter = _dot_scores(nz_q, nz_c)
    union = nz_q.sum(1, keepdim=True) + nz_c.sum(1)[None, :] - inter
    jac = inter / union.clamp_min(1.0)
    d2 = (q_sqnorm - 2.0 * dots + c_sqnorm_block[None, :]).clamp_min(0.0)
    mag = 1.0 / (1.0 + torch.sqrt(d2))
    return (w_cos * cos01 + w_struct * jac + w_mag * mag) / total


_LOW = (1 << 32) - 1
# a selection over at most this many scores ([Q, N] elements) orders the
# whole plane by one stable sort of its int32 image; above, one
# torch.topk of int64 keys (``_int_keys``). On an H100 the sort took
# 0.19-0.21 ms at 1 x 2^20 scores against 0.40-0.50 for the keys, and
# 0.52 ms at 4 x 2^20 against 0.39-0.47 (host ms a call,
# scripts/torch_ties_cost.py)
_SORT_MAX = 1 << 21


def _image(scores: torch.Tensor) -> torch.Tensor:
    """The order-preserving int32 image of f32 scores' bits: the IEEE
    total order that ``lax.top_k`` ranks by (a NaN with the sign bit
    set, what inf / inf and 0 * inf give, below -inf; a positive NaN
    above +inf), where ``torch.topk`` puts every NaN first."""
    assert scores.dtype == torch.float32, scores.dtype
    b = scores.contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def stable_keys(scores: torch.Tensor, c0: int = 0) -> torch.Tensor:
    """``_topk_stable``'s int64 keys of f32 scores [Q, B] at columns
    c0 .. c0 + B - 1: the bits' order-preserving int32 image above the
    column's complement (a greater key is a better column; distinct
    columns give distinct keys). The ADC kernel's select mode
    (csrc/pq_adc.cu) builds the same keys."""
    return _int_keys(_image(scores), c0)


def _int_keys(img: torch.Tensor, c0: int = 0) -> torch.Tensor:
    """int64 keys of int32 values [Q, B] at columns c0 .. c0 + B - 1:
    the value above the column's complement."""
    cols = torch.arange(c0, c0 + img.shape[1], device=img.device)
    return (img.long() << 32) | (_LOW - cols)


def _topk_stable(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest f32 scores along dim 1, as
    ``lax.top_k`` gives them: in the IEEE total order (``_image``),
    equal scores by ascending index (``_int_topk_stable`` of the int32
    image). Every selection of the port over f32 scores takes it."""
    idx = _int_topk_stable(_image(scores), k)[1]
    return torch.gather(scores, 1, idx), idx


def _int_topk_stable(values: torch.Tensor, k: int):
    """(values, indices) of the k largest int32 ``values`` along dim 1,
    equal values by ascending index, as ``lax.top_k`` on int32: a stable
    descending sort of the rows up to ``_SORT_MAX`` values, else a
    ``torch.topk`` of int64 keys (``_int_keys``)."""
    if values.numel() <= _SORT_MAX:
        v, idx = torch.sort(values, dim=1, descending=True, stable=True)
        return v[:, :k], idx[:, :k]
    top = torch.topk(_int_keys(values), k, dim=1).values
    return (top >> 32).int(), _LOW - (top & _LOW)


def _finalize(scores, metric):
    """Convert internal ordering scores to reportable scores."""
    if metric == "euclidean":
        return -torch.sqrt((-scores).clamp_min(0.0))
    if metric in ("angular", "geodesic"):
        finite = torch.isfinite(scores)
        safe = torch.where(finite, scores, torch.zeros_like(scores))
        return torch.where(finite, -torch.arccos(safe.clamp(-1.0, 1.0)),
                           scores)
    return scores


def score_all(corpus: torch.Tensor, queries: torch.Tensor,
              metric: str = "cosine", mask: Optional[torch.Tensor] = None,
              weights=COMPOSITE_DEFAULT) -> torch.Tensor:
    """Full [Q, N] score matrix (flat path). Masked entries are -inf."""
    queries = _as2d(queries).float()
    corpus = corpus.float()
    q_sq = (queries * queries).sum(1, keepdim=True)
    c_sq = (corpus * corpus).sum(1)
    scores = _block_scores(queries, corpus, metric, q_sq, c_sq, weights)
    if mask is not None:
        scores = scores.masked_fill(~mask[None, :], NEG_INF)
    return scores


def topk_scan(corpus: torch.Tensor, queries: torch.Tensor, k: int,
              metric: str = "cosine", mask: Optional[torch.Tensor] = None,
              block_rows: int = _DEFAULT_BLOCK_ROWS,
              weights=COMPOSITE_DEFAULT):
    """Exact top-k similarity search.

    corpus [N, d] float (padding rows masked out by ``mask``), queries
    [Q, d] or [d], mask optional [N] bool fused into the scan as -inf.
    An explicit ``block_rows`` below the default forces the blockwise
    path even for small corpora (tests reach it at toy sizes).

    Returns (scores [Q, k] f32, indices [Q, k] int32) sorted descending;
    slots past the valid rows carry score -inf and index -1.
    """
    queries = _as2d(queries)
    if queries.shape[-1] != corpus.shape[-1]:
        raise ValueError(
            f"query dim {queries.shape[-1]} != corpus dim "
            f"{corpus.shape[-1]} (corpus may be lane-padded; pad the query "
            f"with zeros to match)")
    n = corpus.shape[0]
    k = min(k, n)
    flat = (n <= block_rows
            or (block_rows >= _DEFAULT_BLOCK_ROWS and n <= _FLAT_MAX_ROWS))
    if flat:
        scores = score_all(corpus, queries, metric, mask, weights)
        top_s, top_i = _topk_stable(scores, k)
        top_i = top_i.masked_fill(torch.isneginf(top_s), -1)
        return _finalize(top_s, metric), top_i.int()
    return _blockwise_topk(corpus, queries, k, metric, mask, block_rows,
                           weights)


def _blockwise_topk(corpus, queries, k, metric, mask, block_rows,
                    weights=COMPOSITE_DEFAULT):
    """Each block's top-k by ``_topk_stable``, merged into the carry by
    ``_topk_stable`` (2k candidates, the carry's rows before the block's,
    so equal scores stay by ascending row)."""
    queries = queries.float()
    n = corpus.shape[0]
    q = queries.shape[0]
    q_sq = (queries * queries).sum(1, keepdim=True)
    best_s = queries.new_full((q, k), NEG_INF)
    best_i = torch.full((q, k), -1, dtype=torch.int64,
                        device=queries.device)
    for start in range(0, n, block_rows):
        block = corpus[start:start + block_rows].float()
        c_sq = (block * block).sum(1)
        s = _block_scores(queries, block, metric, q_sq, c_sq, weights)
        if mask is not None:
            s = s.masked_fill(~mask[None, start:start + block_rows],
                              NEG_INF)
        bs, bi = _topk_stable(s, min(k, s.shape[1]))
        cand_s = torch.cat([best_s, bs], dim=1)
        cand_i = torch.cat([best_i, bi + start], dim=1)
        best_s, pos = _topk_stable(cand_s, k)
        best_i = torch.gather(cand_i, 1, pos)
    best_i = best_i.masked_fill(torch.isneginf(best_s), -1)
    return _finalize(best_s, metric), best_i.int()


def host_pull(*tensors):
    """Copy several tensors to host numpy arrays with ONE device sync:
    every device->host copy is queued non-blocking first, then the
    stream is synchronised once. numpy inputs pass through untouched.
    Returns a tuple of np.ndarray in argument order."""
    staged = []
    on_cuda = False
    for t in tensors:
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                on_cuda = True
                t = t.to("cpu", non_blocking=True)
            staged.append(t)
        else:
            staged.append(np.asarray(t))
    if on_cuda:
        torch.cuda.current_stream().synchronize()
    return tuple(t.numpy() if isinstance(t, torch.Tensor) else t
                 for t in staged)

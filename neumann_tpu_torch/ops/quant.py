"""Quantized corpus storage modes and their scans (port of
``neumann_tpu/ops/quant.py``).

int8: per-row symmetric scale (absmax/127), round half to even, clip to
[-127, 127] — the same arithmetic as the JAX package, so an int8 plane
quantized by either package is bit-identical. The JAX package's scale
is absmax / 127 where it runs eagerly or in numpy and absmax *
float32(1 / 127) under ``jax.jit``, so each port call site names the
form of its JAX counterpart (``int8_scale``); either form gives the same
bits on the CPU and on the card. Scans quantize the query the same way
and score int8 x int8 -> int32 through the hand kernels of
``ops/kernels.py``:

* ``int8_topk_scan``: block scores by ``int8_dot_scores`` (kernel 4),
  a running keyed merge across row blocks (equal scores in row order);
* ``int8_pooled_topk`` / ``f32_pooled_topk``: the pooled-bits cosine
  scans, one ``int8_pooled_bits`` / ``f32_pooled_bits`` launch over the
  whole corpus (the JAX package's row blocks exist for XLA's sake), then
  a cut over the [Q, N / pool] winner bits;
* ``int8_exact_topk``: the query kept in f32 and the rows converted to
  f32 (the IVF delta plane's scan), one ``int8_exact_topk`` launch
  (kernel 9) with the top-k inside, or its scores above k 64.

binary: sign bits packed 32 per word; the JAX package's uint32 words
are int32 bit patterns here (torch's uint32 lacks most bitwise ops).
``hamming_topk`` selects by the fused ``hamming_topk`` (kernel 7), or
``hamming_scores`` (kernel 3) above its k cap, with the semantics of
``hamming_topk_pallas``.

Scalars where the JAX package writes ``lax.rsqrt`` are ``1 / sqrt``
here: two correctly rounded steps, which is what XLA computes on the
CPU inside the fused scans (the int8 winner bits match only so), while
torch's CUDA ``rsqrt`` is an approximation.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from neumann_tpu_torch.ops import kernels
from neumann_tpu_torch.ops.scan import (
    NEG_INF,
    _as2d,
    _int_topk_stable,
)


# float32(1 / 127): the factor XLA multiplies by where a jitted function
# divides by the constant 127
_INV_127 = float(np.float32(1.0) / np.float32(127.0))
SCALE_FORMS = ("divide", "reciprocal")


def int8_scale(absmax: torch.Tensor, form: str = "divide") -> torch.Tensor:
    """The int8 scale absmax / 127 of each row (1 for a zero row), in the
    arithmetic of the JAX call site a port site stands for:

    * "divide": absmax divided by 127, as numpy and eager ``jnp`` compute
      it (the slab's host quantizer, an eager ``scalar_quantize``);
    * "reciprocal": absmax times float32(1 / 127), as XLA computes the
      division by a constant under ``jax.jit``.

    The two differ by one ulp for about 5 % of absmax values. Each form
    gives the same bits on the CPU and on the card: the divisor is a
    0-dim tensor on absmax's device, since CUDA's division by a CPU
    scalar multiplies by its rounded reciprocal (and the CPU's divides)."""
    if form == "divide":
        s = absmax / torch.full((), 127.0, device=absmax.device)
    elif form == "reciprocal":
        s = absmax * _INV_127
    else:
        raise ValueError(f"int8 scale form {form!r} not in {SCALE_FORMS}")
    return torch.where(absmax > 0, s, torch.ones_like(absmax))


def scalar_quantize(x: torch.Tensor, form: str = "divide"):
    """Quantize [N, d] f32 -> (int8 [N, d], per-row scale [N] f32): the
    scale by ``int8_scale(absmax, form)``, each value divided by its
    row's scale (tensor by tensor: a true division on either device),
    rounded half to even and clipped to [-127, 127]. Under ``jax.jit``
    the JAX package's ``scalar_quantize`` is ``form="reciprocal"``,
    called eagerly ``form="divide"``."""
    x = x.float()
    scale = int8_scale(x.abs().amax(dim=-1), form)
    q = torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def scalar_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def _inv_sqrt(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.sqrt(x)


def corpus_sqnorms(corpus_q: torch.Tensor,
                   corpus_scale: torch.Tensor) -> torch.Tensor:
    """Per-row squared L2 norms of an int8 corpus ([N] f32)."""
    return (corpus_q.float() ** 2).sum(dim=1) * corpus_scale ** 2


def _row_multiplier(corpus_scale, cn2, metric: str):
    """Per-row score multiplier: scale / ||row|| for cosine (0 for a
    zero row), the scale itself otherwise."""
    if metric == "cosine":
        return torch.where(cn2 > 0, corpus_scale * _inv_sqrt(
            cn2.clamp_min(1e-30)), torch.zeros_like(cn2))
    return corpus_scale


def int8_cosine_row_mult(corpus_q: torch.Tensor,
                         corpus_scale: torch.Tensor) -> torch.Tensor:
    """Per-row cosine multiplier scale/||row|| (0 = zero row): a unit
    row is ``corpus_q * row_mult``."""
    return _row_multiplier(corpus_scale,
                           corpus_sqnorms(corpus_q, corpus_scale), "cosine")


def int8_exact_topk(corpus_q: torch.Tensor, row_mult: torch.Tensor,
                    queries: torch.Tensor, k: int,
                    block_rows: int = 256 * 1024):
    """Exact cosine top-k over an int8 corpus with UNQUANTIZED f32
    queries and f32 math throughout (the recall oracle, and the IVF
    delta plane's scan): the queries unit-normalised, then
    ``kernels.int8_exact_topk`` (``csrc/int8_exact.cu`` on the card, its
    plain version on the CPU): scores (query . row) * row_mult, equal
    scores by ascending row as ``lax.top_k`` orders them. row_mult =
    ``int8_cosine_row_mult`` (0 marks invalid rows). ``block_rows``
    steps the plain version and the kernel's scores mode (k above 64):
    the kernel's results do not depend on it, the plain version's sums
    may move in the last bits with the size of its matmul.

    Returns (scores [Q, k] f32, rows [Q, k] int64, -1 where -inf)."""
    qf = _as2d(queries).float()
    qf = qf / qf.norm(dim=1, keepdim=True).clamp_min(1e-30)
    return kernels.int8_exact_topk(corpus_q, row_mult, qf, k,
                                   block_rows=block_rows)


def f32_cosine_row_mult(corpus: torch.Tensor) -> torch.Tensor:
    """Per-row cosine multiplier 1 / ||row|| of an f32 corpus (0 = zero
    row)."""
    cn2 = (corpus * corpus).sum(dim=1)
    return torch.where(cn2 > 0, _inv_sqrt(cn2.clamp_min(1e-30)),
                       torch.zeros_like(cn2))


def _quantize_queries(queries: torch.Tensor):
    """(qq int8 [Q, d], q_scale [Q], ||dequantized query||^2 [Q]); the
    scales in the reciprocal form: the JAX scans quantize their queries
    under ``jax.jit`` (the engine jits ``int8_topk_scan``, and
    ``int8_pooled_topk`` runs inside its callers' jitted programs)."""
    qq, q_scale = scalar_quantize(queries, form="reciprocal")
    q_norm2 = ((qq.float() * q_scale[:, None]) ** 2).sum(dim=1)
    return qq, q_scale, q_norm2


def _int8_block_scores(qq, q_scale, q_norm, block_q, block_scale,
                       metric: str, cn2=None, row_mult=None):
    """Scores [Q, B] of one int8 corpus block through ``int8_dot_scores``
    (kernel 4). qq [Q, d] int8, q_scale [Q], q_norm [Q] dequantized
    query norms; cn2 / row_mult optional precomputed per-row terms.
    Euclidean is an epilogue on the kernel's scale-only output."""
    if metric == "dot":
        return kernels.int8_dot_scores(block_q, block_scale, qq, q_scale)
    if metric == "cosine":
        if row_mult is None:
            if cn2 is None:
                cn2 = corpus_sqnorms(block_q, block_scale)
            row_mult = _row_multiplier(block_scale, cn2, metric)
        q_inv = _inv_sqrt((q_norm * q_norm).clamp_min(1e-30))
        qmult = torch.where(q_norm > 0, q_scale * q_inv,
                            torch.zeros_like(q_norm))
        return kernels.int8_dot_scores(block_q, row_mult, qq, qmult)
    if metric == "euclidean":
        if cn2 is None:
            cn2 = corpus_sqnorms(block_q, block_scale)
        dots = kernels.int8_dot_scores(block_q, block_scale, qq, q_scale)
        d2 = (q_norm[:, None] ** 2 - 2.0 * dots) + cn2[None, :]
        return -d2.clamp_min(0.0)
    raise ValueError(f"unsupported int8 metric: {metric}")


# the keyed selection builds its int64 keys this many at a time
_KEY_STEP_ELEMS = 1 << 24


def int8_topk_scan(corpus_q: torch.Tensor, corpus_scale: torch.Tensor,
                   queries: torch.Tensor, k: int, metric: str = "cosine",
                   mask: Optional[torch.Tensor] = None,
                   block_rows: int = 512 * 1024,
                   corpus_sqnorm: Optional[torch.Tensor] = None):
    """Top-k over an int8 corpus with the query quantized per query, so
    scores come from int8 x int8 -> int32 dots (kernel 4); both scales
    rescale them afterwards. Blockwise over ``block_rows`` rows with a
    running exact merge on keys that order equal scores by row, as
    ``lax.top_k`` does (the JAX package's ``exact`` selection). Returns
    (scores [Q, k] f32, ids [Q, k] int32, -1 where the score is -inf);
    euclidean scores are -distance."""
    queries = _as2d(queries).float()
    if queries.shape[-1] != corpus_q.shape[-1]:
        raise ValueError(f"query dim {queries.shape[-1]} != corpus dim "
                         f"{corpus_q.shape[-1]}")
    qq, q_scale, q_norm2 = _quantize_queries(queries)
    q_norm = torch.sqrt(q_norm2)
    n = corpus_q.shape[0]
    k = min(k, n)
    if corpus_sqnorm is None and metric != "dot":
        corpus_sqnorm = corpus_sqnorms(corpus_q, corpus_scale)
    row_mult = (_row_multiplier(corpus_scale, corpus_sqnorm, metric)
                if metric == "cosine" else None)
    q = queries.shape[0]
    step = max(1, _KEY_STEP_ELEMS // max(q, 1))
    best = torch.empty((q, 0), dtype=torch.int64, device=corpus_q.device)
    for r0 in range(0, n, block_rows):
        r1 = min(n, r0 + block_rows)
        s = _int8_block_scores(
            qq, q_scale, q_norm, corpus_q[r0:r1], corpus_scale[r0:r1],
            metric,
            cn2=None if corpus_sqnorm is None else corpus_sqnorm[r0:r1],
            row_mult=None if row_mult is None else row_mult[r0:r1])
        if mask is not None:
            s = s.masked_fill(~mask[None, r0:r1], NEG_INF)
        for c0 in range(0, r1 - r0, step):
            best = kernels.merge_keys(
                best, kernels.score_keys(s[:, c0:c0 + step], r0 + c0), k,
                largest=True)
    best_s, best_i = kernels.decode_score_keys(best)
    best_i = best_i.masked_fill(torch.isneginf(best_s), -1).int()
    if metric == "euclidean":
        best_s = -torch.sqrt((-best_s).clamp_min(0.0))
    return best_s, best_i


# ---------------------------------------------------------------------------
# pooled-bits cosine scans
# ---------------------------------------------------------------------------

def _pick_pool(n: int, k: int, pool: int) -> Optional[int]:
    """Largest power-of-two pool in [8, `pool`] that divides n with
    n / pool >= k, or None when no pooled layout fits. The JAX package's
    ``_pick_pool_blocks`` also splits the rows into blocks for XLA; the
    port scans the whole corpus in one launch and needs only the pool."""
    p = 1 << (max(pool, 1).bit_length() - 1)   # round down to a power of 2
    while p >= 8:
        if n % p == 0 and n // p >= k:
            return p
        p //= 2
    return None


def _pooled_bits_select(allbits: torch.Tensor, pool: int, k: int):
    """Final candidate cut over the packed [Q, N/pool] winner bits:
    (scores [Q, k] f32, rows [Q, k] int32, -1 / -inf where dead).

    An exact top-k in ``lax.top_k``'s order (bit-pattern order is score
    order; equal patterns by ascending pool: ``_int_topk_stable`` over
    the N / pool winners). The JAX package can instead cut with
    ``lax.approx_max_k`` (``selector="approx[:target]"``), which torch
    does not have; the exact cut keeps every candidate the approximate
    one would, so its recall is at least as high."""
    tb, pos = _int_topk_stable(allbits, min(k, allbits.shape[1]))
    local = tb & (pool - 1)
    score = (tb & ~(pool - 1)).view(torch.float32) - 2.0
    rows = pos.int() * pool + local
    # dead rows carry negative patterns (the -1e30 bias); any live score
    # is >= 1.0, so its bits are a positive int
    dead = tb <= 0
    return (score.masked_fill(dead, NEG_INF),
            rows.masked_fill(dead, -1).int())


def _live_bias(n: int, mask, n_valid, device) -> torch.Tensor:
    """Per-row additive shift: 2.0 live, -1e30 dead (mask False or row
    >= n_valid), so dead rows bitcast negative and never win a pool."""
    live = torch.ones(n, dtype=torch.bool, device=device)
    if n_valid is not None:
        live &= torch.arange(n, device=device) < int(n_valid)
    if mask is not None:
        live &= mask
    return torch.where(live, torch.full((n,), 2.0, device=device),
                       torch.full((n,), -1e30, device=device))


def int8_pooled_topk(corpus_q: torch.Tensor, corpus_scale: torch.Tensor,
                     queries: torch.Tensor, k: int, pool: int = 4096,
                     mask: Optional[torch.Tensor] = None, n_valid=None,
                     row_mult: Optional[torch.Tensor] = None):
    """Cosine top-k over an int8 corpus via the pooled-bits scan.

    Scores are shifted to [1, 3), bitcast to int32 and the low
    log2(pool) mantissa bits replaced by the row's index in its pool of
    ``pool`` consecutive rows, so one max per pool carries the
    (truncated) score and its argmax (``int8_pooled_bits``, kernel 5);
    the cut over the [Q, N / pool] winners recovers global rows. At most
    one row per pool survives. Raises ValueError without a pooled layout
    (``_pick_pool``: n % pool == 0, n / pool >= k). Cosine only."""
    queries = _as2d(queries).float()
    n = corpus_q.shape[0]
    picked = _pick_pool(n, k, pool)
    if picked is None:
        raise ValueError(f"no pooled layout for n={n}, k={k}, pool<={pool}")
    pool = picked
    if row_mult is None:
        row_mult = _row_multiplier(
            corpus_scale, corpus_sqnorms(corpus_q, corpus_scale), "cosine")
    qq, q_scale, q_norm2 = _quantize_queries(queries)
    qmult = torch.where(q_norm2 > 0,
                        q_scale * _inv_sqrt(q_norm2.clamp_min(1e-30)),
                        torch.zeros_like(q_norm2))
    bias = _live_bias(n, mask, n_valid, corpus_q.device)
    allbits = kernels.int8_pooled_bits(corpus_q, row_mult.contiguous(), bias,
                                       qq, qmult, pool)
    return _pooled_bits_select(allbits, pool, k)


def f32_pooled_topk(corpus: torch.Tensor, queries: torch.Tensor, k: int,
                    pool: int = 4096, mask: Optional[torch.Tensor] = None,
                    n_valid=None, row_mult: Optional[torch.Tensor] = None):
    """Cosine top-k over an f32 corpus via the pooled-bits scan: as
    ``int8_pooled_topk`` with full-f32 dots (``f32_pooled_bits``,
    kernel 6). row_mult defaults to 1 / ||row|| (0 for a zero row)."""
    queries = _as2d(queries).float()
    n = corpus.shape[0]
    picked = _pick_pool(n, k, pool)
    if picked is None:
        raise ValueError(f"no pooled layout for n={n}, k={k}, pool<={pool}")
    pool = picked
    if row_mult is None:
        row_mult = f32_cosine_row_mult(corpus)
    q_norm2 = (queries * queries).sum(dim=1)
    qmult = torch.where(q_norm2 > 0, _inv_sqrt(q_norm2.clamp_min(1e-30)),
                        torch.zeros_like(q_norm2))
    bias = _live_bias(n, mask, n_valid, corpus.device)
    allbits = kernels.f32_pooled_bits(corpus, row_mult.contiguous(), bias,
                                      queries.contiguous(), qmult, pool)
    return _pooled_bits_select(allbits, pool, k)


# ---------------------------------------------------------------------------
# binary (1-bit) quantization
# ---------------------------------------------------------------------------

def binary_quantize(x: torch.Tensor) -> torch.Tensor:
    """Pack sign bits of [N, d] into int32 bit patterns [N, ceil(d/32)]:
    bit j of word w is x[:, 32 w + j] > 0 (the JAX package's uint32
    words, same bits)."""
    n, d = x.shape
    words = -(-d // 32)
    bits = torch.zeros((n, words * 32), dtype=torch.int64, device=x.device)
    bits[:, :d] = (x > 0).long()
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=x.device),
        torch.arange(32, device=x.device))
    packed = (bits.reshape(n, words, 32) * weights).sum(dim=2)
    # [0, 2^32) -> the same 32 bits as int32
    return torch.where(packed >= 1 << 31, packed - (1 << 32),
                       packed).to(torch.int32)


def hamming_kernel(k: int) -> str:
    """The kernel ``hamming_topk`` launches for a top-``k``: the fused
    top-k up to its cap, the hamming distances above it."""
    return "hamming_topk" if k <= kernels.HAMMING_TOPK_CAP else \
        "hamming_scores"


def hamming_topk(corpus_bits: torch.Tensor, query_bits: torch.Tensor,
                 k: int, mask: Optional[torch.Tensor] = None,
                 block_rows: int = 128 * 1024):
    """Top-k by smallest hamming distance, as the JAX package's
    ``hamming_topk`` / ``hamming_topk_pallas``: the k best rows by
    (distance ascending, row ascending), ``lax.top_k``'s order among
    equal distances; score = -distance (f32), -inf / -1 for masked rows
    and past the live rows.

    Up to ``kernels.HAMMING_TOPK_CAP`` one fused ``hamming_topk`` launch
    (kernel 7) over the whole corpus. Above it (the fused kernel keeps k
    keys a query in shared memory) ``hamming_scores`` (kernel 3) per
    block of ``block_rows`` rows and the same keyed merge: a dispatch on
    k, like the f32 / int8 kernels' switches on Q. Results do not depend
    on ``block_rows``."""
    query_bits = _as2d(query_bits).contiguous()
    if hamming_kernel(k) == "hamming_topk":
        return kernels.hamming_topk(corpus_bits, query_bits, mask, k)
    n, q = corpus_bits.shape[0], query_bits.shape[0]
    best = torch.empty((q, 0), dtype=torch.int64, device=corpus_bits.device)
    for r0 in range(0, n, block_rows):
        dist = kernels.hamming_scores(corpus_bits[r0:r0 + block_rows],
                                      query_bits)
        best = kernels.merge_keys(best, kernels.hamming_keys(dist, r0, mask),
                                  k)
    return kernels.decode_hamming_keys(best)

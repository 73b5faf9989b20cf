"""Semantic conflict detection over transaction delta vectors.

Parity with tensor_chain/src/consensus.rs:29-354: concurrent transactions
are classified by the geometry of their delta embeddings (cosine) plus
structural overlap of their touched-key sets (Jaccard):

  Identical   — same keys, parallel deltas: duplicate, keep one
  Orthogonal  — disjoint keys, near-orthogonal deltas: auto-merge by
                vector addition
  Similar     — overlapping intent, compatible direction: merge with care
  Conflicting — overlapping keys with opposing deltas: reject/serialize

The pairwise classification over a batch of N pending transactions is one
[N, N] cosine product on the device — the reference's 52M pairs/s CPU
loop (tensor-chain.md:35) becomes two matrix products and a pass over
their results.

The port's copy of ``neumann_tpu/chain/consensus.py``: the host
classifiers are the same; ``classify_pairwise_codes`` and
``classify_pairwise`` take the ``device`` to run on (default "cuda"),
and ``pairwise_codes_kernel``, a jitted JAX function there, is plain
torch here.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Sequence, Set, Tuple

import numpy as np
import torch


class ConflictClass(Enum):
    IDENTICAL = "identical"
    ORTHOGONAL = "orthogonal"
    SIMILAR = "similar"
    CONFLICTING = "conflicting"


@dataclass
class ConsensusConfig:
    orthogonal_threshold: float = 0.1   # |cos| below => orthogonal
    identical_threshold: float = 0.98   # cos above + same keys => identical
    similar_threshold: float = 0.5
    jaccard_conflict: float = 0.0       # any key overlap counts


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def _jaccard(a: Set[str], b: Set[str]) -> float:
    if not a and not b:
        return 1.0
    return len(a & b) / len(a | b)


def classify_conflict(delta_a: np.ndarray, keys_a: Set[str],
                      delta_b: np.ndarray, keys_b: Set[str],
                      config: ConsensusConfig = ConsensusConfig()
                      ) -> ConflictClass:
    cos = _cosine(np.asarray(delta_a, np.float32),
                  np.asarray(delta_b, np.float32))
    jac = _jaccard(keys_a, keys_b)
    if jac > config.jaccard_conflict:
        # structurally overlapping
        if cos >= config.identical_threshold and keys_a == keys_b:
            return ConflictClass.IDENTICAL
        if cos >= config.similar_threshold:
            return ConflictClass.SIMILAR
        return ConflictClass.CONFLICTING
    # structurally disjoint
    if abs(cos) <= config.orthogonal_threshold:
        return ConflictClass.ORTHOGONAL
    if cos >= config.similar_threshold:
        return ConflictClass.SIMILAR
    return ConflictClass.ORTHOGONAL if abs(cos) < config.similar_threshold \
        else ConflictClass.CONFLICTING


def classify_delta_geometry(delta_a: np.ndarray, delta_b: np.ndarray,
                            config: ConsensusConfig = ConsensusConfig()
                            ) -> ConflictClass:
    """Geometry-only classification (used by partition merge, where the
    key sets are identical by construction): orthogonal deltas to the
    same entity change disjoint dimensions and merge by addition."""
    cos = _cosine(np.asarray(delta_a, np.float32),
                  np.asarray(delta_b, np.float32))
    if abs(cos) <= config.orthogonal_threshold:
        return ConflictClass.ORTHOGONAL
    if cos >= config.identical_threshold:
        return ConflictClass.IDENTICAL
    if cos >= config.similar_threshold:
        return ConflictClass.SIMILAR
    return ConflictClass.CONFLICTING


# index -> class for the vectorized code matrix
_CLASS_BY_CODE = (ConflictClass.IDENTICAL, ConflictClass.SIMILAR,
                  ConflictClass.ORTHOGONAL, ConflictClass.CONFLICTING)


def classify_pairwise_codes(deltas: np.ndarray,
                            key_sets: Sequence[Set[str]],
                            config: ConsensusConfig = ConsensusConfig(),
                            device="cuda") -> np.ndarray:
    """All-pairs classification on ``device``.

    Returns an int8 [n, n] matrix indexing ``_CLASS_BY_CODE``
    (0=IDENTICAL 1=SIMILAR 2=ORTHOGONAL 3=CONFLICTING). Both geometry
    and structure are matrix products on the device: the cosine matrix
    over the delta vectors, and the intersection-size matrix over a
    {0,1} key-set incidence (Jaccard = inter / (|a|+|b|-inter); set
    equality = inter == |a| == |b|). The classification rules then run
    as one lookup over the [n, n] results. On an NVIDIA H100 80GB HBM3
    at 700 W, 4,096 deltas x 768 with 1,024 keys take 2.4-2.5 ms on the
    card (38 launches; the call 13.5-153 ms, the incidence built on the
    host), by ``chip_smoke.py`` phase 18b.
    """
    deltas = np.asarray(deltas, np.float32)
    n = deltas.shape[0]
    vocab: dict = {}
    for ks in key_sets:
        for k in ks:
            vocab.setdefault(k, len(vocab))
    inc = np.zeros((n, max(len(vocab), 1)), np.float32)
    for i, ks in enumerate(key_sets):
        for k in ks:
            inc[i, vocab[k]] = 1.0

    device = torch.device(device)
    codes = pairwise_codes_kernel(
        torch.from_numpy(deltas).to(device),
        torch.from_numpy(inc).to(device),
        config.identical_threshold, config.similar_threshold,
        config.orthogonal_threshold, config.jaccard_conflict)
    return codes.cpu().numpy()


def _code_table() -> np.ndarray:
    """pairwise_codes_kernel's rules as a lookup: index
    v*8 + e*4 + s*2 + o -> class code, where v: the key sets overlap
    (Jaccard above the conflict threshold); e: equal key sets and cos >=
    identical; s: cos >= similar; o: |cos| <= orthogonal."""
    table = np.zeros(16, np.int8)
    for v in (0, 1):
        for e in (0, 1):
            for s in (0, 1):
                for o in (0, 1):
                    if v:
                        code = 0 if e else (1 if s else 3)
                    else:
                        code = 2 if o else (1 if s else 2)
                    table[v * 8 + e * 4 + s * 2 + o] = code
    return table


_CODE_TABLE = _code_table()


def pairwise_codes_kernel(d: torch.Tensor, a: torch.Tensor,
                          ident_t: float, similar_t: float,
                          orth_t: float, jacc_t: float) -> torch.Tensor:
    """Core of classify_pairwise_codes: deltas [n, dim] f32 and key-set
    incidence [n, K] f32 on one device -> int8 [n, n] class codes there.

    Both products run in f32; TF32 would round their operands, so it
    must be off (checked, as ``ops/ivf._int8_dots`` checks it)."""
    if d.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("pairwise classification needs TF32 off "
                           "(torch.backends.cuda.matmul.allow_tf32)")
    f32 = torch.float32
    norms = torch.linalg.vector_norm(d, dim=1, keepdim=True)
    dn = torch.where(norms > 0, d / norms.clamp_min(1e-30),
                     torch.zeros((), dtype=f32, device=d.device))
    cos = dn @ dn.T
    inter = a @ a.T
    sizes = a.sum(1)
    union = sizes[:, None] + sizes[None, :] - inter
    # empty-vs-empty: _jaccard returns 1.0
    jac = torch.where(union > 0, inter / union.clamp_min(1e-30),
                      torch.ones((), dtype=f32, device=d.device))
    eq = (inter >= sizes[:, None]) & (inter >= sizes[None, :])
    # a Python float against an f32 tensor compares in f32, as JAX's
    # np.float32 thresholds do
    idx = (jac > jacc_t).to(torch.uint8) << 3
    idx |= (eq & (cos >= ident_t)).to(torch.uint8) << 2
    idx |= (cos >= similar_t).to(torch.uint8) << 1
    idx |= (cos.abs() <= orth_t).to(torch.uint8)
    table = torch.from_numpy(_CODE_TABLE).to(d.device)
    return table[idx.long()]


def classify_pairwise(deltas: np.ndarray,
                      key_sets: Sequence[Set[str]],
                      config: ConsensusConfig = ConsensusConfig(),
                      device="cuda"
                      ) -> List[Tuple[int, int, ConflictClass]]:
    """All-pairs classification as (i, j, class) tuples (i < j)."""
    n = len(key_sets)
    if n < 2:
        return []
    codes = classify_pairwise_codes(deltas, key_sets, config, device)
    out = []
    for i in range(n):
        row = codes[i]
        for j in range(i + 1, n):
            out.append((i, j, _CLASS_BY_CODE[row[j]]))
    return out


def merge_orthogonal(deltas: Sequence[np.ndarray]) -> np.ndarray:
    """Orthogonal transactions merge by vector addition
    (tensor_chain auto-merge, lib.rs:1090-1120)."""
    return np.sum([np.asarray(d, np.float32) for d in deltas], axis=0)

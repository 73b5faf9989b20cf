"""Product quantization on one GPU: subspace codebooks and the ADC scan
(port of ``neumann_tpu/ops/pq.py``).

Vectors are split into M subspaces, each quantized to one of 256
centroids learned with the port's k-means (``parallel/partitioner.
kmeans``, seeded per subspace as the JAX package seeds it); codes are an
[N, M] uint8 device tensor. A query's asymmetric-distance (ADC) table is
[M, 256] squared distances of its subvectors to the centroids; scanning
is a gather-and-sum over the code matrix with the top-k selected inside
the hand-written kernel (``ops/kernels.pq_adc_topk``, ``csrc/pq_adc.cu``)
for k up to ``kernels.PQ_ADC_TOPK_CAP``, or its scores
(``ops/kernels.pq_adc_scores``) and the exact-order top-k of
``ops/scan._topk_stable`` above the cap; either way in ``lax.top_k``'s
order, so rows with equal codes, whose distances tie exactly, come out
by ascending row.

Encoding is a plain batched product (``torch.bmm`` of subvectors and
codebooks, then the argmin), as the JAX package leaves it to XLA, in
steps of rows: the [M, N, 256] distances of a million rows at M = 96
would be 96 GiB. Tables are built for all queries at once on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from neumann_tpu_torch.ops import kernels
from neumann_tpu_torch.ops.scan import _topk_stable

# bytes of f32 temporaries one encode / table / scan step may hold
_STEP_BYTES = 1 << 28
# bytes a scan step may hold: [Q, N] scores and their int64 selection
# keys above the kernel's k cap, the [Q, M, 256] tables and the kernel's
# interleaved copy within it; and the most queries the ADC kernel scores
# a launch
_SCAN_STEP_BYTES = 1 << 30
_MAX_LAUNCH_QUERIES = 65535


@dataclass
class PQConfig:
    n_subspaces: int = 8       # M
    n_centroids: int = 256     # codes per subspace (uint8)
    iters: int = 15


def to_f32(x, device) -> torch.Tensor:
    """numpy or tensor -> f32 tensor on device."""
    if torch.is_tensor(x):
        return x.to(device, torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


class PQCodebook:
    """codebooks: [M, 256, d/M] f32 on the host (as the JAX package keeps
    them), with a copy on ``device`` for encoding and tables."""

    def __init__(self, dim: int, config: Optional[PQConfig] = None,
                 device="cuda"):
        self.dim = dim
        self.config = config or PQConfig()
        if dim % self.config.n_subspaces:
            raise ValueError(
                f"dim {dim} not divisible by {self.config.n_subspaces} "
                f"subspaces")
        self.sub_dim = dim // self.config.n_subspaces
        self.device = torch.device(device)
        self.codebooks: Optional[np.ndarray] = None
        self._books: Optional[torch.Tensor] = None

    @classmethod
    def from_codebooks(cls, codebooks: np.ndarray,
                       config: Optional[PQConfig] = None,
                       device="cuda") -> "PQCodebook":
        """A trained codebook from [M, 256, sub_dim] centroids."""
        books = np.asarray(codebooks, np.float32)
        m, _, sd = books.shape
        book = cls(m * sd, config or PQConfig(n_subspaces=m), device)
        book.codebooks = books.copy()
        return book

    def train(self, sample) -> None:
        """Per subspace s, ``kmeans(sub, 256, iters, seed=s)`` on the
        codebook's device; sample [N, dim] numpy or tensor."""
        from neumann_tpu_torch.parallel.partitioner import kmeans

        x = sample if torch.is_tensor(sample) else np.asarray(sample,
                                                              np.float32)
        m = self.config.n_subspaces
        books = []
        for s in range(m):
            sub = x[:, s * self.sub_dim:(s + 1) * self.sub_dim]
            if torch.is_tensor(sub):
                sub = sub.contiguous()
            k = min(self.config.n_centroids, len(sub))
            cents = kmeans(sub, k, self.config.iters, seed=s,
                           device=self.device)
            if len(cents) < self.config.n_centroids:
                pad = np.zeros((self.config.n_centroids - len(cents),
                                self.sub_dim), np.float32)
                cents = np.concatenate([cents, pad])
            books.append(cents)
        self.codebooks = np.stack(books)  # [M, 256, sub_dim]
        self._books = None

    def _require_trained(self) -> torch.Tensor:
        if self.codebooks is None:
            raise ValueError("codebook not trained")
        if self._books is None:
            self._books = torch.from_numpy(self.codebooks).to(self.device)
        return self._books

    def encode(self, vectors) -> torch.Tensor:
        """[N, d] -> codes [N, M] uint8 on the device (nearest centroid
        per subspace: the argmin of ``|x|^2 - 2 x.c + |c|^2``)."""
        books = self._require_trained()
        m, sd = self.config.n_subspaces, self.sub_dim
        n = len(vectors)
        codes = torch.empty((n, m), dtype=torch.uint8, device=self.device)
        bb = (books * books).sum(-1)[:, None, :]           # [M, 1, 256]
        bt = books.transpose(1, 2)                          # [M, sd, 256]
        step = max(1, _STEP_BYTES // (4 * m * books.shape[1]))
        for r0 in range(0, n, step):
            x = to_f32(vectors[r0:r0 + step], self.device)
            xt = x.reshape(x.shape[0], m, sd).transpose(0, 1)  # [M, b, sd]
            d2 = ((xt * xt).sum(-1, keepdim=True)
                  - 2.0 * torch.bmm(xt, bt) + bb)
            codes[r0:r0 + step] = d2.argmin(dim=-1).T.to(torch.uint8)
        return codes

    def decode(self, codes) -> torch.Tensor:
        """codes [N, M] -> [N, d] f32 centroids, on the device."""
        books = self._require_trained()
        c = torch.as_tensor(codes).to(self.device).long()
        m = self.config.n_subspaces
        return books[torch.arange(m, device=self.device)[None, :],
                     c].reshape(c.shape[0], self.dim)

    def compute_adc_table(self, query) -> np.ndarray:
        """[M, 256] squared-distance lookup table for one query (host)."""
        return self.adc_tables(to_f32(query, self.device).reshape(1, -1))[0] \
            .cpu().numpy()

    def adc_tables(self, queries: torch.Tensor) -> torch.Tensor:
        """[Q, M, 256] tables of queries [Q, d] on the device: the
        squared distance of each query subvector to each centroid,
        ``sum((c - q)^2)`` as the JAX package computes one table."""
        books = self._require_trained()
        m, sd = self.config.n_subspaces, self.sub_dim
        q = queries.shape[0]
        out = torch.empty((q, m, books.shape[1]), dtype=torch.float32,
                          device=self.device)
        step = max(1, _STEP_BYTES // (4 * books.numel()))
        for q0 in range(0, q, step):
            qs = queries[q0:q0 + step].to(self.device, torch.float32)
            diff = books[None] - qs.reshape(-1, m, 1, sd)
            out[q0:q0 + step] = (diff * diff).sum(-1)
        return out

    def adc_distance(self, table, code) -> float:
        """Squared distance of one encoded vector to the tabled query."""
        return float(sum(table[s, c] for s, c in enumerate(code)))


def pq_topk(codebook: PQCodebook, codes: torch.Tensor, queries, k: int,
            mask: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC top-k: smallest squared distance first (score = -d2).

    codes [N, M] uint8 on the codebook's device, queries [Q, d] or [d]
    (numpy or tensor), mask [N] bool. Returns (scores [Q, k] f32, ids
    [Q, k] int32) on the device, ``lax.top_k``'s order; -inf / -1 past
    the live rows. Queries go in steps that bound the [Q, N] scores
    above the kernel's k cap, and the tables within it."""
    dev = codebook.device
    q = to_f32(queries, dev)
    if q.ndim == 1:
        q = q[None, :]
    codes = torch.as_tensor(codes).to(dev, torch.uint8).contiguous()
    n = codes.shape[0]
    k = min(k, n)
    valid = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
             else torch.as_tensor(mask).to(dev, torch.bool).contiguous())
    select = 1 <= k <= kernels.PQ_ADC_TOPK_CAP
    per_query = (8 * codes.shape[1] * codebook.config.n_centroids if select
                 else 12 * max(n, 1))
    step = max(1, min(_MAX_LAUNCH_QUERIES, _SCAN_STEP_BYTES // per_query))
    scores, ids = [], []
    for q0 in range(0, q.shape[0], step):
        tables = codebook.adc_tables(q[q0:q0 + step])
        if select:
            s, i = kernels.pq_adc_topk(codes, tables, valid, k)
        else:
            s, i = _topk_stable(kernels.pq_adc_scores(codes, tables, valid),
                                k)
        scores.append(s)
        ids.append(i.masked_fill(torch.isneginf(s), -1).int())
    return torch.cat(scores), torch.cat(ids)

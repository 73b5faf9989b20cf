"""Delta vectors vs archetype centroids.

Parity with tensor_store/src/delta_vector.rs: store an embedding as
(archetype id, sparse delta from that archetype's centroid); the registry
discovers archetypes with k-means and batch-encodes. Decode is centroid +
delta. Compression comes from thresholding the delta to sparse.

The port's copy of ``neumann_tpu/store/delta_vector.py``: only its
import lines differ, and the registry takes the ``device`` its
k-means runs on at scale (the card by default; a cluster node passes its
own), as the JAX package's runs on its default device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from neumann_tpu_torch.store.sparse import SparseVector


@dataclass(frozen=True)
class DeltaVector:
    archetype: int
    delta: SparseVector

    @property
    def dim(self) -> int:
        return self.delta.dim

    @staticmethod
    def from_dense_with_reference(dense: np.ndarray, ref: np.ndarray,
                                  archetype: int,
                                  threshold: float = 0.01) -> "DeltaVector":
        diff = np.asarray(dense, np.float32) - np.asarray(ref, np.float32)
        return DeltaVector(archetype,
                           SparseVector.from_dense(diff, threshold))

    def to_dense(self, ref: np.ndarray) -> np.ndarray:
        return np.asarray(ref, np.float32) + self.delta.to_dense()

    def nnz(self) -> int:
        return self.delta.nnz


class KMeansConfig:
    def __init__(self, k: int = 8, iters: int = 20, seed: int = 0):
        self.k = k
        self.iters = iters
        self.seed = seed


class ArchetypeRegistry:
    """Discovers archetype centroids (device k-means) and encodes batches
    of embeddings as deltas against their nearest archetype."""

    def __init__(self, threshold: float = 0.01, device="cuda"):
        self.threshold = threshold
        self.device = device
        self.centroids: Optional[np.ndarray] = None

    def discover_archetypes(self, sample: np.ndarray,
                            config: Optional[KMeansConfig] = None) -> int:
        from neumann_tpu_torch.parallel.partitioner import kmeans

        cfg = config or KMeansConfig()
        self.centroids = kmeans(np.asarray(sample, np.float32), cfg.k,
                                cfg.iters, cfg.seed, device=self.device)
        return len(self.centroids)

    def _nearest(self, vectors: np.ndarray) -> np.ndarray:
        c = self.centroids
        v = np.asarray(vectors, np.float32)
        d2 = (np.sum(v * v, 1)[:, None] - 2 * v @ c.T
              + np.sum(c * c, 1)[None, :])
        return np.argmin(d2, axis=1)

    def encode(self, vector: np.ndarray) -> DeltaVector:
        return self.encode_batch(np.asarray(vector)[None, :])[0]

    def encode_batch(self, vectors: np.ndarray) -> List[DeltaVector]:
        if self.centroids is None:
            raise ValueError("no archetypes discovered")
        assign = self._nearest(vectors)
        out = []
        for v, a in zip(np.asarray(vectors, np.float32), assign):
            out.append(DeltaVector.from_dense_with_reference(
                v, self.centroids[a], int(a), self.threshold))
        return out

    def decode(self, dv: DeltaVector) -> np.ndarray:
        if self.centroids is None:
            raise ValueError("no archetypes discovered")
        return dv.to_dense(self.centroids[dv.archetype])

    def compression_stats(self, dvs: Sequence[DeltaVector]
                          ) -> Tuple[float, float]:
        """(avg nnz fraction, est. size ratio vs dense f32)."""
        if not dvs:
            return 0.0, 1.0
        nnz_frac = float(np.mean([dv.nnz() / dv.dim for dv in dvs]))
        # sparse entry = 4B pos + 4B val vs 4B dense
        ratio = max(nnz_frac * 2.0, 1e-6)
        return nnz_frac, ratio

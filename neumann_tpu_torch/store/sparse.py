"""Sparse vectors: COO positions + values.

Capability parity with tensor_store/src/sparse_vector.rs:70-1148 (from_dense,
thresholded construction, O(nnz) dot/cosine, geometric metrics). Host-side
representation is numpy; dense materialization feeds the device scan.

The port's copy of ``neumann_tpu/store/sparse.py``:
only its import lines differ.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEFAULT_VALUE_THRESHOLD = 0.01
DEFAULT_SPARSITY_THRESHOLD = 0.7


@dataclass(frozen=True)
class SparseVector:
    positions: np.ndarray  # int32, sorted ascending
    values: np.ndarray     # float32
    dim: int

    # -- constructors --------------------------------------------------
    @staticmethod
    def from_dense(dense, threshold: float = 0.0) -> "SparseVector":
        arr = np.asarray(dense, dtype=np.float32)
        keep = np.abs(arr) > threshold
        pos = np.nonzero(keep)[0].astype(np.int32)
        return SparseVector(pos, arr[keep], int(arr.shape[0]))

    @staticmethod
    def from_dense_with_threshold(dense, threshold: float) -> "SparseVector":
        return SparseVector.from_dense(dense, threshold)

    # -- basics ---------------------------------------------------------
    @property
    def nnz(self) -> int:
        return int(self.positions.shape[0])

    def sparsity(self) -> float:
        return 1.0 - self.nnz / self.dim if self.dim else 0.0

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.dim, dtype=np.float32)
        out[self.positions] = self.values
        return out

    def magnitude(self) -> float:
        return float(np.sqrt(np.sum(self.values.astype(np.float64) ** 2)))

    # -- products --------------------------------------------------------
    def dot(self, other: "SparseVector") -> float:
        i = j = 0
        a_pos, b_pos = self.positions, other.positions
        # vectorized sorted intersection
        common, ia, ib = np.intersect1d(
            a_pos, b_pos, assume_unique=True, return_indices=True)
        del i, j, common
        return float(np.dot(self.values[ia].astype(np.float64),
                            other.values[ib].astype(np.float64)))

    def dot_dense(self, dense) -> float:
        arr = np.asarray(dense, dtype=np.float32)
        return float(np.dot(self.values.astype(np.float64),
                            arr[self.positions].astype(np.float64)))

    def cosine_similarity(self, other: "SparseVector") -> float:
        ma, mb = self.magnitude(), other.magnitude()
        if ma == 0.0 or mb == 0.0:
            return 0.0
        return self.dot(other) / (ma * mb)

    # -- geometric metrics (distance.rs:76-172 parity) -------------------
    def angular_distance(self, other: "SparseVector") -> float:
        c = np.clip(self.cosine_similarity(other), -1.0, 1.0)
        return float(np.arccos(c) / np.pi)

    def geodesic_distance(self, other: "SparseVector") -> float:
        """Arc length on the hypersphere == angular distance
        (sparse_vector.rs:805-808)."""
        return self.angular_distance(other)

    def jaccard(self, other: "SparseVector") -> float:
        a = set(self.positions.tolist())
        b = set(other.positions.tolist())
        if not a and not b:
            return 1.0
        return len(a & b) / len(a | b)

    def weighted_jaccard(self, other: "SparseVector") -> float:
        """sum(min(|a|,|b|)) / sum(max(|a|,|b|)) — magnitude-aware
        overlap (sparse_vector.rs:886-930). 1.0 for two empty vectors."""
        vals: dict = {}
        for pos, v in zip(self.positions.tolist(), self.values.tolist()):
            vals[pos] = (abs(v), 0.0)
        for pos, v in zip(other.positions.tolist(),
                          other.values.tolist()):
            a, _ = vals.get(pos, (0.0, 0.0))
            vals[pos] = (a, abs(v))
        min_sum = sum(min(a, b) for a, b in vals.values())
        max_sum = sum(max(a, b) for a, b in vals.values())
        if max_sum == 0.0:
            return 1.0
        return min_sum / max_sum

    def overlap(self, other: "SparseVector") -> float:
        a = set(self.positions.tolist())
        b = set(other.positions.tolist())
        m = min(len(a), len(b))
        if m == 0:
            return 0.0
        return len(a & b) / m

    def __eq__(self, other):
        return (
            isinstance(other, SparseVector)
            and self.dim == other.dim
            and np.array_equal(self.positions, other.positions)
            and np.array_equal(self.values, other.values)
        )

"""Delta replication: archetype-coded state transfer.

Parity with tensor_chain/src/delta_replication.rs (4-6x bandwidth
reduction): instead of shipping full embeddings to replicas, the sender
encodes each vector as (archetype id, sparse delta) against a shared
archetype registry, and the receiver reconstructs. The registry itself
replicates once (it is tiny); only sparse deltas ride the wire
afterwards.

The port's copy of ``neumann_tpu/chain/delta_replication.py``:
only its import lines differ.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from neumann_tpu_torch.store.delta_vector import ArchetypeRegistry
from neumann_tpu_torch.store.sparse import SparseVector


class DeltaReplicator:
    def __init__(self, registry: ArchetypeRegistry):
        self.registry = registry
        self.bytes_full = 0
        self.bytes_delta = 0

    def encode_batch(self, items: List[Tuple[str, np.ndarray]]
                     ) -> List[dict]:
        """[(key, vector)] -> wire records."""
        keys = [k for k, _ in items]
        vecs = np.stack([np.asarray(v, np.float32) for _, v in items])
        out = []
        for key, dv in zip(keys, self.registry.encode_batch(vecs)):
            self.bytes_full += dv.dim * 4
            self.bytes_delta += 4 + dv.nnz() * 8
            out.append({
                "key": key,
                "archetype": dv.archetype,
                "dim": dv.dim,
                "positions": dv.delta.positions.tolist(),
                "values": dv.delta.values.tolist(),
            })
        return out

    def decode_batch(self, records: List[dict]
                     ) -> List[Tuple[str, np.ndarray]]:
        out = []
        for rec in records:
            sparse = SparseVector(
                np.asarray(rec["positions"], np.int32),
                np.asarray(rec["values"], np.float32),
                rec["dim"])
            base = self.registry.centroids[rec["archetype"]]
            out.append((rec["key"],
                        base + sparse.to_dense()))
        return out

    def bandwidth_ratio(self) -> float:
        """Full-precision bytes / delta bytes actually sent."""
        if self.bytes_delta == 0:
            return 1.0
        return self.bytes_full / self.bytes_delta

    def registry_snapshot(self) -> dict:
        """The once-per-epoch registry payload for new replicas."""
        return {"centroids": self.registry.centroids.tolist(),
                "threshold": self.registry.threshold}

    @staticmethod
    def from_snapshot(snapshot: dict) -> "DeltaReplicator":
        reg = ArchetypeRegistry(threshold=snapshot["threshold"])
        reg.centroids = np.asarray(snapshot["centroids"], np.float32)
        return DeltaReplicator(reg)

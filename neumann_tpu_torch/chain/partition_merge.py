"""Partition merge: semantic reconciliation after split-brain heals.

Parity with tensor_chain/src/partition_merge.rs (6-phase heal protocol):

  1. DETECT   — both sides discover the heal (membership converges)
  2. FREEZE   — writes pause while states exchange
  3. EXCHANGE — each side ships its divergent key set + delta embeddings
  4. CLASSIFY — per-key conflicts classified by delta geometry
                (the same consensus kernel used at commit time)
  5. RESOLVE  — orthogonal changes merge by addition, identical dedupe,
                similar takes the higher-chain side, conflicting keys go
                to the resolution log for the caller
  6. RESUME   — merged state applies on both sides, writes unfreeze

The merge itself is host logic over the stores; the pairwise
classification is the device matmul from chain.consensus.

The port's copy of ``neumann_tpu/chain/partition_merge.py``:
only its import lines differ.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from neumann_tpu_torch.chain.consensus import (
    ConflictClass,
    ConsensusConfig,
    classify_delta_geometry,
)
from neumann_tpu_torch.store import codec
from neumann_tpu_torch.store.tensor_store import TensorData, TensorStore

PHASES = ("detect", "freeze", "exchange", "classify", "resolve",
          "resume")


@dataclass
class MergeReport:
    phases_completed: List[str] = field(default_factory=list)
    merged: List[str] = field(default_factory=list)
    deduped: List[str] = field(default_factory=list)
    took_left: List[str] = field(default_factory=list)
    took_right: List[str] = field(default_factory=list)
    conflicts: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.phases_completed == list(PHASES)


def _embedding_of(data: Optional[TensorData], dim: int) -> np.ndarray:
    if data is None:
        return np.zeros(dim, np.float32)
    emb = data.get("embedding")
    if emb is None or not emb.is_vector():
        return np.zeros(dim, np.float32)
    v = emb.to_dense()
    return v if v.size == dim else np.zeros(dim, np.float32)


class PartitionMerger:
    def __init__(self, embedding_dim: int = 64,
                 consensus: Optional[ConsensusConfig] = None):
        self.dim = embedding_dim
        self.consensus = consensus or ConsensusConfig()
        self.frozen = False

    def merge(self, left: TensorStore, right: TensorStore,
              base: Optional[TensorStore] = None,
              left_height: int = 0, right_height: int = 0
              ) -> MergeReport:
        """Reconcile two diverged stores in place (both end identical)."""
        report = MergeReport()
        # 1 DETECT (caller observed the heal) + 2 FREEZE
        report.phases_completed.append("detect")
        self.frozen = True
        report.phases_completed.append("freeze")

        # 3 EXCHANGE: divergent keys
        lkeys, rkeys = set(left.keys()), set(right.keys())
        divergent: Set[str] = set()
        for key in lkeys | rkeys:
            ld, rd = left.get(key), right.get(key)
            if ld is None or rd is None:
                divergent.add(key)
            elif codec.encode_data(ld) != codec.encode_data(rd):
                divergent.add(key)
        report.phases_completed.append("exchange")

        # 4 CLASSIFY + 5 RESOLVE per key
        for key in sorted(divergent):
            ld, rd = left.get(key), right.get(key)
            bd = base.get(key) if base is not None else None
            if ld is None or rd is None:
                # one side created (or deleted) it: creation wins unless
                # the base had it (then it was a delete)
                existed_before = bd is not None
                src = ld if ld is not None else rd
                if existed_before:
                    left.delete(key)
                    right.delete(key)
                    (report.took_left if rd is None
                     else report.took_right).append(key)
                else:
                    left.put(key, src)
                    right.put(key, src)
                    (report.took_left if ld is not None
                     else report.took_right).append(key)
                continue
            base_emb = _embedding_of(bd, self.dim)
            dl = _embedding_of(ld, self.dim) - base_emb
            dr = _embedding_of(rd, self.dim) - base_emb
            cls = classify_delta_geometry(dl, dr, self.consensus)
            if cls == ConflictClass.IDENTICAL:
                right.put(key, ld)
                report.deduped.append(key)
            elif cls == ConflictClass.ORTHOGONAL:
                # semantic merge by vector addition over the base
                merged = TensorData()
                winner = ld if left_height >= right_height else rd
                for name, val in winner.fields.items():
                    merged.set(name, val)
                from neumann_tpu_torch.store.tensor_store import TensorValue

                merged.set("embedding",
                           TensorValue.vector(base_emb + dl + dr))
                left.put(key, merged)
                right.put(key, merged)
                report.merged.append(key)
            elif cls == ConflictClass.SIMILAR:
                winner, loser_store, tag = (
                    (ld, right, report.took_left)
                    if left_height >= right_height
                    else (rd, left, report.took_right))
                loser_store.put(key, winner)
                tag.append(key)
            else:
                # CONFLICTING: higher chain wins, but record it for the
                # operator's resolution log
                winner, loser_store, _ = (
                    (ld, right, None) if left_height >= right_height
                    else (rd, left, None))
                loser_store.put(key, winner)
                report.conflicts.append(key)
        report.phases_completed.append("classify")
        report.phases_completed.append("resolve")

        # 6 RESUME
        self.frozen = False
        report.phases_completed.append("resume")
        return report

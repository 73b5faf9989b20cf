"""TensorChain: transactional chain over the tensor store.

Parity with tensor_chain::TensorChain (lib.rs:968-1075) and
TransactionWorkspace (transaction.rs:309-574): begin() opens a workspace
that buffers ops and captures before/after embeddings; commit() detects
semantic conflicts against other pending workspaces, auto-merges
orthogonal ones, snapshots the store for rollback, applies ops, computes
the state root, and appends a signed block; rollback on any failure.

The port's copy of ``neumann_tpu/chain/tensor_chain.py``:
only its import lines differ, and the chain takes the ``device`` its
codebooks' k-means runs on (the router's own; "cuda" by default).
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Set

import numpy as np

from neumann_tpu_torch.chain.block import Chain, StateRootTracker
from neumann_tpu_torch.chain.consensus import (
    ConflictClass,
    ConsensusConfig,
    classify_conflict,
)
from neumann_tpu_torch.store import codec
from neumann_tpu_torch.store.tensor_store import TensorData, TensorStore
from neumann_tpu_torch.utils.errors import ChainError


class TransactionWorkspace:
    def __init__(self, tx_id: int, chain: "TensorChain"):
        self.tx_id = tx_id
        self._chain = chain
        self.ops: List[dict] = []
        self._staged: Dict[str, Optional[TensorData]] = {}
        self.open = True

    # -- buffered ops ------------------------------------------------------
    def put(self, key: str, data: TensorData) -> None:
        self._require_open()
        self.ops.append({"op": "put", "key": key})
        self._staged[key] = data

    def delete(self, key: str) -> None:
        self._require_open()
        self.ops.append({"op": "delete", "key": key})
        self._staged[key] = None

    def get(self, key: str) -> Optional[TensorData]:
        """Read-your-writes view."""
        if key in self._staged:
            return self._staged[key]
        return self._chain.store.get(key)

    def keys_touched(self) -> Set[str]:
        return set(self._staged)

    def delta_embedding(self) -> np.ndarray:
        """Semantic delta: sum of (after - before) embedding changes."""
        dim = self._chain.embedding_dim
        delta = np.zeros(dim, np.float32)
        for key, after in self._staged.items():
            before = self._chain.store.get(key)
            for data, sign in ((before, -1.0), (after, +1.0)):
                if data is None:
                    continue
                emb = data.get("embedding")
                if emb is not None and emb.is_vector():
                    v = emb.to_dense()
                    if v.size == dim:
                        delta += sign * v
        return delta

    def _require_open(self) -> None:
        if not self.open:
            raise ChainError(f"transaction {self.tx_id} is closed")


class TensorChain:
    def __init__(self, store: Optional[TensorStore] = None,
                 embedding_dim: int = 64,
                 consensus: Optional[ConsensusConfig] = None,
                 signing_key: bytes = b"neumann", device="cuda"):
        from neumann_tpu_torch.chain.codebook import CodebookManager

        self.store = store if store is not None else TensorStore()
        self.chain = Chain(signing_key)
        self.embedding_dim = embedding_dim
        self.consensus = consensus or ConsensusConfig()
        # the codebooks' k-means runs on ``device`` at scale
        self.codebooks = CodebookManager(device=device)
        self._pending: Dict[int, TransactionWorkspace] = {}
        self._tx_ids = itertools.count(1)
        self._lock = threading.RLock()
        # observability: timings + counters (tensor_chain/src/metrics.rs)
        from neumann_tpu_torch.chain.metrics import ChainMetrics

        self.metrics = ChainMetrics()
        # incremental state root: seed from the current store, then
        # stay fresh through the store's put/delete hooks (covers
        # both tx commits and out-of-band store writes)
        self._root_tracker = StateRootTracker()
        self._root_tracker.seed(
            (key, codec.encode_data(self.store.get(key)))
            for key in self.store.keys())
        self.store.on_put(
            lambda key, data: self._root_tracker.on_put_payload(
                key, codec.encode_data(data)))
        self.store.on_delete(self._root_tracker.on_delete)

    # -- tx lifecycle ------------------------------------------------------
    def begin(self) -> TransactionWorkspace:
        with self._lock:
            tx = TransactionWorkspace(next(self._tx_ids), self)
            self._pending[tx.tx_id] = tx
            return tx

    def rollback(self, tx: TransactionWorkspace) -> None:
        with self._lock:
            tx.open = False
            self._pending.pop(tx.tx_id, None)
            self.metrics.rollbacks += 1

    def detect_conflicts(self, tx: TransactionWorkspace
                         ) -> List[dict]:
        """Classify tx against every other pending workspace."""
        out = []
        with self._lock:
            others = [o for o in self._pending.values()
                      if o.tx_id != tx.tx_id and o.ops]
        if not others:
            return out
        da, ka = tx.delta_embedding(), tx.keys_touched()
        for o in others:
            cls = classify_conflict(da, ka, o.delta_embedding(),
                                    o.keys_touched(), self.consensus)
            out.append({"other": o.tx_id, "class": cls})
        return out

    def find_orthogonal_merge(self, tx: TransactionWorkspace
                              ) -> List[TransactionWorkspace]:
        """Pending txs that can auto-merge with tx (all orthogonal)."""
        merges = []
        for c in self.detect_conflicts(tx):
            if c["class"] == ConflictClass.ORTHOGONAL:
                merges.append(self._pending[c["other"]])
            elif c["class"] == ConflictClass.CONFLICTING:
                return []  # a conflict blocks auto-merge entirely
        return merges

    def commit(self, tx: TransactionWorkspace,
               auto_merge: bool = False) -> int:
        """Apply tx (plus orthogonal co-txs if auto_merge), append a
        block. Returns the new chain height. Conflicting pending txs
        raise; the store is restored on any failure."""
        with self._lock, self.metrics.commit.timed():
            tx._require_open()
            with self.metrics.conflict_check.timed():
                conflicts = self.detect_conflicts(tx)
            hard = [c for c in conflicts
                    if c["class"] == ConflictClass.CONFLICTING]
            if hard:
                self.metrics.conflicts_rejected += 1
                raise ChainError(
                    f"tx {tx.tx_id} conflicts with "
                    f"{[c['other'] for c in hard]}")
            group = [tx]
            if auto_merge:
                group += self.find_orthogonal_merge(tx)
                self.metrics.auto_merges += len(group) - 1

            # snapshot touched keys for rollback
            touched: Set[str] = set()
            for t in group:
                touched |= t.keys_touched()
            before = {k: self.store.get(k) for k in touched}
            delta = np.sum([t.delta_embedding() for t in group], axis=0)

            try:
                for t in group:
                    for key, data in t._staged.items():
                        if data is None:
                            self.store.delete(key)
                        else:
                            self.store.put(key, data)
                root = self._state_root()
                block = self.chain.new_block(
                    transactions=[{"id": t.tx_id, "ops": t.ops}
                                  for t in group],
                    state_root=root,
                    delta_embedding=delta)
                self.chain.append(block)
                # quantize the delta against the chain codebooks
                # (lib.rs:1040-1049); the code compresses history and
                # feeds transition-validity analysis. Early blocks get
                # their codes backfilled once the global book trains.
                self.codebooks.observe(delta, block.height)
                sync = getattr(self, "_code_sync", 0)
                trans = self.codebooks.transitions
                while sync < len(trans):
                    blk = self.chain.get_block(trans[sync]["height"])
                    if blk is not None:
                        blk.codebook_code = trans[sync]["code"]
                    sync += 1
                self._code_sync = sync
            except Exception:
                for key, data in before.items():
                    if data is None:
                        self.store.delete(key)
                    else:
                        self.store.put(key, data)
                raise
            for t in group:
                t.open = False
                self._pending.pop(t.tx_id, None)
            self.metrics.commits += len(group)
            self.metrics.blocks += 1
            return self.chain.height

    # -- chain views --------------------------------------------------------
    def _state_root(self) -> str:
        return self._root_tracker.root()

    @property
    def height(self) -> int:
        return self.chain.height

    def get_block(self, height: int):
        return self.chain.get_block(height)

    def tip(self):
        return self.chain.tip()

    def history(self, key: str) -> List[dict]:
        return self.chain.history(key)

    def verify(self) -> bool:
        return self.chain.verify()

    def similar_blocks(self, embedding: np.ndarray, limit: int = 5
                       ) -> List[dict]:
        """Blocks ranked by delta-embedding cosine similarity."""
        q = np.asarray(embedding, np.float32)
        qn = float(np.linalg.norm(q))
        scored = []
        for blk in self.chain.blocks():
            if blk.delta_embedding is None:
                continue
            v = np.asarray(blk.delta_embedding, np.float32)
            nv = float(np.linalg.norm(v))
            if qn == 0 or nv == 0 or v.size != q.size:
                continue
            scored.append((float(np.dot(q, v) / (qn * nv)), blk.height))
        scored.sort(reverse=True)
        return [{"height": h, "score": s} for s, h in scored[:limit]]

    def drift(self, from_height: int, to_height: int) -> dict:
        """Cumulative semantic drift between two heights."""
        total = np.zeros(self.embedding_dim, np.float32)
        count = 0
        for h in range(from_height, min(to_height, self.height)):
            blk = self.chain.get_block(h)
            if blk and blk.delta_embedding is not None:
                total += np.asarray(blk.delta_embedding, np.float32)
                count += 1
        return {"from": from_height, "to": to_height, "blocks": count,
                "drift_norm": float(np.linalg.norm(total))}

    def rollback_to(self, height: int) -> int:
        """Truncate the chain (store state is the caller's concern via
        checkpoints — parity with ROLLBACK CHAIN TO)."""
        return self.chain.truncate(height)

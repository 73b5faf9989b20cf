"""Blocks and the local chain.

Parity with tensor_chain/src/{block,chain,state_root}.rs: blocks carry
transactions, the previous block hash, a state root over the store, an
optional delta embedding summarizing the block's semantic change, and an
HMAC-SHA256 signature (the reference signs with Ed25519; signing.py adds
Ed25519 identities on top when the cryptography backend provides them).

The port's copy of ``neumann_tpu/chain/block.py``:
only its import lines differ.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from neumann_tpu_torch.utils.errors import ChainError


def compute_state_root(entries: Dict[str, bytes]) -> str:
    """Order-independent Merkle-ish root: sha256 over sorted (key, hash)."""
    h = hashlib.sha256()
    for key in sorted(entries):
        h.update(key.encode("utf-8"))
        h.update(hashlib.sha256(entries[key]).digest())
    return h.hexdigest()


def entry_digest(key: str, payload: bytes) -> int:
    """Per-entry hash for the incremental root, as a 256-bit int."""
    kb = key.encode("utf-8")
    h = hashlib.sha256()
    h.update(len(kb).to_bytes(4, "little"))
    h.update(kb)
    h.update(hashlib.sha256(payload).digest())
    return int.from_bytes(h.digest(), "big")


class StateRootTracker:
    """Incremental order-independent state root (XOR-homomorphic
    hashing, the LtHash idea): the accumulator is the XOR of a 256-bit
    hash per live entry, updated in O(1) per put/delete via store
    hooks. The reference recomputes its root incrementally too
    (tensor_chain/src/state_root.rs); the previous implementation here
    re-encoded the whole store on every commit, which made commit
    latency grow linearly with store size."""

    __slots__ = ("_acc", "_hashes")

    def __init__(self):
        self._acc = 0
        self._hashes: Dict[str, int] = {}

    def seed(self, items) -> None:
        """Initialize from (key, payload_bytes) pairs."""
        for key, payload in items:
            self.on_put_payload(key, payload)

    def on_put_payload(self, key: str, payload: bytes) -> None:
        nh = entry_digest(key, payload)
        old = self._hashes.get(key)
        if old is not None:
            self._acc ^= old
        self._acc ^= nh
        self._hashes[key] = nh

    def on_delete(self, key: str) -> None:
        old = self._hashes.pop(key, None)
        if old is not None:
            self._acc ^= old

    def root(self) -> str:
        return hashlib.sha256(
            self._acc.to_bytes(32, "big")).hexdigest()


@dataclass
class Block:
    height: int
    prev_hash: str
    timestamp: float
    transactions: List[dict] = field(default_factory=list)
    state_root: str = ""
    delta_embedding: Optional[List[float]] = None
    signature: str = ""
    # nearest global-codebook archetype for the delta (compressed
    # history, tensor_chain codebook.rs); set after append, like the
    # signature it is not part of the hashed header
    codebook_code: Optional[int] = None

    def header_bytes(self) -> bytes:
        return json.dumps({
            "height": self.height, "prev": self.prev_hash,
            "ts": self.timestamp,
            "txs": self.transactions, "root": self.state_root,
            "delta": self.delta_embedding,
        }, sort_keys=True).encode("utf-8")

    @property
    def hash(self) -> str:
        return hashlib.sha256(self.header_bytes()).hexdigest()

    def sign(self, key: bytes) -> None:
        self.signature = hmac.new(key, self.header_bytes(),
                                  hashlib.sha256).hexdigest()

    def verify_signature(self, key: bytes) -> bool:
        want = hmac.new(key, self.header_bytes(),
                        hashlib.sha256).hexdigest()
        return hmac.compare_digest(want, self.signature)

    def to_dict(self) -> dict:
        return {"height": self.height, "prev_hash": self.prev_hash,
                "timestamp": self.timestamp,
                "transactions": self.transactions,
                "state_root": self.state_root,
                "delta_embedding": self.delta_embedding,
                "codebook_code": self.codebook_code,
                "signature": self.signature, "hash": self.hash}


class Chain:
    """Append-only block list linked by hash."""

    GENESIS_HASH = "0" * 64

    def __init__(self, signing_key: bytes = b"neumann"):
        self._blocks: List[Block] = []
        self._key = signing_key

    @property
    def height(self) -> int:
        return len(self._blocks)

    def tip(self) -> Optional[Block]:
        return self._blocks[-1] if self._blocks else None

    def get_block(self, height: int) -> Optional[Block]:
        if 0 <= height < len(self._blocks):
            return self._blocks[height]
        return None

    def new_block(self, transactions: List[dict], state_root: str,
                  delta_embedding: Optional[np.ndarray] = None,
                  timestamp: Optional[float] = None) -> Block:
        prev = self._blocks[-1].hash if self._blocks else self.GENESIS_HASH
        blk = Block(
            height=len(self._blocks), prev_hash=prev,
            timestamp=timestamp if timestamp is not None else time.time(),
            transactions=transactions, state_root=state_root,
            delta_embedding=(np.asarray(delta_embedding, np.float32)
                             .tolist() if delta_embedding is not None
                             else None))
        blk.sign(self._key)
        return blk

    def append(self, block: Block,
               state_embedding=None,
               similarity_threshold: float = 0.95,
               enable_fast_path: bool = False) -> bool:
        """Append after validation. With `enable_fast_path`, a block whose
        delta embedding has cosine similarity >= `similarity_threshold`
        with `state_embedding` skips the expensive signature check — the
        reference's similarity fast-path (tensor_chain/src/raft.rs:77-89:
        high similarity means semantically consistent, non-conflicting
        changes). Hash-link and height checks always run. Returns True
        when the fast path was taken."""
        prev = self._blocks[-1].hash if self._blocks else self.GENESIS_HASH
        if block.prev_hash != prev:
            raise ChainError(
                f"block {block.height} prev_hash mismatch")
        if block.height != len(self._blocks):
            raise ChainError(f"block height {block.height} out of order")
        fast = False
        if enable_fast_path and state_embedding is not None and \
                block.delta_embedding is not None:
            a = np.asarray(block.delta_embedding, np.float32)
            b = np.asarray(state_embedding, np.float32)
            na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
            if na > 0 and nb > 0 and \
                    float(a @ b) / (na * nb) >= similarity_threshold:
                fast = True
        if not fast and not block.verify_signature(self._key):
            raise ChainError(f"block {block.height} bad signature")
        self._blocks.append(block)
        return fast

    def verify(self) -> bool:
        prev = self.GENESIS_HASH
        for i, blk in enumerate(self._blocks):
            if blk.prev_hash != prev or blk.height != i or \
                    not blk.verify_signature(self._key):
                return False
            prev = blk.hash
        return True

    def truncate(self, height: int) -> int:
        """Roll the chain back to `height` blocks; returns #removed."""
        removed = len(self._blocks) - height
        if removed < 0:
            raise ChainError("cannot truncate forward")
        self._blocks = self._blocks[:height]
        return removed

    def history(self, key: str) -> List[dict]:
        """All transactions across blocks touching `key`."""
        out = []
        for blk in self._blocks:
            for tx in blk.transactions:
                for op in tx.get("ops", []):
                    if op.get("key") == key:
                        out.append({"height": blk.height, "tx": tx["id"],
                                    "op": op})
        return out

    def blocks(self) -> List[Block]:
        return list(self._blocks)

"""Geometric membership + transport routing by embedding similarity.

Parity with tensor_chain/src/geometric_membership.rs and the
GeometricTransport trait (network.rs:950-960): each node has an identity
embedding (chain.signing.derive_embedding); peers are ranked by cosine
similarity, `send_to_nearest` routes to the semantically closest live
peer, and `regional_broadcast` fans out only to the top-m neighborhood —
bandwidth-aware gossip for geometry-partitioned corpora.

The port's copy of ``neumann_tpu/chain/geometric.py``:
only its import lines differ.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class GeometricMembership:
    def __init__(self, self_id: str, self_embedding: np.ndarray):
        self.id = self_id
        self.embedding = np.asarray(self_embedding, np.float32)
        self._peers: Dict[str, np.ndarray] = {}

    def upsert_peer(self, peer_id: str, embedding) -> None:
        self._peers[peer_id] = np.asarray(embedding, np.float32)

    def remove_peer(self, peer_id: str) -> None:
        self._peers.pop(peer_id, None)

    def rank_peers(self, query: Optional[np.ndarray] = None
                   ) -> List[str]:
        """Peers sorted by cosine similarity to `query` (default: us)."""
        q = np.asarray(query, np.float32) if query is not None \
            else self.embedding
        qn = q / max(float(np.linalg.norm(q)), 1e-30)

        def sim(peer):
            v = self._peers[peer]
            n = max(float(np.linalg.norm(v)), 1e-30)
            return float(v @ qn) / n

        return sorted(self._peers, key=sim, reverse=True)

    def nearest(self, query: Optional[np.ndarray] = None
                ) -> Optional[str]:
        ranked = self.rank_peers(query)
        return ranked[0] if ranked else None


class GeometricTransport:
    """Routing wrapper over any transport with send/broadcast."""

    def __init__(self, transport, membership: GeometricMembership):
        self.transport = transport
        self.membership = membership

    def send_to_nearest(self, kind: str, payload: dict,
                        query: Optional[np.ndarray] = None) -> bool:
        peer = self.membership.nearest(query)
        if peer is None:
            return False
        return self.transport.send(peer, kind, payload)

    def regional_broadcast(self, kind: str, payload: dict,
                           top_m: int = 3,
                           query: Optional[np.ndarray] = None) -> int:
        n = 0
        for peer in self.membership.rank_peers(query)[:top_m]:
            if self.transport.send(peer, kind, payload):
                n += 1
        return n

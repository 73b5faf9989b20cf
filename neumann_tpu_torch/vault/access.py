"""Graph-based access control: topological path verification.

Parity with tensor_vault/src/access.rs: entities are graph nodes keyed
by ``entity_key``; ``MEMBER`` edges express group membership and permit
traversal but grant NOTHING; ``VAULT_ACCESS_{READ,WRITE,ADMIN}`` edges
grant permissions on their target only. ``get_permission_level`` BFS-es
outgoing allowed edges, taking the max permission over all access edges
that land on the target — membership chains can never escalate. The
``_verified`` variants add HMAC edge signatures (tampered edges are
skipped, unsigned legacy edges accepted), distance-based attenuation
(vault/attenuation.py), and per-edge capacity bottlenecks.

The port's copy of ``neumann_tpu/vault/access.py``:
only its import lines differ.
"""
from __future__ import annotations

import hashlib
import hmac
from collections import deque
from typing import List, Optional

from neumann_tpu_torch.engines.graph import GraphEngine
from neumann_tpu_torch.vault.attenuation import AttenuationPolicy
from neumann_tpu_torch.vault.vault import Permission

VAULT_ACCESS_PREFIX = "VAULT_ACCESS"
# Edge types the BFS may traverse or consume (access.rs:160-175).
ALLOWED_EDGE_TYPES = (VAULT_ACCESS_PREFIX, "MEMBER")
# Hard traversal bound: long MEMBER chains cannot DoS the check.
MAX_BFS_DEPTH = 32

_EDGE_LEVELS = {
    f"{VAULT_ACCESS_PREFIX}_READ": Permission.READ,
    f"{VAULT_ACCESS_PREFIX}_WRITE": Permission.WRITE,
    f"{VAULT_ACCESS_PREFIX}_ADMIN": Permission.ADMIN,
}


def permission_from_edge_type(edge_type: str) -> Optional[Permission]:
    return _EDGE_LEVELS.get(edge_type)


def edge_type_for(perm: Permission) -> str:
    return f"{VAULT_ACCESS_PREFIX}_{perm.name}"


def _is_allowed(edge_type: str) -> bool:
    return any(edge_type.startswith(t) for t in ALLOWED_EDGE_TYPES)


class EdgeSigner:
    """HMAC-SHA256 signatures over (source, target, type, timestamp)
    — the vault's signing.rs EdgeSigner. A tampered or re-pointed edge
    fails verification and is skipped by the verified checks."""

    def __init__(self, key: bytes):
        self._key = key

    def _mac(self, source: str, target: str, edge_type: str,
             timestamp: int) -> str:
        msg = f"{source}\x00{target}\x00{edge_type}\x00{timestamp}"
        return hmac.new(self._key, msg.encode(), hashlib.sha256).hexdigest()

    def sign_edge(self, source: str, target: str, edge_type: str,
                  timestamp: int) -> str:
        return self._mac(source, target, edge_type, timestamp)

    def verify_edge(self, source: str, target: str, edge_type: str,
                    timestamp: int, signature: str) -> bool:
        return hmac.compare_digest(
            self._mac(source, target, edge_type, timestamp), signature)


class AccessController:
    """String-keyed access topology over a GraphEngine (access.rs)."""

    ENTITY_LABEL = "AccessEntity"

    def __init__(self, graph: Optional[GraphEngine] = None):
        self.graph = graph if graph is not None else GraphEngine()
        try:
            self.graph.create_property_index("entity_key")
        except Exception:
            pass  # idempotent: index may already exist

    # -- entity/edge helpers -----------------------------------------------------

    def find_entity_node(self, entity_key: str) -> Optional[int]:
        hits = self.graph.find_nodes_by_property("entity_key", entity_key)
        return hits[0] if hits else None

    def get_or_create_entity_node(self, entity_key: str) -> int:
        nid = self.find_entity_node(entity_key)
        if nid is not None:
            return nid
        return self.graph.create_node(self.ENTITY_LABEL,
                                      {"entity_key": entity_key})

    def entity_key_of(self, nid: int) -> Optional[str]:
        node = self.graph.get_node(nid)
        return node["properties"].get("entity_key") if node else None

    def add_member_edge(self, member: str, group: str) -> int:
        """``member`` belongs to ``group`` (traversal only, no grant)."""
        return self.graph.create_edge(
            self.get_or_create_entity_node(member),
            self.get_or_create_entity_node(group), "MEMBER")

    def add_access_edge(self, source: str, target: str, perm: Permission,
                        signer: Optional[EdgeSigner] = None,
                        timestamp: int = 0,
                        capacity: Optional[Permission] = None) -> int:
        """Grant ``perm`` on ``target`` to ``source`` (or to a group).
        With a signer, the edge carries an HMAC the verified checks
        enforce; ``capacity`` bottlenecks what can flow through it."""
        etype = edge_type_for(perm)
        props = {}
        if signer is not None:
            props["signature"] = signer.sign_edge(source, target, etype,
                                                  timestamp)
            props["sig_timestamp"] = timestamp
        if capacity is not None:
            props["capacity"] = int(capacity)
        return self.graph.create_edge(
            self.get_or_create_entity_node(source),
            self.get_or_create_entity_node(target), etype, props)

    def _out_edges(self, entity_key: str):
        nid = self.find_entity_node(entity_key)
        if nid is None:
            return
        for e in self.graph.out_edges(nid):
            if e is None or e["src"] != nid:
                continue  # undirected incident edges don't leave nid
            to_key = self.entity_key_of(e["dst"])
            if to_key is not None:
                yield e, to_key

    # -- checks (access.rs:184-420) ------------------------------------------------

    def check_path(self, source: str, target: str) -> bool:
        """BFS over allowed outgoing edges; True if target reachable."""
        if source == target:
            return True
        visited = {source}
        queue = deque([(source, 0)])
        while queue:
            current, depth = queue.popleft()
            if depth >= MAX_BFS_DEPTH:
                continue
            for edge, to_key in self._out_edges(current):
                if not _is_allowed(edge["type"]):
                    continue
                if to_key == target:
                    return True
                if to_key not in visited:
                    visited.add(to_key)
                    queue.append((to_key, depth + 1))
        return False

    def get_direct_accessors(self, target: str) -> List[str]:
        nid = self.find_entity_node(target)
        if nid is None:
            return []
        out = []
        for e in self.graph.in_edges(nid):
            if e and e["dst"] == nid and \
                    e["type"].startswith(VAULT_ACCESS_PREFIX):
                key = self.entity_key_of(e["src"])
                if key is not None:
                    out.append(key)
        return out

    def get_permission_level(self, source: str, target: str
                             ) -> Optional[Permission]:
        """Highest permission from any access edge landing on target.
        SECURITY: MEMBER edges traverse but never grant — membership
        cannot escalate privileges (access.rs:244-300)."""
        return self._bfs_permission(source, target, signer=None,
                                    policy=None)

    def get_permission_level_verified(self, source: str, target: str,
                                      signer: EdgeSigner,
                                      policy: AttenuationPolicy
                                      ) -> Optional[Permission]:
        """Like get_permission_level, plus: HMAC-verified edges
        (tampered ones skipped, unsigned legacy accepted), permissions
        attenuated by hop distance, per-edge capacity bottleneck, BFS
        bounded by the policy horizon."""
        return self._bfs_permission(source, target, signer=signer,
                                    policy=policy)

    def _bfs_permission(self, source: str, target: str,
                        signer: Optional[EdgeSigner],
                        policy: Optional[AttenuationPolicy]
                        ) -> Optional[Permission]:
        if source == target:
            return Permission.ADMIN
        horizon = policy.horizon if policy is not None else MAX_BFS_DEPTH
        best: Optional[Permission] = None
        visited = {source}
        queue = deque([(source, 0)])
        while queue:
            current, depth = queue.popleft()
            if depth >= horizon:
                continue
            for edge, to_key in self._out_edges(current):
                etype = edge["type"]
                if not _is_allowed(etype):
                    continue
                if etype.startswith(VAULT_ACCESS_PREFIX):
                    if to_key != target:
                        # access edges point at secrets; never traverse
                        continue
                    props = edge.get("properties", {})
                    sig = props.get("signature")
                    if signer is not None and sig is not None:
                        if not signer.verify_edge(
                                current, to_key, etype,
                                props.get("sig_timestamp", 0), sig):
                            continue  # tampered edge
                    perm = permission_from_edge_type(etype)
                    if perm is None:
                        continue
                    if policy is not None:
                        # the access hop itself counts as +1
                        perm = policy.attenuate(perm, depth + 1)
                        if perm is None:
                            continue
                        cap = props.get("capacity")
                        if cap is not None:
                            perm = min(perm, Permission(cap))
                    best = perm if best is None else max(best, perm)
                elif to_key not in visited:
                    visited.add(to_key)
                    queue.append((to_key, depth + 1))
        return best

    def check_path_with_permission(self, source: str, target: str,
                                   required: Permission) -> bool:
        perm = self.get_permission_level(source, target)
        return perm is not None and perm >= required

    def check_path_with_permission_verified(
            self, source: str, target: str, required: Permission,
            signer: EdgeSigner, policy: AttenuationPolicy) -> bool:
        perm = self.get_permission_level_verified(source, target, signer,
                                                  policy)
        return perm is not None and perm >= required

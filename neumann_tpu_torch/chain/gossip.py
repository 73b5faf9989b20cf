"""SWIM-style gossip membership with incarnation numbers.

Parity with tensor_chain/src/gossip.rs capability: periodic ping/ack
probing with indirect ping-req fallback, alive/suspect/faulty states,
incarnation-number refutation, and LWW membership dissemination
piggybacked on every message. Sans-IO: tick()/handle() like RaftNode.

The port's copy of ``neumann_tpu/chain/gossip.py``:
only its import lines differ.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from neumann_tpu_torch.chain.transport import Message


def _stable_seed(seed: int, node_id: str) -> int:
    """Process-independent seed (str.__hash__ is randomized per run)."""
    import hashlib

    h = hashlib.blake2b(f"{seed}:{node_id}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little")

ALIVE = "alive"
SUSPECT = "suspect"
FAULTY = "faulty"

_RANK = {ALIVE: 0, SUSPECT: 1, FAULTY: 2}


@dataclass
class MemberState:
    status: str = ALIVE
    incarnation: int = 0
    version: int = 0     # LWW tiebreaker


@dataclass
class GossipConfig:
    probe_interval: int = 3       # ticks between probes
    ack_timeout: int = 2          # ticks to wait for ack
    suspect_timeout: int = 6      # ticks from suspect -> faulty
    indirect_probes: int = 2


class GossipNode:
    def __init__(self, node_id: str, peers: List[str],
                 config: Optional[GossipConfig] = None, seed: int = 0):
        self.id = node_id
        self.config = config or GossipConfig()
        self._rng = random.Random(_stable_seed(seed, node_id))
        self.members: Dict[str, MemberState] = {
            p: MemberState() for p in peers if p != node_id}
        self.members[node_id] = MemberState()
        self.incarnation = 0
        self._tick = 0
        self._awaiting_ack: Dict[str, int] = {}   # peer -> deadline
        self._suspect_since: Dict[str, int] = {}
        self._version = 0
        # health-transition hook (membership.rs MembershipCallback):
        # called as (peer, old_status, new_status) on every change,
        # whether detected locally or learned through gossip
        self.on_status_change: Optional[
            Callable[[str, str, str], None]] = None

    def _notify(self, peer: str, old: str, new: str) -> None:
        if self.on_status_change is not None and old != new:
            self.on_status_change(peer, old, new)

    # ------------------------------------------------------------------
    def _membership_payload(self) -> dict:
        return {p: {"status": m.status, "inc": m.incarnation,
                    "v": m.version}
                for p, m in self.members.items()}

    def _merge_membership(self, remote: dict) -> None:
        for peer, info in remote.items():
            cur = self.members.get(peer)
            if peer == self.id:
                # refute rumors about ourselves
                if info["status"] != ALIVE and \
                        info["inc"] >= self.incarnation:
                    self.incarnation = info["inc"] + 1
                    me = self.members[self.id]
                    me.status = ALIVE
                    me.incarnation = self.incarnation
                    self._version += 1
                    me.version = self._version
                continue
            if cur is None:
                self.members[peer] = MemberState(
                    info["status"], info["inc"], info["v"])
                continue
            # LWW by (incarnation, status rank, version)
            if (info["inc"], _RANK[info["status"]], info["v"]) > \
                    (cur.incarnation, _RANK[cur.status], cur.version):
                old = cur.status
                cur.status = info["status"]
                cur.incarnation = info["inc"]
                cur.version = info["v"]
                if info["status"] == SUSPECT:
                    self._suspect_since.setdefault(peer, self._tick)
                elif info["status"] == ALIVE:
                    self._suspect_since.pop(peer, None)
                self._notify(peer, old, info["status"])

    def _mark(self, peer: str, status: str) -> None:
        m = self.members.get(peer)
        if m is None or m.status == status:
            return
        old = m.status
        m.status = status
        self._version += 1
        m.version = self._version
        if status == SUSPECT:
            self._suspect_since[peer] = self._tick
        else:
            self._suspect_since.pop(peer, None)
        self._notify(peer, old, status)

    # ------------------------------------------------------------------
    def tick(self) -> List[Message]:
        self._tick += 1
        out: List[Message] = []
        # ack timeouts -> suspect + indirect probes
        for peer, deadline in list(self._awaiting_ack.items()):
            if self._tick >= deadline:
                del self._awaiting_ack[peer]
                self._mark(peer, SUSPECT)
                others = [p for p in self.members
                          if p not in (self.id, peer)
                          and self.members[p].status == ALIVE]
                for helper in self._rng.sample(
                        others, min(self.config.indirect_probes,
                                    len(others))):
                    out.append(Message("ping_req", self.id, helper,
                                       {"target": peer,
                                        "members":
                                        self._membership_payload()}))
        # suspects -> faulty
        for peer, since in list(self._suspect_since.items()):
            if self._tick - since >= self.config.suspect_timeout:
                self._mark(peer, FAULTY)
        # periodic probe of a random live-ish peer
        if self._tick % self.config.probe_interval == 0:
            candidates = [p for p in self.members
                          if p != self.id
                          and self.members[p].status != FAULTY]
            if candidates:
                target = self._rng.choice(candidates)
                self._awaiting_ack[target] = \
                    self._tick + self.config.ack_timeout
                out.append(Message("ping", self.id, target,
                                   {"members":
                                    self._membership_payload()}))
        # slow resurrection probe of a FAULTY peer: partitions heal, and
        # without this no one would ever ping a faulty member again (a
        # healed side only learns of the heal when probed)
        if self._tick % (self.config.probe_interval * 3) == 0:
            faulty = [p for p in self.members
                      if p != self.id
                      and self.members[p].status == FAULTY]
            if faulty:
                target = self._rng.choice(faulty)
                out.append(Message("ping", self.id, target,
                                   {"members":
                                    self._membership_payload()}))
        return out

    def handle(self, msg: Message) -> List[Message]:
        self._merge_membership(msg.payload.get("members", {}))
        if msg.kind == "ping":
            # snapshot membership BEFORE marking the pinger alive: if we
            # believed it faulty, the ack must carry that rumor so the
            # pinger can refute with an incarnation bump (without this,
            # rank-based gossip re-infects FAULTY forever)
            view = self._membership_payload()
            self._mark(msg.src, ALIVE)
            ack = {"members": view}
            if msg.payload.get("on_behalf") is not None:
                ack["on_behalf"] = msg.payload["on_behalf"]
            return [Message("ack", self.id, msg.src, ack)]
        if msg.kind == "ack":
            self._awaiting_ack.pop(msg.src, None)
            self._mark(msg.src, ALIVE)
            # SWIM indirect-probe completion: we pinged on behalf of the
            # original prober, so relay the ack back to it — suspicion
            # clears via the ack path, not just slow dissemination
            behalf = msg.payload.get("on_behalf")
            if behalf is not None and behalf != self.id:
                return [Message("ack_relay", self.id, behalf,
                                {"target": msg.src,
                                 "members": self._membership_payload()})]
            return []
        if msg.kind == "ack_relay":
            target = msg.payload.get("target")
            if target is not None:
                self._awaiting_ack.pop(target, None)
                self._mark(target, ALIVE)
            return []
        if msg.kind == "ping_req":
            target = msg.payload["target"]
            return [Message("ping", self.id, target,
                            {"members": self._membership_payload(),
                             "on_behalf": msg.src})]
        return []

    # ------------------------------------------------------------------
    def partition_status(self, grace_ticks: int = 10) -> str:
        """Quorum classification from this node's local membership view
        (membership.rs:504 PartitionStatus parity): returns
        ``quorum_reachable`` / ``quorum_lost`` / ``stalemate`` (exact
        50/50 split of an even cluster) / ``unknown`` (startup grace)."""
        if self._tick < grace_ticks:
            return "unknown"
        total = len(self.members)
        healthy = sum(1 for m in self.members.values()
                      if m.status == ALIVE)
        if healthy >= total // 2 + 1:
            return "quorum_reachable"
        if healthy * 2 == total:
            return "stalemate"
        return "quorum_lost"

    def alive_peers(self) -> List[str]:
        return sorted(p for p, m in self.members.items()
                      if m.status == ALIVE and p != self.id)

    def status_of(self, peer: str) -> Optional[str]:
        m = self.members.get(peer)
        return m.status if m else None

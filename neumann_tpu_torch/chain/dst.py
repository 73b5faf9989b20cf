"""Deterministic simulation testing (DST) harness for the consensus cores.

Parity with the reference's DSTHarness (integration_tests/src/dst.rs):
drives real RaftNodes tick-by-tick through the in-process TransportHub
with a seeded scheduler and a fault schedule (partitions, heals, crashes,
restarts, message drops), checking election safety and log-prefix
consistency invariants every step. Same seed => same execution.

The port's copy of ``neumann_tpu/chain/dst.py``:
only its import lines differ.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from neumann_tpu_torch.chain.raft import LEADER, RaftConfig, RaftNode
from neumann_tpu_torch.chain.transport import Message, TransportHub


@dataclass
class FaultAction:
    """One scheduled fault. kind: partition | heal | crash | restart |
    drop_rate | reorder_rate | joint_remove."""

    at_tick: int
    kind: str
    groups: Optional[List[Set[str]]] = None
    node: Optional[str] = None
    rate: float = 0.0


@dataclass
class DSTResult:
    ticks: int
    leaders_per_term: Dict[int, Set[str]]
    committed: Dict[str, List[tuple]]
    violations: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


class DSTHarness:
    def __init__(self, n_nodes: int = 3, seed: int = 0,
                 config: Optional[RaftConfig] = None):
        self.seed = seed
        self.rng = random.Random(seed)
        self.hub = TransportHub(seed=seed)
        self.ids = [f"n{i}" for i in range(n_nodes)]
        cfg = config or RaftConfig()
        self.nodes: Dict[str, RaftNode] = {
            nid: RaftNode(nid, self.ids, cfg, seed=seed + i)
            for i, nid in enumerate(self.ids)}
        self.transports = {nid: self.hub.register(nid)
                           for nid in self.ids}
        self.crashed: Set[str] = set()
        self.leaders_per_term: Dict[int, Set[str]] = {}
        self.committed: Dict[str, List[tuple]] = {n: [] for n in self.ids}
        self.violations: List[str] = []
        self._tick = 0

    # ------------------------------------------------------------------
    def _route(self, msgs: List[Message]) -> None:
        for m in msgs:
            self.hub.deliver(m)

    def _apply_fault(self, f: FaultAction) -> None:
        if f.kind == "partition":
            self.hub.partition(*f.groups)
        elif f.kind == "heal":
            self.hub.heal()
        elif f.kind == "crash":
            self.crashed.add(f.node)
        elif f.kind == "restart":
            self.crashed.discard(f.node)
            # volatile state resets; persistent (term/vote/log) survives,
            # mirroring a process restart with an intact WAL
            node = self.nodes[f.node]
            node.state = "follower"
            node.leader_id = None
            node._elapsed = 0
            self.transports[f.node].drain()
        elif f.kind == "drop_rate":
            self.hub.drop_probability = f.rate
        elif f.kind == "reorder_rate":
            # messages sampled at `rate` are delayed + reordered
            # through the hub's bounded shuffle buffer
            self.hub.reorder_probability = f.rate
        elif f.kind == "joint_remove":
            # membership change mid-chaos: the current leader (if any)
            # removes `node` via joint consensus
            leader = self.current_leader()
            if leader is not None:
                self.nodes[leader].propose_joint_change(
                    remove=[f.node])

    def _check_invariants(self) -> None:
        # election safety: at most one leader per term
        for nid, node in self.nodes.items():
            if nid in self.crashed:
                continue
            if node.state == LEADER:
                self.leaders_per_term.setdefault(node.term, set()).add(nid)
        for term, leaders in self.leaders_per_term.items():
            if len(leaders) > 1:
                self.violations.append(
                    f"election safety violated in term {term}: {leaders}")
        # log consistency: committed sequences are prefixes of each other
        seqs = [tuple(x for x in self.committed[n]) for n in self.ids]
        longest = max(seqs, key=len)
        for nid, seq in zip(self.ids, seqs):
            if tuple(longest[: len(seq)]) != tuple(seq):
                self.violations.append(
                    f"log consistency violated at {nid}")

    # ------------------------------------------------------------------
    def run(self, ticks: int = 300,
            faults: Optional[List[FaultAction]] = None,
            propose_every: int = 10) -> DSTResult:
        faults = sorted(faults or [], key=lambda f: f.at_tick)
        fi = 0
        proposed = 0
        for t in range(ticks):
            self._tick = t
            while fi < len(faults) and faults[fi].at_tick == t:
                self._apply_fault(faults[fi])
                fi += 1
            # occasionally propose through the current leader
            if propose_every and t % propose_every == 0:
                for nid, node in self.nodes.items():
                    if nid not in self.crashed and node.state == LEADER:
                        if node.propose({"v": proposed}) is not None:
                            proposed += 1
                        break
            # tick every live node, route its messages
            for nid in self.ids:
                if nid in self.crashed:
                    continue
                self._route(self.nodes[nid].tick())
            # deliver all queued messages (random order, seeded)
            order = list(self.ids)
            self.rng.shuffle(order)
            for nid in order:
                if nid in self.crashed:
                    self.transports[nid].drain()
                    continue
                for msg in self.transports[nid].drain():
                    self._route(self.nodes[nid].handle(msg))
            # collect newly committed entries
            for nid in self.ids:
                if nid in self.crashed:
                    continue
                for idx, payload in self.nodes[nid].take_committed():
                    if "noop" not in payload:
                        self.committed[nid].append(
                            (idx, tuple(sorted(payload.items()))))
            self._check_invariants()
            if self.violations:
                break
        return DSTResult(self._tick + 1, self.leaders_per_term,
                         self.committed, self.violations)

    def current_leader(self) -> Optional[str]:
        for nid, node in self.nodes.items():
            if nid not in self.crashed and node.state == LEADER:
                return nid
        return None

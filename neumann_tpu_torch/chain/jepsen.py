"""Jepsen-style chaos harness over the in-process cluster.

Parity with the reference's RealJepsenHarness / ChaosRaftCluster
(integration_tests/src/jepsen.rs): real Raft nodes, concurrent client
workloads against the leader, a nemesis schedule (partitions / heals /
crashes), a recorded invoke/complete history, and a linearizability
check at the end. Deterministic: driven on the simulated tick clock
with a seeded RNG, like the DST harness.

The port's copy of ``neumann_tpu/chain/jepsen.py``:
only its import lines differ.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional

from neumann_tpu_torch.chain.cluster import ClusterOrchestrator
from neumann_tpu_torch.chain.dst import FaultAction
from neumann_tpu_torch.chain.linearizability import CheckResult, Op, \
    check_kv
from neumann_tpu_torch.store.tensor_store import TensorData

_KEY = "jepsen:register"


@dataclass
class JepsenResult:
    history: List[Op]
    check: CheckResult
    writes_attempted: int
    writes_acked: int

    @property
    def ok(self) -> bool:
        return self.check.ok


class JepsenHarness:
    """Register read/write[/CAS] workload with a nemesis; ``n_keys``
    spreads the workload over several independent registers checked
    compositionally (check_kv — the reference checker's KV model)."""

    def __init__(self, n_nodes: int = 3, seed: int = 0,
                 n_keys: int = 1):
        self.orch = ClusterOrchestrator(n_nodes, seed=seed)
        self.rng = random.Random(seed)
        self.keys = [_KEY] if n_keys <= 1 else [
            f"{_KEY}{i}" for i in range(n_keys)]
        self.history: List[Op] = []
        self._pending: List[dict] = []   # writes awaiting commit
        self._tick = 0
        self.writes_attempted = 0
        self.writes_acked = 0

    def _leader(self):
        lid = self.orch.leader()
        return self.orch.nodes[lid] if lid else None

    def _applied_value(self, node, key=_KEY) -> Optional[int]:
        data = node.store.get(key)
        if data is None:
            return None
        return data.get("v").value

    def run(self, ticks: int = 400,
            nemesis: Optional[List[FaultAction]] = None,
            write_every: int = 7, read_every: int = 5,
            cas_every: Optional[int] = None) -> JepsenResult:
        nemesis = sorted(nemesis or [], key=lambda f: f.at_tick)
        ni = 0
        next_val = 0
        pending_cas: List[dict] = []
        self.orch.run_until_leader()
        for t in range(ticks):
            self._tick = t
            while ni < len(nemesis) and nemesis[ni].at_tick == t:
                f = nemesis[ni]
                if f.kind == "partition":
                    self.orch.hub.partition(*f.groups)
                elif f.kind == "heal":
                    self.orch.hub.heal()
                elif f.kind == "drop_rate":
                    self.orch.hub.drop_probability = f.rate
                elif f.kind == "reorder_rate":
                    self.orch.hub.reorder_probability = f.rate
                elif f.kind == "block_link" and f.groups:
                    # one-way partial partition: groups = [{src}, {dst}]
                    (src,), (dst,) = (set(g) for g in f.groups)
                    self.orch.hub.block_link(src, dst)
                ni += 1
            leader = self._leader()
            # writes: propose through the leader; completion = committed
            if leader is not None and t % write_every == 0:
                key = self.rng.choice(self.keys)
                next_val += 1
                self.writes_attempted += 1
                idx = leader.raft.propose(
                    {"op": "put", "key": key,
                     "data": __import__(
                         "neumann_tpu_torch.store.codec",
                         fromlist=["codec"]).encode_data(
                             TensorData.with_values(v=next_val)).hex()})
                if idx is not None:
                    self._pending.append({"value": next_val,
                                          "invoke": t, "index": idx,
                                          "term": leader.raft.term,
                                          "node": leader, "key": key})
            # compare-and-swap: expected = the leader's applied value;
            # the outcome resolves in the state machine at apply time
            if cas_every and leader is not None and \
                    t % cas_every == 0:
                key = self.rng.choice(self.keys)
                next_val += 1
                rid = leader.propose_cas(
                    key, "v", self._applied_value(leader, key),
                    TensorData.with_values(v=next_val))
                if rid is not None:
                    pending_cas.append({
                        "rid": rid, "node": leader, "invoke": t,
                        "expected": self._applied_value(leader, key),
                        "new": next_val, "key": key})
            # reads: leader-local applied state (read-your-raft)
            if leader is not None and t % read_every == 0:
                key = self.rng.choice(self.keys)
                val = self._applied_value(leader, key)
                self.history.append(Op("reader", "read", val,
                                       invoke=t, complete=t + 0.5,
                                       key=key))
            self.orch.step()
            # complete writes whose index has been applied on the leader
            still = []
            for wr in self._pending:
                node = wr["node"]
                applied = node.raft.last_applied >= wr["index"]
                entry_term = node.raft.term_at(wr["index"])
                if applied and entry_term == wr["term"]:
                    self.history.append(Op(
                        "writer", "write", wr["value"],
                        invoke=wr["invoke"], complete=t + 1,
                        key=wr.get("key", _KEY)))
                    self.writes_acked += 1
                elif applied and entry_term is not None and \
                        entry_term != wr["term"]:
                    pass  # overwritten by a new leader: write never
                    #       took effect, drop it from the history
                else:
                    still.append(wr)
            self._pending = still
            still_cas = []
            for c in pending_cas:
                ok = c["node"].cas_result(c["rid"])
                if ok is None:
                    still_cas.append(c)
                else:
                    self.history.append(Op(
                        "caser", "cas",
                        (c["expected"], c["new"], ok),
                        invoke=c["invoke"], complete=t + 1,
                        key=c.get("key", _KEY)))
            pending_cas = still_cas
        # still-pending writes are indeterminate: they may take effect
        # at any point after their invocation
        for wr in self._pending:
            self.history.append(Op("writer", "write", wr["value"],
                                   invoke=wr["invoke"],
                                   complete=float("inf"),
                                   key=wr.get("key", _KEY)))
        # a CAS still unresolved at run end MAY have applied: model it
        # as an indeterminate write of its new value (weaker than the
        # full cas op — the expected-check can't be asserted without
        # knowing the reported outcome — but sound: a read observing
        # `new` stays explainable)
        for c in pending_cas:
            self.history.append(Op("caser", "write", c["new"],
                                   invoke=c["invoke"],
                                   complete=float("inf"),
                                   key=c.get("key", _KEY)))
        check = check_kv(self.history)
        return JepsenResult(self.history, check,
                            self.writes_attempted, self.writes_acked)

"""Cluster orchestration: store + transport + Raft + chain + state machine.

Parity with tensor_chain/src/cluster.rs capability: each ClusterNode owns
a RaftNode, applies committed entries to its TensorStore (the state
machine, state_machine.rs), routes client writes to the leader, and
serves queries via a pluggable executor (the router's
execute_for_cluster role). The pump can be driven manually (tests/DST)
or by a background thread over any transport (MemoryTransport in-process,
TcpTransport across processes).

The port's copy of ``neumann_tpu/chain/cluster.py``:
only its import lines differ, and a node (and the orchestrator, for its
nodes) takes the ``device`` its delta replication's k-means runs on.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from neumann_tpu_torch.chain.integration import ClusterProtocolMixin
from neumann_tpu_torch.chain.raft import LEADER, RaftConfig, RaftNode
from neumann_tpu_torch.chain.transport import Message, TransportHub
from neumann_tpu_torch.store import codec
from neumann_tpu_torch.store.tensor_store import TensorData, TensorStore
from neumann_tpu_torch.utils.errors import ChainError


class ClusterNode(ClusterProtocolMixin):
    def __init__(self, node_id: str, peer_ids: List[str],
                 hub: TransportHub,
                 store: Optional[TensorStore] = None,
                 config: Optional[RaftConfig] = None, seed: int = 0,
                 query_executor: Optional[Callable[[str], object]] = None,
                 gossip: bool = True, gossip_config=None,
                 auto_remove_faulty: bool = False,
                 faulty_grace_ticks: int = 10, wal=None, device="cuda"):
        self.id = node_id
        self.device = device
        self.store = store if store is not None else TensorStore()
        self.raft = RaftNode(node_id, peer_ids, config, seed=seed,
                             wal=wal)
        self.transport = hub.register(node_id)
        self.query_executor = query_executor
        self._applied_index = 0
        self._lock = threading.RLock()
        self._pending_queries: Dict[str, object] = {}
        self._init_protocol(peer_ids, seed=seed, gossip=gossip,
                            gossip_config=gossip_config,
                            auto_remove_faulty=auto_remove_faulty,
                            faulty_grace_ticks=faulty_grace_ticks)

    def _send(self, dst: str, kind: str, payload: dict) -> None:
        self.transport.send(dst, kind, payload)

    def _deliver_raft(self, msg: Message) -> None:
        with self._lock:
            outbound = self.raft.handle(msg)
        for m in outbound:
            self._send_msg(m)

    # -- client API --------------------------------------------------------
    def propose_put(self, key: str, data: TensorData) -> bool:
        """Propose a replicated put; returns False if not leader.
        Rides the wire (and the WAL) delta-coded once a registry is
        replicated (enable_delta_replication)."""
        payload = self._encode_put(key, data)
        with self._lock:
            return self.raft.propose(payload) is not None

    def propose_delete(self, key: str) -> bool:
        with self._lock:
            return self.raft.propose(
                {"op": "delete", "key": key}) is not None

    def propose_cas(self, key: str, field: str, expected,
                    data: TensorData) -> Optional[str]:
        """Conditional replicated write (compare-and-swap): ``data``
        replaces ``key`` iff ``field``'s current scalar value equals
        ``expected`` AT APPLY TIME — the comparison runs inside the
        state machine on every replica, in log order, so all replicas
        resolve it identically. ``expected=None`` matches a missing
        key/field (create-if-absent). Returns a request id for
        ``cas_result``, or None when not leader."""
        rid = self._next_cas_rid()
        with self._lock:
            idx = self.raft.propose(
                {"op": "cas", "key": key, "field": field,
                 "expected": expected, "rid": rid,
                 "data": codec.encode_data(data).hex()})
            return rid if idx is not None else None

    def is_leader(self) -> bool:
        return self.raft.state == LEADER

    def leader_hint(self) -> Optional[str]:
        return self.raft.leader_id

    # -- query routing ------------------------------------------------------
    def send_query(self, query: str) -> None:
        """Forward a query to the leader for execution."""
        target = self.id if self.is_leader() else self.raft.leader_id
        if target is None:
            raise ChainError("no known leader")
        self.transport.send(target, "cluster_query",
                            {"query": query, "reply_to": self.id})

    def poll_query_result(self) -> Optional[object]:
        with self._lock:
            for qid in list(self._pending_queries):
                return self._pending_queries.pop(qid)
        return None

    # -- pump --------------------------------------------------------------
    def pump(self) -> None:
        """One step: tick raft + gossip, handle inbound, apply."""
        with self._lock:
            outbound = self.raft.tick()
        for m in outbound:
            self._send_msg(m)
        self._protocol_tick()
        while True:
            msg = self.transport.recv()
            if msg is None:
                break
            self._handle(msg)
        self._apply_committed()

    def _handle(self, msg: Message) -> None:
        if self._protocol_handle(msg):
            return
        if msg.kind == "cluster_query":
            if self.query_executor is not None:
                result = self.query_executor(msg.payload["query"])
            else:
                result = None
            self.transport.send(msg.payload["reply_to"],
                                "cluster_query_result",
                                {"result": result})
            return
        if msg.kind == "cluster_query_result":
            with self._lock:
                self._pending_queries[str(time.time())] = \
                    msg.payload.get("result")
            return
        self._deliver_raft(msg)

    def _apply_committed(self) -> None:
        with self._lock:
            # leader-installed snapshot jumped past entries we never
            # saw: reset the state machine from the snapshot data
            if self.raft.snapshot_index > self._applied_index:
                snap = self.raft.snapshot_data
                if snap and "store" in snap:
                    import base64

                    self.store.restore_from_bytes(
                        base64.b64decode(snap["store"]))
                self._applied_index = self.raft.snapshot_index
            entries = self.raft.take_committed()
        for idx, payload in entries:
            if self._apply_protocol_entry(payload):
                self._applied_index = idx
                continue
            op = payload.get("op")
            if op == "put":
                data = codec.decode_data(bytes.fromhex(payload["data"]))
                self.store.put(payload["key"], data)
            elif op == "delete":
                self.store.delete(payload["key"])
            self._applied_index = idx


class ClusterOrchestrator:
    """Boots a set of in-process cluster nodes and pumps them.

    start() spawns a pump thread (real deployments); step() pumps
    manually (tests). Mirrors ClusterOrchestrator::start/run
    (cluster.rs:275,662).
    """

    def __init__(self, n_nodes: int = 3, seed: int = 0,
                 config: Optional[RaftConfig] = None,
                 query_executor_factory=None, device="cuda"):
        self.hub = TransportHub(seed=seed)
        ids = [f"n{i}" for i in range(n_nodes)]
        self.nodes: Dict[str, ClusterNode] = {}
        for i, nid in enumerate(ids):
            executor = (query_executor_factory(nid)
                        if query_executor_factory else None)
            self.nodes[nid] = ClusterNode(
                nid, ids, self.hub, config=config, seed=seed + i,
                query_executor=executor, device=device)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def step(self, n: int = 1) -> None:
        for _ in range(n):
            for node in self.nodes.values():
                node.pump()

    def run_until_leader(self, max_steps: int = 500) -> Optional[str]:
        for _ in range(max_steps):
            self.step()
            leader = self.leader()
            if leader is not None:
                return leader
        return None

    def leader(self) -> Optional[str]:
        for nid, node in self.nodes.items():
            if node.is_leader():
                return nid
        return None

    def start(self, tick_interval_s: float = 0.02) -> None:
        def loop():
            while not self._stop.is_set():
                self.step()
                time.sleep(tick_interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

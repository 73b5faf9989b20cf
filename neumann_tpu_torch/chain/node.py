"""TcpClusterNode: a deployable multi-process replicated database node.

Parity with the reference's cluster deployment (cluster.rs boot path:
store -> TCP transport -> Raft -> state machine -> query executor), as a
standalone process:

- sans-IO RaftNode pumped by a background thread over TcpTransport
  (optionally compressed / TLS)
- committed entries apply to a TensorStore (durable when --wal-dir is
  given, so a restarted node replays its state machine)
- client writes route to the leader automatically (followers forward)
- a QueryRouter serves reads locally and leader-executes statements
  forwarded as ``cluster_query`` messages
- thin ClusterClient: any process can join the transport fabric and
  issue queries/puts without running Raft

CLI: ``python -m neumann_tpu_torch.chain.node --id n0 --port 7900 \
        --peers n1=127.0.0.1:7901,n2=127.0.0.1:7902 [--wal-dir DIR]
        [--device cuda]``

The port's copy of ``neumann_tpu/chain/node.py``: the node's embedded
router runs on ``device`` (``TcpClusterNode(device=...)``, ``--device``;
default "cuda"), and a compaction snapshot also carries the router's
collection configs (``"collections"``), which a node restored from it
creates before the rows come back: the reference's snapshot holds only
the store, so a restarted node served an ``int8`` (or ``binary``, ``pq``,
``tt``) collection as an f32 one. A snapshot without them (the JAX
package's) restores as there. Otherwise only its import lines differ.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from neumann_tpu_torch.chain.integration import ClusterProtocolMixin
from neumann_tpu_torch.chain.message_validation import validate as validate_message
from neumann_tpu_torch.chain.raft import LEADER, RaftConfig, RaftNode
from neumann_tpu_torch.chain.transport import Message, TcpTransport
from neumann_tpu_torch.store import codec
from neumann_tpu_torch.store.tensor_store import TensorData, TensorStore
from neumann_tpu_torch.utils.errors import ChainError

# statement kinds that mutate state and must replicate through the log;
# everything else executes locally on the serving node (reads scale out)
_REPLICATED_KINDS = frozenset((
    "CreateTable", "DropTable", "CreateIndex", "DropIndex", "Insert",
    "Update", "Delete", "NodeCreate", "NodeDelete", "EdgeCreate",
    "EdgeDelete", "EmbedStore", "EmbedDelete", "EmbedBatch",
    "EntityCreate", "EntityDelete", "EntityConnect", "CreateCollection",
    "DropCollection", "GraphBatch", "GraphConstraint", "GraphIndex",
    "Cypher",
))


def _is_replicated_statement(query: str) -> bool:
    from neumann_tpu_torch.lang.cypher import looks_like_cypher

    if looks_like_cypher(query):
        up = query.upper()
        return any(kw in up for kw in ("CREATE", "MERGE", "DELETE",
                                       "SET "))
    from neumann_tpu_torch.lang.parser import parse

    try:
        return type(parse(query)).__name__ in _REPLICATED_KINDS
    except Exception:
        return False


class TcpClusterNode(ClusterProtocolMixin):
    def __init__(self, node_id: str,
                 peers: Dict[str, Tuple[str, int]],
                 host: str = "127.0.0.1", port: int = 0,
                 wal_dir: Optional[str] = None,
                 config: Optional[RaftConfig] = None, seed: int = 0,
                 compress: bool = True,
                 tls_server=None, tls_client=None,
                 query_executor: Optional[Callable[[str], object]] = None,
                 gossip: bool = True,
                 auto_remove_faulty: bool = False,
                 faulty_grace_ticks: int = 40,
                 device="cuda"):
        self.id = node_id
        self.device = device
        self.store = TensorStore()
        # Durability: the Raft WAL is the SINGLE durable log (term, vote,
        # log entries, compaction snapshots). The state machine (store)
        # is a pure function of snapshot + log, so restart = restore the
        # snapshot then deterministically re-apply committed entries —
        # no separate store WAL, no two-log atomicity gap, no
        # double-applied statements (raft_wal.rs capability).
        self.raft_wal = None
        if wal_dir:
            import os

            os.makedirs(wal_dir, exist_ok=True)
            from neumann_tpu_torch.chain.raft_wal import RaftWal

            self.raft_wal = RaftWal(os.path.join(wal_dir, "raft.wal"))
        self.raft = RaftNode(node_id, [node_id, *peers],
                             config or RaftConfig(), seed=seed,
                             wal=self.raft_wal)
        self.compact_threshold = 2048
        self.transport = TcpTransport(node_id, host=host, port=port,
                                      compress=compress,
                                      tls_server=tls_server,
                                      tls_client=tls_client)
        self._peer_addrs = dict(peers)
        if query_executor is None:
            from neumann_tpu_torch.router import QueryRouter

            router = QueryRouter(self.store, device=device)
            # node-embedded router: its store is Raft-replicated, so
            # read-only statements stay local even when a
            # cluster_client is attached (no TCP round-trip for reads)
            router.cluster_read_mode = "local"
            query_executor = lambda q: _result_to_jsonable(  # noqa: E731
                router.execute(q))
            self.router = router
        self.query_executor = query_executor
        # restore the state machine from the raft snapshot (router is
        # built first so store hooks repopulate the engines)
        self._applied_index = self.raft.snapshot_index
        snap = self.raft.snapshot_data
        if snap and "store" in snap:
            import base64

            self._restore_collections(snap)
            self.store.restore_from_bytes(base64.b64decode(snap["store"]))
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._init_protocol(list(peers), seed=seed, gossip=gossip,
                            auto_remove_faulty=auto_remove_faulty,
                            faulty_grace_ticks=faulty_grace_ticks)
        # leader-side: log index -> (reply node, qid) for replicated
        # statements awaiting commit before the client gets its answer
        self._stmt_replies: Dict[int, Tuple[str, Optional[str]]] = {}
        # proxy-side: qid -> original requester (thin clients are only
        # connected to their serving node, so replies relay through it)
        self._relay: Dict[str, str] = {}
        # defense-in-depth: every inbound frame is schema-checked before
        # it can reach Raft/2PC/gossip (message_validation.rs wired into
        # the live loop, not just tests)
        self.rejected_messages = 0
        self.reject_reasons: List[str] = []

    @property
    def address(self) -> Tuple[str, int]:
        return self.transport.address

    # -- lifecycle ----------------------------------------------------------
    def connect_peers(self, retries: int = 100,
                      delay_s: float = 0.1) -> None:
        for peer, addr in self._peer_addrs.items():
            for _ in range(retries):
                try:
                    self.transport.connect(peer, tuple(addr))
                    break
                except OSError:
                    time.sleep(delay_s)

    def start(self, tick_interval_s: float = 0.05) -> None:
        self.connect_peers()
        self._thread = threading.Thread(
            target=self._loop, args=(tick_interval_s,), daemon=True)
        self._thread.start()

    def _loop(self, tick_interval_s: float) -> None:
        while not self._stop.is_set():
            with self._lock:
                outbound = self.raft.tick()
            self._send_all(outbound)
            self._protocol_tick()
            deadline = time.time() + tick_interval_s
            while time.time() < deadline:
                msg = self.transport.recv(
                    timeout=max(0.001, deadline - time.time()))
                if msg is None:
                    break
                ok, reason = validate_message(msg)
                if not ok:
                    self.rejected_messages += 1
                    if len(self.reject_reasons) < 100:
                        self.reject_reasons.append(
                            f"{msg.kind}: {reason}")
                    continue
                self._handle(msg)
            self._apply_committed()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.transport.close()
        self.store.wal_flush()
        if self.raft_wal is not None:
            self.raft_wal.close()

    # -- client API ----------------------------------------------------------
    def is_leader(self) -> bool:
        return self.raft.state == LEADER

    def leader_hint(self) -> Optional[str]:
        return self.raft.leader_id

    def propose_put(self, key: str, data: TensorData) -> bool:
        """Replicated put: proposes locally when leader, else forwards.
        Delta-coded once a registry is replicated."""
        return self._propose_or_forward(self._encode_put(key, data))

    def propose_delete(self, key: str) -> bool:
        return self._propose_or_forward({"op": "delete", "key": key})

    def propose_cas(self, key: str, field: str, expected,
                    data: TensorData) -> Optional[str]:
        """Conditional replicated write; resolves at apply time in log
        order on every replica (see ClusterNode.propose_cas). Returns
        the request id to poll with cas_result, or None when the
        proposal could not be placed."""
        rid = self._next_cas_rid()
        ok = self._propose_or_forward(
            {"op": "cas", "key": key, "field": field,
             "expected": expected, "rid": rid,
             "data": codec.encode_data(data).hex()})
        return rid if ok else None

    def _propose_or_forward(self, payload: dict) -> bool:
        with self._lock:
            if self.raft.state == LEADER:
                return self.raft.propose(payload) is not None
            leader = self.raft.leader_id
        if leader is None:
            return False
        return self.transport.send(leader, "cluster_forward",
                                   {"entry": payload})

    # -- message handling -------------------------------------------------------
    def _send_all(self, msgs: List[Message]) -> None:
        for m in msgs:
            self._send_msg(m)

    def _send(self, dst: str, kind: str, payload: dict) -> None:
        self.transport.send(dst, kind, payload)

    def _deliver_raft(self, msg: Message) -> None:
        with self._lock:
            outbound = self.raft.handle(msg)
        self._send_all(outbound)

    def _handle(self, msg: Message) -> None:
        if self._protocol_handle(msg):
            return
        if msg.kind == "cluster_forward":
            with self._lock:
                if self.raft.state == LEADER:
                    self.raft.propose(msg.payload["entry"])
            return
        if msg.kind == "cluster_query":
            query = msg.payload["query"]
            qid = msg.payload.get("qid")
            reply_to = msg.payload.get("reply_to", msg.src)
            strong = bool(msg.payload.get("strong"))
            if strong and not _is_replicated_statement(query):
                # strong read: execute on the leader (its state machine
                # is never behind its own commit index)
                with self._lock:
                    is_leader = self.raft.state == LEADER
                    leader = self.raft.leader_id
                if not is_leader:
                    if leader is None:
                        self.transport.send(
                            reply_to, "cluster_query_result",
                            {"qid": qid, "result": None,
                             "error": "no leader available"})
                        return
                    if qid is not None:
                        with self._lock:
                            self._relay[qid] = reply_to
                    self.transport.send(leader, "cluster_query",
                                        {"query": query, "qid": qid,
                                         "reply_to": self.id})
                    return
            if _is_replicated_statement(query):
                # destructive: ride the Raft log so EVERY node executes
                # it in the same order; reply after commit
                with self._lock:
                    if self.raft.state == LEADER:
                        idx = self.raft.propose({"op": "stmt",
                                                 "q": query})
                        if idx is not None:
                            self._stmt_replies[idx] = (reply_to, qid)
                            return
                    leader = self.raft.leader_id
                if leader is not None and leader != self.id:
                    # proxy: the leader may not have a route to a thin
                    # client, so replies come back through THIS node
                    if qid is not None:
                        with self._lock:
                            self._relay[qid] = reply_to
                    self.transport.send(leader, "cluster_query",
                                        {"query": query, "qid": qid,
                                         "reply_to": self.id})
                    return
                self.transport.send(reply_to, "cluster_query_result",
                                    {"qid": qid, "result": None,
                                     "error": "no leader available"})
                return
            try:
                result = self.query_executor(query)
                err = None
            except Exception as e:  # surface to the caller, not the log
                result, err = None, f"{type(e).__name__}: {e}"
            self.transport.send(
                reply_to, "cluster_query_result",
                {"qid": qid, "result": result, "error": err})
            return
        if msg.kind == "cluster_query_result":
            qid = msg.payload.get("qid")
            with self._lock:
                target = self._relay.pop(qid, None) if qid else None
            if target is not None:
                self.transport.send(target, "cluster_query_result",
                                    msg.payload)
            return
        if msg.kind == "client_hello":
            # a thin client joined: dial back so replies can flow
            try:
                self.transport.connect(msg.src,
                                       tuple(msg.payload["addr"]))
            except OSError:
                pass
            return
        with self._lock:
            outbound = self.raft.handle(msg)
        self._send_all(outbound)

    def _apply_committed(self) -> None:
        with self._lock:
            # a leader-installed snapshot jumped us past entries we never
            # saw: reset the state machine from the snapshot data first
            if self.raft.snapshot_index > self._applied_index:
                snap = self.raft.snapshot_data
                if snap and "store" in snap:
                    import base64

                    self._restore_collections(snap)
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
            elif op == "stmt":
                # deterministic state machine: every node executes the
                # statement in log order
                try:
                    result = self.query_executor(payload["q"])
                    err = None
                except Exception as e:
                    result, err = None, f"{type(e).__name__}: {e}"
                with self._lock:
                    reply = self._stmt_replies.pop(idx, None)
                if reply is not None:
                    reply_to, qid = reply
                    self.transport.send(
                        reply_to, "cluster_query_result",
                        {"qid": qid, "result": result, "error": err})
            self._applied_index = idx
        self._maybe_compact()

    def _maybe_compact(self) -> None:
        """Snapshot the store + drop the applied log prefix once the
        log outgrows the threshold; rotates the raft WAL atomically."""
        if self.raft_wal is None:
            return
        with self._lock:
            if len(self.raft.log) <= self.compact_threshold or \
                    self.raft.last_applied <= self.raft.snapshot_index:
                return
            import base64

            data = {"store": base64.b64encode(
                self.store.snapshot_bytes()).decode("ascii")}
            router = getattr(self, "router", None)
            if router is not None:
                vec = router.vector
                data["collections"] = {
                    name: dataclasses.asdict(vec.collection_config(name))
                    for name in vec.list_collections()}
            self.raft.compact(upto=self.raft.last_applied,
                              snapshot_data=data)

    def _restore_collections(self, snap: dict) -> None:
        """Create the collections a snapshot records (its rows follow),
        with the configs they had; those that exist stay."""
        router = getattr(self, "router", None)
        if router is None:
            return
        from neumann_tpu_torch.engines.vector import VectorCollectionConfig

        have = set(router.vector.list_collections())
        for name, cfg in (snap.get("collections") or {}).items():
            if name not in have:
                router.vector.create_collection(
                    name, VectorCollectionConfig(**cfg))


def _result_to_jsonable(res) -> dict:
    return {"kind": res.kind, "message": res.message, "rows": res.rows,
            "hits": res.results, "count": res.count, "value": res.value}


class ClusterClient:
    """Thin client: joins the TCP fabric without running Raft and
    executes statements on whichever node it talks to (reads run there;
    writes that go through replicated puts route to the leader)."""

    def __init__(self, node_addr: Tuple[str, int],
                 client_id: Optional[str] = None,
                 compress: bool = True):
        self.id = client_id or f"client-{uuid.uuid4().hex[:8]}"
        self.transport = TcpTransport(self.id, compress=compress)
        self._node = "node"
        self.transport.connect(self._node, tuple(node_addr))
        self.transport.send(self._node, "client_hello",
                            {"addr": list(self.transport.address)})

    def execute(self, query: str, timeout: float = 10.0,
                strong: bool = False) -> dict:
        """Execute a statement. Writes replicate through the Raft log
        and reply after commit. Reads run on the serving node (eventual
        consistency on followers); pass ``strong=True`` to route the
        read to the leader."""
        qid = uuid.uuid4().hex
        if not self.transport.send(self._node, "cluster_query",
                                   {"query": query, "qid": qid,
                                    "strong": strong}):
            raise ChainError("node unreachable")
        deadline = time.time() + timeout
        while time.time() < deadline:
            msg = self.transport.recv(
                timeout=max(0.01, deadline - time.time()))
            if msg is None:
                continue
            if msg.kind == "cluster_query_result" and \
                    msg.payload.get("qid") == qid:
                if msg.payload.get("error"):
                    raise ChainError(msg.payload["error"])
                return msg.payload["result"]
        raise ChainError(f"query timed out after {timeout}s")

    def close(self) -> None:
        self.transport.close()


def build_node(argv=None) -> Tuple[TcpClusterNode, object]:
    """Parse CLI flags / NEUMANN_* env vars into a TcpClusterNode.

    Split from main() so the flag->node wiring is testable without a
    serve loop (the loop itself is exercised by the multiprocess
    cluster tests)."""
    import argparse

    import os

    # flags override the NEUMANN_* env vars the reference's ops docs
    # use for container deployment (operations/configuration.md)
    env = os.environ
    ap = argparse.ArgumentParser(prog="neumann-tpu-node")
    ap.add_argument("--id", default=env.get("NEUMANN_NODE_ID"),
                    required="NEUMANN_NODE_ID" not in env)
    ap.add_argument("--host",
                    default=env.get("NEUMANN_CLUSTER_BIND_ADDR",
                                    "127.0.0.1"))
    ap.add_argument("--port", type=int,
                    default=(int(env["NEUMANN_CLUSTER_PORT"])
                             if "NEUMANN_CLUSTER_PORT" in env
                             else None),
                    required="NEUMANN_CLUSTER_PORT" not in env)
    ap.add_argument("--peers", default=env.get("NEUMANN_PEERS", ""),
                    help="comma-separated id=host:port")
    ap.add_argument("--wal-dir", default=env.get("NEUMANN_DATA_DIR"))
    ap.add_argument("--auto-remove-faulty", action="store_true",
                    default=env.get("NEUMANN_AUTO_REMOVE_FAULTY")
                    == "1",
                    help="gossip failure detection drives Raft "
                         "membership (remove after grace, re-add as "
                         "learner + promote on heal)")
    ap.add_argument("--faulty-grace-ticks", type=int,
                    default=int(env.get("NEUMANN_FAULTY_GRACE", "40")))
    ap.add_argument("--device", default="cuda",
                    help="device of the node's query router")
    args = ap.parse_args(argv)
    peers: Dict[str, Tuple[str, int]] = {}
    for item in filter(None, args.peers.split(",")):
        pid, addr = item.split("=", 1)
        h, p = addr.rsplit(":", 1)
        peers[pid] = (h, int(p))
    node = TcpClusterNode(args.id, peers, host=args.host,
                          port=args.port, wal_dir=args.wal_dir,
                          auto_remove_faulty=args.auto_remove_faulty,
                          faulty_grace_ticks=args.faulty_grace_ticks,
                          device=args.device)
    return node, args


def main(argv=None) -> int:
    """CLI entry: run one cluster node until SIGINT."""
    node, args = build_node(argv)
    node.start()
    print(f"node {args.id} listening on {node.address}; "
          f"peers: {sorted(node._peer_addrs)}", flush=True)
    try:
        while True:
            time.sleep(2.0)
            print(f"[{args.id}] state={node.raft.state} "
                  f"term={node.raft.term} "
                  f"applied={node._applied_index} "
                  f"store={len(node.store)} "
                  f"voters={','.join(sorted(node.raft.voters))}",
                  flush=True)
    except KeyboardInterrupt:
        node.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

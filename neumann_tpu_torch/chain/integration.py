"""Cluster protocol integration: the glue that boots the whole stack.

Parity with the reference's ClusterOrchestrator boot path
(tensor_chain/src/cluster.rs:230-330), which wires store -> transport ->
membership -> gossip -> 2PC -> delta replication -> Raft -> chain
together. This mixin gives both ClusterNode (in-process) and
TcpClusterNode (multiprocess) the integrated behaviors:

- SWIM gossip rides the same transport; its failure detector can drive
  Raft membership (auto-remove a faulty voter after a grace period,
  re-add as learner + promote on heal) — gossip.rs + membership.rs.
- Delta replication: once an archetype registry is replicated through
  the log, put payloads carry (archetype id, sparse delta) instead of
  dense embeddings — smaller AppendEntries AND a smaller Raft WAL
  (delta_replication.rs, 4-6x bandwidth).
- Snapshot streaming: install_snapshot payloads above a threshold are
  chunked with SHA-256 validation and reassembled before entering the
  Raft core (snapshot_streaming.rs).
- Partition merge: writes accepted in eventual mode while partitioned
  are offered to the leader on heal; the leader classifies conflicts
  with the consensus delta-geometry kernel and proposes the resolutions
  THROUGH the log, so every store converges deterministically
  (partition_merge.rs 6-phase protocol with RESOLVE riding Raft).

The port's copy of ``neumann_tpu/chain/integration.py``:
only its import lines differ, and delta replication's archetype registry
runs its k-means on the node's ``device``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from neumann_tpu_torch.chain.gossip import (
    ALIVE,
    FAULTY,
    GossipConfig,
    GossipNode,
)
from neumann_tpu_torch.chain.snapshot_streaming import (
    SnapshotChunk,
    SnapshotReceiver,
    stream_snapshot,
)
from neumann_tpu_torch.chain.transport import Message
from neumann_tpu_torch.store import codec
from neumann_tpu_torch.store.tensor_store import TensorData, TensorValue

GOSSIP_KINDS = frozenset(("ping", "ack", "ping_req", "ack_relay"))
SNAPSHOT_STREAM_THRESHOLD = 32 * 1024


class ClusterProtocolMixin:
    """Host class must provide: id, raft, store, _lock, and
    _send(dst, kind, payload) -> None."""

    def _init_protocol(self, peer_ids, seed: int = 0,
                       gossip: bool = True,
                       gossip_config: Optional[GossipConfig] = None,
                       auto_remove_faulty: bool = False,
                       faulty_grace_ticks: int = 10):
        self.gossip = (GossipNode(self.id, list(peer_ids),
                                  gossip_config, seed=seed)
                       if gossip else None)
        self.auto_remove_faulty = auto_remove_faulty
        self.faulty_grace_ticks = faulty_grace_ticks
        self._faulty_since: Dict[str, int] = {}
        self._protocol_ticks = 0
        self.delta_replicator = None
        # replicated compare-and-swap bookkeeping (shared by the
        # in-process and TCP node flavors)
        self._cas_seq = 0
        self.cas_results: Dict[str, bool] = {}
        self._snap_rx = SnapshotReceiver()
        self._snap_id = 0
        # eventual-mode writes awaiting reconciliation after a heal
        self.local_writes: Dict[str, TensorData] = {}
        self.merge_reports: List[dict] = []
        self._known_faulty: set = set()
        # wall-clock base keeps offer seqs increasing across restarts,
        # so a rebooted node's fresh offers don't look like replays
        import time as _time

        self._offer_seq = int(_time.time() * 1000) << 10
        self._last_offer_tick = -10**9
        # replay/DoS defense on the leader's offer intake
        # (signing.rs SequenceTracker capability)
        from neumann_tpu_torch.chain.sequence import SequenceTracker

        self._offer_tracker = SequenceTracker()
        # leader-side: offers answered only after their resolution
        # entries COMMIT (a deposed leader's proposals may vanish, so
        # an early merge_done could lose the offered writes)
        self._handled_offers: Dict[str, dict] = {}
        self._pending_merge_replies: List[tuple] = []
        self._outstanding_offers: Dict[str, set] = {}
        # geometric membership: each node carries an identity embedding
        # (derived from its id, like signing.derive_embedding); gossip
        # piggybacks it, and semantically-near peers are preferred for
        # merge offers (geometric_membership.rs + GeometricTransport
        # send_to_nearest capability). Also powers the raft pre-vote
        # geometric tie-break when enabled in RaftConfig.
        from neumann_tpu_torch.chain.geometric import GeometricMembership
        from neumann_tpu_torch.chain.signing import derive_embedding

        my_emb = derive_embedding(self.id.encode("utf-8"), dim=16)
        self.geom = GeometricMembership(self.id, my_emb)
        if getattr(self.raft.config, "enable_geometric_tiebreak",
                   False):
            self.raft.state_embedding = my_emb.tolist()

    # -- outbound ----------------------------------------------------------
    def _send_msg(self, m: Message) -> None:
        """Send one protocol message, streaming large snapshots."""
        if m.kind == "install_snapshot":
            data = m.payload.get("data")
            blob = json.dumps(data).encode() if data is not None else b""
            if len(blob) > SNAPSHOT_STREAM_THRESHOLD:
                self._snap_id += 1
                sid = f"{self.id}:{self._snap_id}"
                meta = {k: v for k, v in m.payload.items()
                        if k != "data"}
                for chunk in stream_snapshot(sid, blob):
                    p = chunk.to_payload()
                    p["raft_meta"] = meta
                    self._send(m.dst, "snap_chunk", p)
                return
        self._send(m.dst, m.kind, m.payload)

    # -- inbound -----------------------------------------------------------
    def _protocol_handle(self, msg: Message) -> bool:
        """Returns True when the message was consumed here."""
        if msg.kind in GOSSIP_KINDS:
            if self.gossip is not None:
                geo = msg.payload.get("geo")
                if geo is not None:
                    self.geom.upsert_peer(msg.src, geo)
                with self._lock:
                    out = self.gossip.handle(msg)
                for m in out:
                    p = dict(m.payload)
                    p["geo"] = self.geom.embedding.tolist()
                    self._send(m.dst, m.kind, p)
                self._check_heals()
            return True
        if msg.kind == "snap_chunk":
            p = dict(msg.payload)
            meta = p.pop("raft_meta")
            blob = self._snap_rx.receive(SnapshotChunk.from_payload(p))
            if blob is not None:
                payload = dict(meta)
                payload["data"] = json.loads(blob.decode())
                self._deliver_raft(
                    Message("install_snapshot", msg.src, self.id,
                            payload))
            return True
        if msg.kind == "merge_offer":
            self._on_merge_offer(msg)
            return True
        if msg.kind == "merge_done":
            with self._lock:
                # clear only the keys that offer covered: writes made
                # AFTER it was sent still need their own merge
                covered = self._outstanding_offers.pop(
                    msg.payload.get("oid"), None)
                if covered is None:
                    covered = set(self.local_writes)
                for k in covered:
                    self.local_writes.pop(k, None)
                self.merge_reports.append(msg.payload.get("report", {}))
            return True
        return False

    def _protocol_tick(self) -> None:
        if self.gossip is None:
            return
        self._protocol_ticks += 1
        with self._lock:
            out = self.gossip.tick()
        for m in out:
            p = dict(m.payload)
            p["geo"] = self.geom.embedding.tolist()
            self._send(m.dst, m.kind, p)
        self._check_heals()
        self._drive_membership()
        self._flush_merge_replies()
        # liveness: unacknowledged local writes re-offer periodically
        # (the previous offer may have hit a deposed leader)
        with self._lock:
            stale = (self.local_writes
                     and self._protocol_ticks - self._last_offer_tick
                     > 25)
            leader = self.raft.leader_id
        if stale:
            target = leader
            if target is None and self.gossip is not None:
                alive = self.gossip.alive_peers()
                # prefer the semantically nearest alive peer
                ranked = [p for p in self.geom.rank_peers()
                          if p in alive]
                if ranked:
                    target = ranked[0]
                elif alive:
                    target = alive[0]
            if target is not None:
                self._offer_merge(target)

    def _flush_merge_replies(self) -> None:
        from neumann_tpu_torch.chain.raft import LEADER

        if not self._pending_merge_replies:
            return
        with self._lock:
            is_leader = self.raft.state == LEADER
            commit = self.raft.commit_index
            pending = self._pending_merge_replies
            done, keep = [], []
            for reply_to, oid, report, upto in pending:
                if not is_leader:
                    # deposed: our proposals may never commit — drop;
                    # the offerer re-offers to the real leader
                    self._handled_offers.pop(oid, None)
                elif commit >= upto:
                    done.append((reply_to, oid, report))
                else:
                    keep.append((reply_to, oid, report, upto))
            self._pending_merge_replies = keep
        for reply_to, oid, report in done:
            self._send(reply_to, "merge_done",
                       {"oid": oid, "report": report})
            # answered: drop the dedup record (memory stays bounded;
            # a late duplicate of this oid is caught by _offer_tracker)
            with self._lock:
                self._handled_offers.pop(oid, None)

    # -- failure detection -> membership ----------------------------------
    def _drive_membership(self) -> None:
        from neumann_tpu_torch.chain.raft import LEADER

        if not self.auto_remove_faulty:
            return
        with self._lock:
            if self.raft.state != LEADER:
                self._faulty_since.clear()
                return
            voters = set(self.raft.voters)
            learners = set(self.raft.learners)
            for peer in list(self._faulty_since):
                if self.gossip.status_of(peer) != FAULTY:
                    del self._faulty_since[peer]
            for peer, st in self.gossip.members.items():
                if peer == self.id:
                    continue
                if st.status == FAULTY and peer in voters:
                    since = self._faulty_since.setdefault(
                        peer, self._protocol_ticks)
                    # never remove below a functioning majority of the
                    # CURRENT config (safety over liveness)
                    if (self._protocol_ticks - since
                            >= self.faulty_grace_ticks
                            and len(voters) > 2):
                        self.raft.propose_config_change("remove", peer)
                elif st.status == ALIVE and peer not in voters \
                        and peer not in learners:
                    # healed node rejoins as a learner first
                    self.raft.propose_config_change("add_learner", peer)
                elif st.status == ALIVE and peer in learners and \
                        self.raft.match_index.get(peer, 0) >= \
                        self.raft.commit_index:
                    # caught up -> full voter
                    self.raft.propose_config_change("promote", peer)

    # -- heal detection -> partition merge ---------------------------------
    def partition_status(self, grace_ticks: int = 10) -> str:
        """This node's quorum view (membership.rs PartitionStatus)."""
        if self.gossip is None:
            return "unknown"
        with self._lock:
            return self.gossip.partition_status(grace_ticks)

    def _check_heals(self) -> None:
        if self.gossip is None:
            return
        with self._lock:
            faulty_now = {p for p, m in self.gossip.members.items()
                          if m.status == FAULTY}
            healed = self._known_faulty - faulty_now
            self._known_faulty = faulty_now
            has_local = bool(self.local_writes)
        if healed and has_local:
            self._offer_merge(next(iter(healed)))

    def put_local(self, key: str, data: TensorData) -> None:
        """Eventual-mode write: applied locally NOW, reconciled with the
        cluster when the partition heals (reference offline mode)."""
        with self._lock:
            self.local_writes[key] = data
        self.store.put(key, data)

    def _offer_merge(self, via: str) -> None:
        with self._lock:
            items = [{"key": k, "data": codec.encode_data(d).hex()}
                     for k, d in self.local_writes.items()]
            self._offer_seq += 1
            oid = f"{self.id}:{self._offer_seq}"
            self._last_offer_tick = self._protocol_ticks
            self._outstanding_offers[oid] = {
                it["key"] for it in items}
        if not items:
            return
        payload = {"items": items, "reply_to": self.id, "oid": oid}
        if via == self.id:
            # the leader itself holds eventual writes: merge locally
            self._on_merge_offer(Message("merge_offer", self.id,
                                         self.id, payload))
        else:
            self._send(via, "merge_offer", payload)

    def _on_merge_offer(self, msg: Message) -> None:
        """Leader-side 6-phase resolution, with RESOLVE riding the log."""
        from neumann_tpu_torch.chain.consensus import (
            ConflictClass,
            ConsensusConfig,
            classify_delta_geometry,
        )
        from neumann_tpu_torch.chain.raft import LEADER

        reply_to = msg.payload.get("reply_to", msg.src)
        oid = msg.payload.get("oid", f"{reply_to}:?")
        with self._lock:
            is_leader = self.raft.state == LEADER
            leader = self.raft.leader_id
            already = self._handled_offers.get(oid)
        if not is_leader:
            if leader is not None and leader != self.id:
                self._send(leader, "merge_offer", msg.payload)
            return
        if already is not None:
            return   # duplicate offer: the pending reply covers it
        src, _, seq_txt = oid.rpartition(":")
        if src and seq_txt.isdigit():
            ok, _reason = self._offer_tracker.check_and_record(
                src, int(seq_txt))
            if not ok:
                return   # replayed or out-of-order offer id
        report = {"merged": [], "took_leader": [], "took_offer": [],
                  "conflicts": []}
        cfg = ConsensusConfig()
        idxs: list = []
        for item in msg.payload.get("items", []):
            key = item["key"]
            offered = codec.decode_data(bytes.fromhex(item["data"]))
            ours = self.store.get(key)
            if ours is None:
                idxs.append(self._propose_resolution(key, offered))
                report["took_offer"].append(key)
                continue
            le = self._emb_of(ours)
            re = self._emb_of(offered)
            if le is None or re is None or le.size != re.size:
                # no comparable embeddings: leader's copy wins, but the
                # conflict is surfaced (and re-proposed so the offering
                # side converges back to the leader's value)
                idxs.append(self._propose_resolution(key, ours))
                report["conflicts"].append(key)
                continue
            cls = classify_delta_geometry(le, re, cfg)
            if cls == ConflictClass.IDENTICAL:
                # STILL propose: "ours" may exist only in this node's
                # unreplicated eventual-mode store (e.g. the leader
                # itself took a local write) — every resolution rides
                # the log so all stores converge
                idxs.append(self._propose_resolution(key, ours))
                report["took_leader"].append(key)
            elif cls == ConflictClass.ORTHOGONAL:
                merged = TensorData()
                for name, val in ours.fields.items():
                    merged.set(name, val)
                for name, val in offered.fields.items():
                    if name != "embedding" and \
                            name not in merged.fields:
                        merged.set(name, val)
                merged.set("embedding", TensorValue.vector(le + re))
                idxs.append(self._propose_resolution(key, merged))
                report["merged"].append(key)
            elif cls == ConflictClass.SIMILAR:
                idxs.append(self._propose_resolution(key, ours))
                report["took_leader"].append(key)
            else:
                idxs.append(self._propose_resolution(key, ours))
                report["conflicts"].append(key)
        if any(i is None for i in idxs):
            return   # lost leadership mid-offer; offerer will retry
        with self._lock:
            self.merge_reports.append(report)
            upto = max([i for i in idxs if i is not None],
                       default=self.raft.commit_index)
            self._handled_offers[oid] = report
            self._pending_merge_replies.append(
                (reply_to, oid, report, upto))
        self._flush_merge_replies()

    @staticmethod
    def _emb_of(data: TensorData) -> Optional[np.ndarray]:
        emb = data.get("embedding")
        if emb is None or not emb.is_vector():
            return None
        return emb.to_dense()

    def _propose_resolution(self, key: str, data: TensorData):
        with self._lock:
            return self.raft.propose(self._encode_put(key, data))

    # -- delta replication -------------------------------------------------
    def enable_delta_replication(self, dim: int,
                                 n_archetypes: int = 8) -> bool:
        """Leader: discover archetypes from current store embeddings and
        replicate the registry through the log. After the registry entry
        commits, every put with a dim-matching dense embedding rides the
        wire (and the WAL) as (archetype, sparse delta). The archetypes'
        k-means runs on the node's ``device``."""
        from neumann_tpu_torch.chain.delta_replication import DeltaReplicator
        from neumann_tpu_torch.chain.raft import LEADER
        from neumann_tpu_torch.store.delta_vector import (
            ArchetypeRegistry,
            KMeansConfig,
        )

        with self._lock:
            if self.raft.state != LEADER:
                return False
        vecs = []
        for key in self.store.keys():
            data = self.store.get(key)
            if data is None:
                continue
            emb = self._emb_of(data)
            if emb is not None and emb.size == dim:
                vecs.append(emb)
        if len(vecs) < max(2, n_archetypes):
            return False
        reg = ArchetypeRegistry(device=self.device)
        reg.discover_archetypes(np.stack(vecs),
                                KMeansConfig(k=n_archetypes))
        rep = DeltaReplicator(reg)
        snap = rep.registry_snapshot()
        with self._lock:
            self.raft.propose({"op": "delta_registry", "snap": snap,
                               "dim": dim})
        return True

    def _encode_put(self, key: str, data: TensorData) -> dict:
        rep = self.delta_replicator
        if rep is not None:
            emb = self._emb_of(data)
            if emb is not None and \
                    emb.size == rep.registry.centroids.shape[1]:
                [rec] = rep.encode_batch([(key, emb)])
                rest = TensorData()
                for name, val in data.fields.items():
                    if name != "embedding":
                        rest.set(name, val)
                return {"op": "put_delta", "key": key,
                        "rest": codec.encode_data(rest).hex(),
                        "rec": {k: rec[k] for k in
                                ("archetype", "dim", "positions",
                                 "values")}}
        return {"op": "put", "key": key,
                "data": codec.encode_data(data).hex()}

    def _next_cas_rid(self) -> str:
        with self._lock:
            self._cas_seq += 1
            return f"{self.id}:cas{self._cas_seq}"

    def cas_result(self, rid: str) -> Optional[bool]:
        """True/False once the CAS entry has applied locally; None
        while it is still in flight."""
        with self._lock:
            return self.cas_results.get(rid)

    def _apply_cas(self, payload: dict) -> None:
        """Apply a committed CAS entry: the expected-value comparison
        runs HERE, in log order, so every replica resolves the same
        winner. expected=None matches a missing key/field."""
        cur = self.store.get(payload["key"])
        field = payload["field"]
        val = None
        if cur is not None and cur.get(field) is not None:
            val = cur.get(field).value
        ok = val == payload["expected"]
        if ok:
            self.store.put(payload["key"], codec.decode_data(
                bytes.fromhex(payload["data"])))
        with self._lock:
            self.cas_results[payload["rid"]] = ok
            if len(self.cas_results) > 10_000:
                self.cas_results.pop(next(iter(self.cas_results)))

    def _apply_protocol_entry(self, payload: dict) -> bool:
        """Apply integration-owned log entries; True when handled."""
        op = payload.get("op")
        if op == "cas":
            self._apply_cas(payload)
            return True
        if op == "delta_registry":
            from neumann_tpu_torch.chain.delta_replication import (
                DeltaReplicator,
            )

            self.delta_replicator = DeltaReplicator.from_snapshot(
                payload["snap"])
            return True
        if op == "put_delta":
            rep = self.delta_replicator
            if rep is None:      # registry entry always precedes these
                raise RuntimeError("put_delta before delta_registry")
            rec = dict(payload["rec"])
            rec["key"] = payload["key"]
            [(key, vec)] = rep.decode_batch([rec])
            data = codec.decode_data(bytes.fromhex(payload["rest"]))
            data.set("embedding", TensorValue.vector(vec))
            self.store.put(key, data)
            return True
        return False

    # host classes override ------------------------------------------------
    def _deliver_raft(self, msg: Message) -> None:  # pragma: no cover
        raise NotImplementedError

    def _send(self, dst: str, kind: str,
              payload: dict) -> None:  # pragma: no cover
        raise NotImplementedError

"""Tensor-Raft: deterministic sans-IO Raft core.

Parity with tensor_chain/src/raft.rs capability: leader election with
pre-vote, log replication with commit tracking, heartbeats, leadership
transfer (TimeoutNow), log compaction + snapshot install for lagging
followers, and persistence hooks (a RaftWal callback invoked before state
transitions, like raft_wal.rs fsyncs).

Design: the node never touches a clock or socket. `tick()` advances one
logical tick and returns outbound Messages; `handle(msg)` consumes one
inbound Message and returns outbound Messages; `take_committed()` yields
newly committed entries for the state machine. The cluster layer pumps
real time/transport; the DST harness pumps seeded simulated time — the
same core runs in both (the reference needs loom/DST for this; here
determinism is by construction).

The port's copy of ``neumann_tpu/chain/raft.py``:
only its import lines differ.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from neumann_tpu_torch.chain.transport import Message


def _stable_seed(seed: int, node_id: str) -> int:
    """Process-independent seed (str.__hash__ is randomized per run)."""
    import hashlib

    h = hashlib.blake2b(f"{seed}:{node_id}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little")

FOLLOWER = "follower"
PRE_CANDIDATE = "pre_candidate"
CANDIDATE = "candidate"
LEADER = "leader"


@dataclass
class RaftConfig:
    election_timeout_min: int = 10   # ticks
    election_timeout_max: int = 20
    heartbeat_interval: int = 3
    pre_vote: bool = True
    max_entries_per_append: int = 64
    snapshot_threshold: Optional[int] = None  # compact when log longer
    # geometric tie-breaking (raft.rs:90-98): pre-vote requests carry the
    # candidate's state embedding; when logs are exactly tied, voters
    # deny pre-votes to candidates whose embedding is dissimilar to
    # their own, biasing elections toward semantically close nodes.
    # Pre-vote denial never affects safety, only candidate selection.
    enable_geometric_tiebreak: bool = False
    geometric_tiebreak_threshold: float = 0.9


@dataclass
class LogEntry:
    term: int
    payload: dict


class RaftNode:
    def __init__(self, node_id: str, peers: List[str],
                 config: Optional[RaftConfig] = None, seed: int = 0,
                 wal=None):
        self.id = node_id
        # membership: voters count for quorum/elections; learners only
        # replicate. Supports BOTH the single-change-at-a-time fast path
        # and full joint consensus (C_old,new): while `joint_old` is set,
        # every quorum (election votes, commit acks) must hold a majority
        # in voters (C_new) AND in joint_old (C_old) — raft.rs /
        # membership.rs capability.
        self.voters = {p for p in peers} | {node_id}
        self.learners: set = set()
        self.joint_old: Optional[set] = None
        self._pending_config_index: Optional[int] = None
        self._joint_enter_index: Optional[int] = None
        self._joint_leave_index: Optional[int] = None
        # config at snapshot_index, for recompute after log truncation
        self._base_config = (set(self.voters), set(), None)
        self.config = config or RaftConfig()
        self._rng = random.Random(_stable_seed(seed, node_id))
        self._wal = wal

        # persistent state
        self.term = 0
        self.voted_for: Optional[str] = None
        self.log: List[LogEntry] = []
        # snapshot state (log compaction)
        self.snapshot_index = 0   # entries up to this global index live
        self.snapshot_term = 0    # in the snapshot, not in self.log
        self.snapshot_data: Optional[dict] = None

        # volatile
        self.state = FOLLOWER
        self.leader_id: Optional[str] = None
        self.commit_index = 0
        self.last_applied = 0
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        self._votes: set = set()
        self._pre_votes: set = set()
        # leader volatile
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}
        self._transfer_target: Optional[str] = None
        # optional state embedding for geometric tie-breaking
        self.state_embedding: Optional[List[float]] = None

        if self._wal is not None:
            rec = self._wal.load()
            if rec is not None:
                self._restore(rec)

    def _restore(self, rec) -> None:
        """Rebuild persistent state from a RecoveredRaftState."""
        self.term = rec.term
        self.voted_for = rec.voted_for
        self.snapshot_index = rec.snapshot_index
        self.snapshot_term = rec.snapshot_term
        self.snapshot_data = rec.snapshot_data
        if rec.config is not None:
            self._base_config = (
                set(rec.config["voters"]),
                set(rec.config.get("learners") or ()),
                set(rec.config["joint_old"])
                if rec.config.get("joint_old") is not None else None)
        self.log = [LogEntry(e["term"], e["payload"]) for e in rec.log]
        self._recompute_config()
        # the snapshot only ever covers committed, applied state
        self.commit_index = self.snapshot_index
        self.last_applied = self.snapshot_index

    # ------------------------------------------------------------------
    # log index helpers (global 1-based indices; snapshot may hide prefix)
    # ------------------------------------------------------------------
    def last_index(self) -> int:
        return self.snapshot_index + len(self.log)

    def last_term(self) -> int:
        if self.log:
            return self.log[-1].term
        return self.snapshot_term

    def term_at(self, index: int) -> Optional[int]:
        if index == 0:
            return 0
        if index == self.snapshot_index:
            return self.snapshot_term
        pos = index - self.snapshot_index - 1
        if 0 <= pos < len(self.log):
            return self.log[pos].term
        return None

    def entries_from(self, index: int) -> List[LogEntry]:
        pos = index - self.snapshot_index - 1
        if pos < 0:
            return []
        return self.log[pos:]

    def _rand_timeout(self) -> int:
        return self._rng.randint(self.config.election_timeout_min,
                                 self.config.election_timeout_max)

    def _wal_hard(self) -> None:
        """Record currentTerm/votedFor. Durable at the next sync()."""
        if self._wal is not None:
            self._wal.save_hard_state(self.term, self.voted_for)

    def _wal_append_tail(self, n: int = 1) -> None:
        """Record the n entries just appended to the log tail."""
        if self._wal is not None and n > 0:
            self._wal.append(self.last_index() - n + 1, self.log[-n:])

    def _wal_snapshot(self) -> None:
        """Rewrite the WAL at a compaction point (atomic rotation)."""
        if self._wal is None:
            return
        bv, bl, bj = self._base_config
        self._wal.save_snapshot(
            self.snapshot_index, self.snapshot_term,
            {"voters": sorted(bv), "learners": sorted(bl),
             "joint_old": sorted(bj) if bj is not None else None},
            self.snapshot_data, self.log, self.term, self.voted_for)

    def _wal_sync(self) -> None:
        """Durability barrier: called before outbound messages leave.
        A vote grant or append ack is never sent unsynced."""
        if self._wal is not None:
            self._wal.sync()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    @property
    def peers(self) -> List[str]:
        """Replication targets: every other voter (both configs while
        joint) + all learners."""
        return sorted((self.voters | (self.joint_old or set())
                       | self.learners) - {self.id})

    @property
    def voting_peers(self) -> List[str]:
        return sorted((self.voters | (self.joint_old or set()))
                      - {self.id})

    @staticmethod
    def _majority(acks: set, group: set) -> bool:
        return len(acks & group) * 2 > len(group)

    def _quorum_set(self, acks: set) -> bool:
        """Majority of C_new, AND of C_old while in joint consensus."""
        ok = self._majority(acks, self.voters)
        if self.joint_old is not None:
            ok = ok and self._majority(acks, self.joint_old)
        return ok

    # -- membership changes (single change at a time) -------------------
    def propose_config_change(self, op: str, node: str) -> Optional[int]:
        """op: add_learner | promote | remove. Leader-only; refuses
        while a previous change (single or joint) is uncommitted."""
        if self.state != LEADER or self.joint_old is not None:
            return None
        if self._pending_config_index is not None and \
                self.commit_index < self._pending_config_index:
            return None
        idx = self.propose({"__config__": {"op": op, "node": node}})
        if idx is not None:
            self._pending_config_index = idx
            # config applies on append (standard Raft), locally at once
            self._apply_config({"op": op, "node": node})
            if op == "add_learner":
                self.next_index[node] = self.last_index() + 1
                self.match_index[node] = 0
        return idx

    def propose_joint_change(self, add: Optional[List[str]] = None,
                             remove: Optional[List[str]] = None
                             ) -> Optional[int]:
        """Arbitrary membership change via joint consensus (C_old,new).

        Enters the joint configuration immediately (config-on-append);
        once the enter entry commits under BOTH majorities, the leader
        automatically appends the leave entry that finalizes C_new. A
        leader that removed itself steps down after the leave entry
        commits. Leader-only; refuses while any change is in flight.
        """
        if self.state != LEADER or self.joint_old is not None:
            return None
        if self._pending_config_index is not None and \
                self.commit_index < self._pending_config_index:
            return None
        old = set(self.voters)
        new = (old | set(add or [])) - set(remove or [])
        if not new:
            return None  # refusing to configure an empty cluster
        change = {"op": "joint_enter", "old": sorted(old),
                  "new": sorted(new)}
        idx = self.propose({"__config__": change})
        if idx is None:
            return None
        self._apply_config(change)
        self._joint_enter_index = idx
        for node in new - old:
            self.next_index.setdefault(node, self.last_index() + 1)
            self.match_index.setdefault(node, 0)
        return idx

    def _apply_config(self, change: dict) -> None:
        op = change["op"]
        if op == "joint_enter":
            self.joint_old = set(change["old"])
            self.voters = set(change["new"])
            self.learners -= self.voters
            return
        if op == "joint_leave":
            self.voters = set(change["new"])
            gone = (self.joint_old or set()) - self.voters
            self.joint_old = None
            for node in gone:
                self.next_index.pop(node, None)
                self.match_index.pop(node, None)
            return
        node = change["node"]
        if op == "add_learner":
            if node not in self.voters:
                self.learners.add(node)
        elif op == "promote":
            self.learners.discard(node)
            self.voters.add(node)
        elif op == "remove":
            self.voters.discard(node)
            self.learners.discard(node)
            self.next_index.pop(node, None)
            self.match_index.pop(node, None)

    def _config_tuple(self):
        return (set(self.voters), set(self.learners),
                set(self.joint_old) if self.joint_old is not None
                else None)

    def _recompute_config(self) -> None:
        """Rebuild membership from the snapshot-base config + the
        config entries still in the log (after conflict truncation)."""
        voters, learners, joint = self._base_config
        self.voters = set(voters)
        self.learners = set(learners)
        self.joint_old = set(joint) if joint is not None else None
        for e in self.log:
            cfg = e.payload.get("__config__") \
                if isinstance(e.payload, dict) else None
            if cfg:
                self._apply_config(cfg)

    def propose(self, payload: dict) -> Optional[int]:
        """Leader-only: append an entry; returns its global index."""
        if self.state != LEADER:
            return None
        self.log.append(LogEntry(self.term, payload))
        self._wal_append_tail()
        idx = self.last_index()
        self.match_index[self.id] = idx
        if not self.voting_peers:
            self._advance_commit()
        self._wal_sync()
        return idx

    def take_committed(self) -> List[Tuple[int, dict]]:
        """Newly committed (index, payload) entries since last call."""
        out = []
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            term = self.term_at(self.last_applied)
            if term is None:      # inside snapshot — already applied via
                continue          # install_snapshot on this node
            pos = self.last_applied - self.snapshot_index - 1
            out.append((self.last_applied, self.log[pos].payload))
        return out

    def transfer_leadership(self, target: str) -> List[Message]:
        if self.state != LEADER or target not in self.peers:
            return []
        self._transfer_target = target
        if self.match_index.get(target, 0) == self.last_index():
            return [Message("timeout_now", self.id, target,
                            {"term": self.term})]
        return []  # will fire once the target catches up

    def compact(self, upto: Optional[int] = None,
                snapshot_data: Optional[dict] = None) -> int:
        """Drop applied log prefix; returns new snapshot index."""
        upto = min(upto if upto is not None else self.last_applied,
                   self.last_applied)
        if upto <= self.snapshot_index:
            return self.snapshot_index
        term = self.term_at(upto)
        keep = upto - self.snapshot_index
        # roll the base config forward over the entries being dropped
        voters, learners, joint = self._base_config
        base_v, base_l = set(voters), set(learners)
        base_j = set(joint) if joint is not None else None
        saved = self._config_tuple()
        self.voters, self.learners, self.joint_old = base_v, base_l, base_j
        for e in self.log[:keep]:
            cfg = e.payload.get("__config__") \
                if isinstance(e.payload, dict) else None
            if cfg:
                self._apply_config(cfg)
        self._base_config = self._config_tuple()
        self.voters, self.learners, self.joint_old = saved
        self.log = self.log[keep:]
        self.snapshot_index = upto
        self.snapshot_term = term or 0
        self.snapshot_data = snapshot_data
        self._wal_snapshot()
        return upto

    # ------------------------------------------------------------------
    # time
    # ------------------------------------------------------------------
    def tick(self) -> List[Message]:
        out: List[Message] = []
        self._elapsed += 1
        if self.state == LEADER:
            if self._elapsed >= self.config.heartbeat_interval:
                self._elapsed = 0
                out += self._broadcast_append()
            if self.config.snapshot_threshold and \
                    len(self.log) > self.config.snapshot_threshold:
                self.compact()
            self._wal_sync()
            return out
        if self._elapsed >= self._timeout:
            out += self._start_election()
        self._wal_sync()
        return out

    def _start_election(self, skip_pre_vote: bool = False) -> List[Message]:
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        if not self.voting_peers:
            # single-voter cluster: win immediately
            self.term += 1
            self.voted_for = self.id
            self._wal_hard()
            self._become_leader()
            return []
        if self.config.pre_vote and not skip_pre_vote:
            self.state = PRE_CANDIDATE
            self._pre_votes = {self.id}
            payload = {"term": self.term + 1,
                       "last_index": self.last_index(),
                       "last_term": self.last_term()}
            if self.config.enable_geometric_tiebreak and \
                    self.state_embedding is not None:
                payload["embedding"] = list(self.state_embedding)
            return [Message("pre_vote_req", self.id, p, dict(payload))
                    for p in self.voting_peers]
        self.state = CANDIDATE
        self.term += 1
        self.voted_for = self.id
        self._wal_hard()
        self._votes = {self.id}
        return [Message("vote_req", self.id, p, {
            "term": self.term, "last_index": self.last_index(),
            "last_term": self.last_term()})
            for p in self.voting_peers]

    def _become_leader(self) -> None:
        self.state = LEADER
        self.leader_id = self.id
        self._elapsed = 0
        self._transfer_target = None
        for p in self.peers:
            self.next_index[p] = self.last_index() + 1
            self.match_index[p] = 0
        self.match_index[self.id] = self.last_index()
        # no-op entry to commit entries from prior terms promptly
        self.log.append(LogEntry(self.term, {"noop": True}))
        self._wal_append_tail()
        self.match_index[self.id] = self.last_index()
        if not self.voting_peers:
            self._advance_commit()

    def _become_follower(self, term: int,
                         leader: Optional[str] = None) -> None:
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._wal_hard()
        self.state = FOLLOWER
        self.leader_id = leader
        self._elapsed = 0
        self._timeout = self._rand_timeout()

    # ------------------------------------------------------------------
    # replication
    # ------------------------------------------------------------------
    def _broadcast_append(self) -> List[Message]:
        return [m for p in self.peers for m in self._append_for(p)]

    def _append_for(self, peer: str) -> List[Message]:
        nxt = self.next_index.get(peer, self.last_index() + 1)
        if nxt <= self.snapshot_index:
            base_v, base_l, base_j = self._base_config
            return [Message("install_snapshot", self.id, peer, {
                "term": self.term,
                "last_index": self.snapshot_index,
                "last_term": self.snapshot_term,
                "config": {"voters": sorted(base_v),
                           "learners": sorted(base_l),
                           "joint_old": sorted(base_j)
                           if base_j is not None else None},
                "data": self.snapshot_data})]
        prev = nxt - 1
        prev_term = self.term_at(prev)
        if prev_term is None:
            prev_term = self.snapshot_term
        entries = self.entries_from(nxt)[
            : self.config.max_entries_per_append]
        return [Message("append_entries", self.id, peer, {
            "term": self.term, "prev_index": prev,
            "prev_term": prev_term,
            "entries": [{"term": e.term, "payload": e.payload}
                        for e in entries],
            "leader_commit": self.commit_index})]

    def _advance_commit(self) -> None:
        everyone = self.voters | (self.joint_old or set())
        for idx in range(self.last_index(), self.commit_index, -1):
            if self.term_at(idx) != self.term:
                continue  # only commit current-term entries by counting
            acks = {p for p in everyone
                    if p == self.id
                    or self.match_index.get(p, 0) >= idx}
            if self._quorum_set(acks):
                self.commit_index = idx
                break
        self._advance_joint()

    def _advance_joint(self) -> None:
        """Leader: once the joint-enter entry commits, append the leave
        entry; once leave commits, finalize (and step down if removed)."""
        if self.state != LEADER:
            return
        if self._joint_enter_index is not None and \
                self.commit_index >= self._joint_enter_index:
            self._joint_enter_index = None
            change = {"op": "joint_leave", "new": sorted(self.voters)}
            self.log.append(LogEntry(self.term,
                                     {"__config__": change}))
            self._wal_append_tail()
            self._apply_config(change)
            self._joint_leave_index = self.last_index()
            self.match_index[self.id] = self.last_index()
        if self._joint_leave_index is not None and \
                self.commit_index >= self._joint_leave_index:
            self._joint_leave_index = None
            if self.id not in self.voters:
                self._become_follower(self.term)

    # ------------------------------------------------------------------
    # message handling
    # ------------------------------------------------------------------
    def handle(self, msg: Message) -> List[Message]:
        handler = getattr(self, f"_on_{msg.kind}", None)
        if handler is None:
            return []
        term = msg.payload.get("term", 0)
        if term > self.term and msg.kind not in ("pre_vote_req",
                                                 "pre_vote_resp"):
            self._become_follower(term)
        out = handler(msg)
        # durability barrier: a granted vote / successful append ack is
        # fsynced before the caller can put it on the wire (raft_wal.rs
        # fsync-before-transition capability)
        self._wal_sync()
        return out

    def _on_pre_vote_req(self, msg: Message) -> List[Message]:
        p = msg.payload
        ours = (self.last_term(), self.last_index())
        theirs = (p["last_term"], p["last_index"])
        up_to_date = theirs >= ours
        # grant pre-vote only if we haven't heard from a live leader
        no_leader = self._elapsed >= self.config.election_timeout_min or \
            self.leader_id is None
        grant = p["term"] > self.term and up_to_date and no_leader
        if grant and theirs == ours and \
                self.config.enable_geometric_tiebreak and \
                self.state_embedding is not None and \
                p.get("embedding") is not None:
            # exact log tie: prefer candidates with similar state
            import numpy as _np

            a = _np.asarray(p["embedding"], _np.float32)
            b = _np.asarray(self.state_embedding, _np.float32)
            na, nb = float(_np.linalg.norm(a)), float(_np.linalg.norm(b))
            if na > 0 and nb > 0 and float(a @ b) / (na * nb) < \
                    self.config.geometric_tiebreak_threshold:
                grant = False
        return [Message("pre_vote_resp", self.id, msg.src,
                        {"term": p["term"], "granted": grant})]

    def _on_pre_vote_resp(self, msg: Message) -> List[Message]:
        if self.state != PRE_CANDIDATE:
            return []
        if msg.payload.get("granted"):
            self._pre_votes.add(msg.src)
            if self._quorum_set(self._pre_votes):
                return self._start_election(skip_pre_vote=True)
        return []

    def _on_vote_req(self, msg: Message) -> List[Message]:
        p = msg.payload
        grant = False
        if p["term"] >= self.term:
            up_to_date = (p["last_term"], p["last_index"]) >= \
                (self.last_term(), self.last_index())
            if up_to_date and self.voted_for in (None, msg.src):
                grant = True
                self.voted_for = msg.src
                self._elapsed = 0
                self._wal_hard()
        return [Message("vote_resp", self.id, msg.src,
                        {"term": self.term, "granted": grant})]

    def _on_vote_resp(self, msg: Message) -> List[Message]:
        if self.state != CANDIDATE or msg.payload["term"] < self.term:
            return []
        if msg.payload.get("granted"):
            self._votes.add(msg.src)
            if self._quorum_set(self._votes):
                self._become_leader()
                return self._broadcast_append()
        return []

    def _on_append_entries(self, msg: Message) -> List[Message]:
        p = msg.payload
        if p["term"] < self.term:
            return [Message("append_resp", self.id, msg.src,
                            {"term": self.term, "success": False,
                             "match": 0})]
        self._become_follower(p["term"], leader=msg.src)
        prev = p["prev_index"]
        our_term = self.term_at(prev)
        if our_term is None or (prev > 0 and our_term != p["prev_term"]):
            return [Message("append_resp", self.id, msg.src,
                            {"term": self.term, "success": False,
                             "match": min(prev - 1, self.last_index())})]
        # append, truncating conflicts
        idx = prev
        first_new = None
        for e in p["entries"]:
            idx += 1
            existing = self.term_at(idx)
            if existing is None:
                self.log.append(LogEntry(e["term"], e["payload"]))
            elif existing != e["term"]:
                pos = idx - self.snapshot_index - 1
                self.log = self.log[:pos]
                self._recompute_config()
                if self._wal is not None:
                    self._wal.truncate_suffix(idx)
                self.log.append(LogEntry(e["term"], e["payload"]))
            else:
                continue
            if first_new is None:
                first_new = idx
            cfg = e["payload"].get("__config__") \
                if isinstance(e["payload"], dict) else None
            if cfg:
                self._apply_config(cfg)
        if first_new is not None and self._wal is not None:
            self._wal.append(
                first_new,
                self.log[first_new - self.snapshot_index - 1:])
        if p["leader_commit"] > self.commit_index:
            self.commit_index = min(p["leader_commit"], self.last_index())
        return [Message("append_resp", self.id, msg.src,
                        {"term": self.term, "success": True,
                         "match": idx})]

    def _on_append_resp(self, msg: Message) -> List[Message]:
        if self.state != LEADER:
            return []
        if msg.src not in self.next_index:
            return []  # node was removed from the config; stale resp
        p = msg.payload
        if p.get("success"):
            self.match_index[msg.src] = max(
                self.match_index.get(msg.src, 0), p["match"])
            self.next_index[msg.src] = self.match_index[msg.src] + 1
            self._advance_commit()
            out = []
            if self._transfer_target == msg.src and \
                    self.match_index[msg.src] == self.last_index():
                out.append(Message("timeout_now", self.id, msg.src,
                                   {"term": self.term}))
                self._transfer_target = None
            nxt = self.next_index.get(msg.src)
            if nxt is not None and nxt <= self.last_index():
                # (may be gone: _advance_commit can finalize a joint
                # change that removes this node mid-handler)
                out += self._append_for(msg.src)
            return out
        self.next_index[msg.src] = max(
            1, min(p.get("match", 0) + 1,
                   self.next_index.get(msg.src, 1) - 1))
        return self._append_for(msg.src)

    def _on_install_snapshot(self, msg: Message) -> List[Message]:
        p = msg.payload
        if p["term"] < self.term:
            return []
        self._become_follower(p["term"], leader=msg.src)
        if p["last_index"] <= self.snapshot_index:
            return []
        self.snapshot_index = p["last_index"]
        self.snapshot_term = p["last_term"]
        self.snapshot_data = p.get("data")
        cfg = p.get("config")
        if cfg:
            self.voters = set(cfg["voters"])
            self.learners = set(cfg["learners"])
            self.joint_old = (set(cfg["joint_old"])
                              if cfg.get("joint_old") is not None else None)
            self._base_config = self._config_tuple()
        self.log = []
        self.commit_index = max(self.commit_index, p["last_index"])
        self.last_applied = max(self.last_applied, p["last_index"])
        self._wal_snapshot()
        return [Message("append_resp", self.id, msg.src,
                        {"term": self.term, "success": True,
                         "match": self.snapshot_index})]

    def _on_timeout_now(self, msg: Message) -> List[Message]:
        if msg.payload.get("term", 0) < self.term:
            return []
        # immediate election, skipping pre-vote (leadership transfer)
        return self._start_election(skip_pre_vote=True)

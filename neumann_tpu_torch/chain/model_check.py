"""Bounded model checking of the sans-IO Raft core.

The reference pairs its Raft with TLA+ specs; here the deterministic
sans-IO design (raft.py) lets us model-check THE IMPLEMENTATION
directly: breadth-first exploration of every interleaving of
{tick node, deliver pending message, drop pending message} for a small
cluster, with state dedup, asserting the Raft safety invariants in
every reachable state:

  I1 election safety   — at most one leader per term
  I2 log matching      — same (index, term) implies same payload
  I3 leader completeness (observed form) — committed entries never
     diverge: one node's committed prefix never contradicts another's

This is bounded (max_states cap), so it is a falsifier, not a proof —
the same trade TLC makes with finite models. specs/TensorRaft.tla holds
the declarative spec for full TLC runs outside this image.

The port's copy of ``neumann_tpu/chain/model_check.py``:
only its import lines differ.
"""

from __future__ import annotations

import json
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from neumann_tpu_torch.chain.raft import RaftConfig, RaftNode


@dataclass
class CheckResult:
    ok: bool
    states_explored: int
    frontier_truncated: bool
    violation: Optional[str] = None
    trace: List[str] = field(default_factory=list)


def _clone_node(n: RaftNode) -> RaftNode:
    """Fast structural copy. Safe because the sans-IO core treats log
    entries and message payloads as immutable, and the model config
    pins election timeouts (min == max) so the shared RNG cannot make
    branches diverge."""
    m = RaftNode.__new__(RaftNode)
    m.__dict__ = dict(n.__dict__)
    m.log = list(n.log)
    m.voters = set(n.voters)
    m.learners = set(n.learners)
    m.joint_old = set(n.joint_old) if n.joint_old is not None else None
    m.next_index = dict(n.next_index)
    m.match_index = dict(n.match_index)
    m._votes = set(n._votes)
    m._pre_votes = set(n._pre_votes)
    return m


def _digest(nodes: Dict[str, RaftNode], pending: Tuple) -> str:
    """Canonical state fingerprint for dedup."""
    parts = []
    for nid in sorted(nodes):
        n = nodes[nid]
        parts.append((nid, n.state, n.term, n.voted_for, n.commit_index,
                      n.leader_id, n._elapsed,
                      tuple((e.term, json.dumps(e.payload, sort_keys=True))
                            for e in n.log)))
    msgs = tuple(sorted(
        (m.kind, m.src, m.dst, json.dumps(m.payload, sort_keys=True))
        for m in pending))
    return repr((parts, msgs))


def _check_invariants(nodes: Dict[str, RaftNode]) -> Optional[str]:
    # I1: at most one leader per term
    leaders: Dict[int, str] = {}
    for n in nodes.values():
        if n.state == "leader":
            if n.term in leaders:
                return (f"I1 violated: {leaders[n.term]} and {n.id} "
                        f"both lead term {n.term}")
            leaders[n.term] = n.id
    # I2: log matching on (index, term)
    by_index: Dict[Tuple[int, int], str] = {}
    for n in nodes.values():
        for i, e in enumerate(n.log):
            key = (n.snapshot_index + i + 1, e.term)
            blob = json.dumps(e.payload, sort_keys=True)
            if key in by_index and by_index[key] != blob:
                return f"I2 violated at index {key[0]} term {key[1]}"
            by_index[key] = blob
    # I3: committed prefixes agree
    ns = list(nodes.values())
    for a in ns:
        for b in ns:
            upto = min(a.commit_index, b.commit_index)
            for idx in range(1, upto + 1):
                ta, tb = a.term_at(idx), b.term_at(idx)
                if ta is not None and tb is not None and ta != tb:
                    return (f"I3 violated: commit divergence at {idx} "
                            f"({a.id}:{ta} vs {b.id}:{tb})")
    return None


def check_raft(n_nodes: int = 2, max_states: int = 20_000,
               propose_at_leader: bool = True,
               allow_drops: bool = True,
               max_pending: int = 4,
               config: Optional[RaftConfig] = None) -> CheckResult:
    """Exploration over all interleavings from a fresh cluster.

    ``max_pending`` bounds the in-flight message channel (actions that
    would emit more messages are disabled above it) — the finite-model
    bound, exactly as a TLC channel constraint."""
    cfg = config or RaftConfig(election_timeout_min=2,
                               election_timeout_max=2,
                               heartbeat_interval=1)
    ids = [f"n{i}" for i in range(n_nodes)]

    def initial():
        return ({i: RaftNode(i, ids, cfg, seed=0) for i in ids}, ())

    start = initial()
    seen = {_digest(*start)}
    frontier = deque([(*start, [])])
    explored = 0
    truncated = False

    while frontier:
        nodes, pending, trace = frontier.popleft()  # BFS: shallow first
        explored += 1
        bad = _check_invariants(nodes)
        if bad:
            return CheckResult(False, explored, truncated, bad, trace)
        if explored >= max_states:
            truncated = True
            break

        successors: List[Tuple[dict, tuple, str]] = []

        def fork(action, label):
            nn = {nid: _clone_node(n) for nid, n in nodes.items()}
            pp = list(pending)
            out = action(nn, pp)
            successors.append((nn, tuple(pp + list(out or [])), label))

        # tick each node (only while the channel has headroom)
        if len(pending) < max_pending:
            for nid in ids:
                fork(lambda nn, pp, nid=nid: nn[nid].tick(),
                     f"tick {nid}")
        # deliver each pending message
        for i in range(len(pending)):
            def deliver(nn, pp, i=i):
                msg = pp.pop(i)
                if msg.dst in nn:
                    return nn[msg.dst].handle(msg)
                return []
            fork(deliver, f"deliver {pending[i].kind} "
                          f"{pending[i].src}->{pending[i].dst}")
        # drop each pending message
        if allow_drops:
            for i in range(len(pending)):
                def drop(nn, pp, i=i):
                    pp.pop(i)
                fork(drop, f"drop {pending[i].kind}")
        # a leader may propose (limit log depth to bound the space)
        if propose_at_leader and len(pending) < max_pending:
            for nid in ids:
                if nodes[nid].state == "leader" and \
                        len(nodes[nid].log) < 3:
                    fork(lambda nn, pp, nid=nid:
                         nn[nid].propose({"v": len(nn[nid].log)}) and [],
                         f"propose@{nid}")

        for nn, pp, label in successors:
            d = _digest(nn, pp)
            if d not in seen:
                seen.add(d)
                frontier.append((nn, pp, trace + [label]))

    return CheckResult(True, explored, truncated)


# ---------------------------------------------------------------------------
# 2PC model check (executable twin of specs/TwoPhaseCommit.tla)
# ---------------------------------------------------------------------------

class _MiniStore:
    """Tiny store for model checking (real TensorStore is too heavy to
    clone per state)."""

    def __init__(self, data=None):
        self.data = dict(data or {})

    def get(self, k):
        return self.data.get(k)

    def put(self, k, v):
        self.data[k] = v

    def delete(self, k):
        return self.data.pop(k, None) is not None


def check_two_phase(n_parts: int = 2, max_states: int = 30_000,
                    allow_drops: bool = True,
                    allow_crash: bool = True,
                    max_ticks: int = 30) -> CheckResult:
    """BFS over every interleaving of one distributed tx against the
    REAL TwoPhaseCoordinator/Participant: deliver, drop, tick either
    side, coordinator crash + WAL recovery. Asserts in every state:

      A1 atomicity       — no participant committed while another
                           aborted after preparing
      A2 commit provenance — any commit implies the coordinator's
                           durable log holds 'commit'
      A3 vote soundness  — 'commit' is only logged after every
                           participant logged 'prepared'
    """
    import copy

    from neumann_tpu_torch.chain.two_phase import (
        TwoPhaseConfig,
        TwoPhaseCoordinator,
        TwoPhaseParticipant,
    )

    cfg = TwoPhaseConfig(prepare_timeout_ticks=4,
                         retry_interval_ticks=2, lock_wait_ticks=2)
    pids = [f"p{i}" for i in range(n_parts)]

    def initial():
        cwal: list = []
        pwals = {p: [] for p in pids}
        coord = TwoPhaseCoordinator("c", wal=cwal.append, config=cfg)
        parts = {p: TwoPhaseParticipant(
            p, _MiniStore(), wal=pwals[p].append, config=cfg)
            for p in pids}
        _, prepares = coord.begin({
            p: [{"op": "put", "key": f"k-{p}", "fields": {"v": 1}}]
            for p in pids})
        return coord, parts, cwal, pwals, tuple(prepares), 0, False

    def clone(state):
        coord, parts, cwal, pwals, pending, ticks, crashed = state
        cwal2 = list(cwal)
        pwals2 = {p: list(w) for p, w in pwals.items()}
        coord2 = copy.copy(coord)
        coord2._txs = copy.deepcopy(coord._txs)
        coord2._wal = cwal2.append
        from neumann_tpu_torch.chain.deadlock import DeadlockDetector
        from neumann_tpu_torch.chain.two_phase import LockManager

        parts2 = {}
        for p, part in parts.items():
            q = copy.copy(part)
            q.store = _MiniStore(part.store.data)
            # LockManager / DeadlockDetector hold thread locks, so
            # rebuild them structurally instead of deepcopying
            lm = LockManager()
            lm._owners = dict(part.locks._owners)
            q.locks = lm
            det = DeadlockDetector()
            det._edges = {k: set(v)
                          for k, v in part.detector._edges.items()}
            q.detector = det
            q._staged = {k: dict(v) for k, v in part._staged.items()}
            q._ops = {k: list(v) for k, v in part._ops.items()}
            q._waiting = {k: copy.copy(v)
                          for k, v in part._waiting.items()}
            q._decided = dict(part._decided)
            q._wal = pwals2[p].append
            parts2[p] = q
        return coord2, parts2, cwal2, pwals2, pending, ticks, crashed

    def digest(state):
        coord, parts, cwal, pwals, pending, ticks, crashed = state
        c = tuple(sorted((t, tx.state, tuple(sorted(tx.prepared)),
                          tuple(sorted(tx.acked)))
                         for t, tx in coord._txs.items()))
        ps = tuple(
            (p, tuple(sorted(part.store.data)),
             tuple(sorted(part._ops)), tuple(sorted(part._waiting)),
             tuple(sorted(part._decided.items())),
             tuple(sorted(part.locks._owners.items())))
            for p, part in sorted(parts.items()))
        ms = tuple(sorted((m.kind, m.src, m.dst,
                           json.dumps(m.payload, sort_keys=True))
                          for m in pending))
        return repr((c, ps, ms, tuple(len(w) for w in pwals.values()),
                     len(cwal), ticks, crashed))

    def outcome_of(wal):
        out = None
        for rec in wal:
            if rec.get("phase") == "committed":
                out = "committed"
            elif rec.get("phase") == "aborted":
                out = "aborted"
        return out

    def invariants(state):
        coord, parts, cwal, pwals, pending, ticks, crashed = state
        outs = {p: outcome_of(pwals[p]) for p in pids}
        if "committed" in outs.values() and "aborted" in outs.values():
            # aborted AFTER voting yes (vote_no-then-abort is fine)
            for p, o in outs.items():
                if o == "aborted" and any(
                        r.get("phase") == "prepared"
                        for r in pwals[p]) and \
                        "committed" in outs.values():
                    return f"A1: {outs}"
        clog = [r.get("phase") for r in cwal
                if r.get("phase") in ("commit", "abort")]
        if "committed" in outs.values() and "commit" not in clog:
            return "A2: participant committed without a commit record"
        if "commit" in clog:
            for p in pids:
                if not any(r.get("phase") == "prepared"
                           for r in pwals[p]):
                    return f"A3: commit logged but {p} never prepared"
        return None

    start = initial()
    seen = {digest(start)}
    frontier = deque([(start, [])])
    explored = 0
    truncated = False
    while frontier:
        state, trace = frontier.popleft()
        explored += 1
        bad = invariants(state)
        if bad:
            return CheckResult(False, explored, truncated, bad, trace)
        if explored >= max_states:
            truncated = True
            break
        coord, parts, cwal, pwals, pending, ticks, crashed = state
        succ = []

        def fork(action, label):
            st = clone(state)
            c2, p2, cw2, pw2, pend2, t2, cr2 = st
            pend2 = list(pend2)
            out = action(c2, p2, pend2, cw2) or []
            succ.append(((c2, p2, cw2, pw2,
                          tuple(pend2 + list(out)), t2, cr2), label))

        for i in range(len(pending)):
            def deliver(c2, p2, pend2, cw2, i=i):
                m = pend2.pop(i)
                if m.dst == "c":
                    return c2.handle(m)
                if m.dst in p2:
                    return p2[m.dst].handle(m)
                return []
            fork(deliver, f"deliver {pending[i].kind}->"
                          f"{pending[i].dst}")
        if allow_drops:
            for i in range(len(pending)):
                def drop(c2, p2, pend2, cw2, i=i):
                    pend2.pop(i)
                fork(drop, f"drop {pending[i].kind}")
        if ticks < max_ticks:
            def tickc(c2, p2, pend2, cw2):
                return c2.tick()
            fork(lambda c2, p2, pend2, cw2: c2.tick(), "tick c")
            for p in pids:
                fork(lambda c2, p2, pend2, cw2, p=p: p2[p].tick(),
                     f"tick {p}")
            # ticks bound is enforced via the tick counter in digest
            succ = [((c, pr, cw, pw, pe, t + 1, cr), lb)
                    if lb.startswith("tick") else ((c, pr, cw, pw, pe,
                                                    t, cr), lb)
                    for ((c, pr, cw, pw, pe, t, cr), lb) in succ]
        if allow_crash and not crashed:
            def crash_recover(c2, p2, pend2, cw2):
                from neumann_tpu_torch.chain.two_phase import (
                    TwoPhaseCoordinator as C,
                )

                c3 = C("c", wal=cw2.append, config=cfg)
                out = c3.recover(list(cw2))
                c2._txs = c3._txs
                c2._seq = c3._seq
                c2._tick = c3._tick
                return out
            st = clone(state)
            c2, p2, cw2, pw2, pend2, t2, _ = st
            pend2 = list(pend2)  # crash loses nothing in flight here;
            out = crash_recover(c2, p2, pend2, cw2)
            succ.append(((c2, p2, cw2, pw2, tuple(pend2 + out), t2,
                          True), "crash+recover c"))

        for st, label in succ:
            d = digest(st)
            if d not in seen:
                seen.add(d)
                frontier.append((st, trace + [label]))
    return CheckResult(True, explored, truncated)


# ---------------------------------------------------------------------------
# membership model check (executable twin of specs/Membership.tla)
# ---------------------------------------------------------------------------

def check_membership(n_nodes: int = 3, max_states: int = 20_000,
                     max_ticks: int = 8) -> CheckResult:
    """BFS over gossip interleavings against the REAL GossipNode:
    tick / deliver / drop. Asserts in every state:

      M1 self-alive             — a node never believes itself
                                  suspect/faulty
      M2 incarnation authority  — no view attributes a peer a higher
                                  incarnation than the peer's own
    """
    import copy

    from neumann_tpu_torch.chain.gossip import ALIVE, GossipConfig, GossipNode

    ids = [f"n{i}" for i in range(n_nodes)]
    cfg = GossipConfig(probe_interval=2, ack_timeout=1,
                       suspect_timeout=2, indirect_probes=1)

    def initial():
        return ({i: GossipNode(i, ids, cfg, seed=0) for i in ids}, ())

    def clone(nodes):
        out = {}
        for nid, g in nodes.items():
            h = copy.copy(g)
            h.members = {p: copy.copy(m) for p, m in g.members.items()}
            h._awaiting_ack = dict(g._awaiting_ack)
            h._suspect_since = dict(g._suspect_since)
            h._rng = copy.deepcopy(g._rng)
            out[nid] = h
        return out

    def digest(nodes, pending):
        parts = tuple(
            (nid, g.incarnation, g._tick,
             tuple(sorted((p, m.status, m.incarnation)
                          for p, m in g.members.items())),
             tuple(sorted(g._awaiting_ack.items())))
            for nid, g in sorted(nodes.items()))
        ms = tuple(sorted((m.kind, m.src, m.dst,
                           json.dumps(m.payload, sort_keys=True))
                          for m in pending))
        return repr((parts, ms))

    def invariants(nodes):
        from neumann_tpu_torch.chain.gossip import ALIVE

        for nid, g in nodes.items():
            if g.members[nid].status != ALIVE:
                return f"M1: {nid} believes itself {g.members[nid].status}"
        for nid, g in nodes.items():
            for p, m in g.members.items():
                if p in nodes and m.incarnation > nodes[p].incarnation:
                    return (f"M2: {nid} attributes {p} incarnation "
                            f"{m.incarnation} > own "
                            f"{nodes[p].incarnation}")
        return None

    start = initial()
    seen = {digest(*start)}
    frontier = deque([(*start, [])])
    explored = 0
    truncated = False
    while frontier:
        nodes, pending, trace = frontier.popleft()
        explored += 1
        bad = invariants(nodes)
        if bad:
            return CheckResult(False, explored, truncated, bad, trace)
        if explored >= max_states:
            truncated = True
            break
        succ = []

        def fork(action, label):
            nn = clone(nodes)
            pp = list(pending)
            out = action(nn, pp) or []
            succ.append((nn, tuple(pp + list(out)), label))

        for nid in ids:
            if nodes[nid]._tick < max_ticks:
                fork(lambda nn, pp, nid=nid: nn[nid].tick(),
                     f"tick {nid}")
        for i in range(len(pending)):
            def deliver(nn, pp, i=i):
                m = pp.pop(i)
                if m.dst in nn:
                    return nn[m.dst].handle(m)
                return []
            fork(deliver, f"deliver {pending[i].kind}")
            def drop(nn, pp, i=i):
                pp.pop(i)
            fork(drop, f"drop {pending[i].kind}")

        for nn, pp, label in succ:
            d = digest(nn, pp)
            if d not in seen:
                seen.add(d)
                frontier.append((nn, pp, trace + [label]))
    return CheckResult(True, explored, truncated)

"""Two-phase commit for cross-shard transactions.

Parity with tensor_chain/src/distributed_tx.rs capability: coordinator +
participant state machines, a per-key lock manager with deadlock-aware
lock WAITS, presumed-abort coordinator timeouts with retried decision
broadcasts, redo-logged commit application, and tx WAL recovery on both
sides. Sans-IO like RaftNode: both ends consume Messages and emit
Messages; `tick()` advances logical time (timeouts, retries, lock-wait
progress).

Crash matrix covered (see tests/test_two_phase_hardening.py):
- coordinator crash between prepare and commit -> recovery presumes
  abort, re-broadcasts tx_abort until every participant acks
  (distributed_tx.rs abort broadcast w/ retry);
- coordinator crash after logging commit -> recovery re-broadcasts
  tx_commit (participants are idempotent);
- participant crash mid-commit-application -> the redo record
  ("committing") replays the ops on recovery;
- participant crash while prepared -> locks re-acquired, outcome asked
  of the coordinator (tx_wal.rs recovery).

The port's copy of ``neumann_tpu/chain/two_phase.py``:
only its import lines differ.
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from neumann_tpu_torch.chain.deadlock import DeadlockDetector
from neumann_tpu_torch.chain.transport import Message
from neumann_tpu_torch.utils.errors import ChainError

PREPARING = "preparing"
PREPARED = "prepared"
COMMITTED = "committed"
ABORTED = "aborted"


@dataclass
class TwoPhaseConfig:
    prepare_timeout_ticks: int = 20   # coordinator: presumed abort
    retry_interval_ticks: int = 5     # decision re-broadcast cadence
    lock_wait_ticks: int = 10         # participant: max wait for locks


class LockManager:
    """Per-key exclusive locks with owner tracking (deadlock detection
    plugs in via wait edges)."""

    def __init__(self):
        self._owners: Dict[str, str] = {}
        self._lock = threading.Lock()

    def try_lock(self, key: str, owner: str) -> bool:
        with self._lock:
            cur = self._owners.get(key)
            if cur is None or cur == owner:
                self._owners[key] = owner
                return True
            return False

    def owner_of(self, key: str) -> Optional[str]:
        with self._lock:
            return self._owners.get(key)

    def release_all(self, owner: str) -> int:
        with self._lock:
            doomed = [k for k, o in self._owners.items() if o == owner]
            for k in doomed:
                del self._owners[k]
            return len(doomed)


@dataclass
class _CoordTx:
    tx_id: str
    participants: Set[str]
    prepared: Set[str] = field(default_factory=set)
    acked: Set[str] = field(default_factory=set)
    state: str = PREPARING
    ops: Dict[str, list] = field(default_factory=dict)  # node -> ops
    deadline: int = 0
    last_send: int = 0


class TwoPhaseCoordinator:
    def __init__(self, node_id: str,
                 wal: Optional[Callable[[dict], None]] = None,
                 config: Optional[TwoPhaseConfig] = None):
        self.id = node_id
        self.config = config or TwoPhaseConfig()
        self._txs: Dict[str, _CoordTx] = {}
        self._seq = itertools.count(1)
        self._wal = wal
        self._tick = 0

    def _log(self, record: dict) -> None:
        if self._wal:
            self._wal(record)

    def begin(self, ops_by_node: Dict[str, list]) -> tuple:
        """Start a distributed tx; returns (tx_id, outbound prepares)."""
        tx_id = f"{self.id}-tx{next(self._seq)}"
        tx = _CoordTx(tx_id, set(ops_by_node), ops=dict(ops_by_node),
                      deadline=self._tick
                      + self.config.prepare_timeout_ticks,
                      last_send=self._tick)
        self._txs[tx_id] = tx
        self._log({"phase": "begin", "tx": tx_id,
                   "participants": sorted(tx.participants)})
        return tx_id, [
            Message("tx_prepare", self.id, node,
                    {"tx": tx_id, "ops": ops})
            for node, ops in ops_by_node.items()]

    def _decision_msgs(self, tx: _CoordTx) -> List[Message]:
        kind = "tx_commit" if tx.state == COMMITTED else "tx_abort"
        tx.last_send = self._tick
        return [Message(kind, self.id, p, {"tx": tx.tx_id})
                for p in tx.participants - tx.acked]

    def tick(self) -> List[Message]:
        """Advance one logical tick: presumed-abort timeouts + decision
        re-broadcast to participants that have not acked."""
        self._tick += 1
        out: List[Message] = []
        for tx in self._txs.values():
            if tx.state == PREPARING and self._tick >= tx.deadline:
                # presumed abort: a coordinator that cannot collect all
                # votes in time aborts — never blocks the cluster
                tx.state = ABORTED
                self._log({"phase": "abort", "tx": tx.tx_id,
                           "reason": "timeout"})
                out += self._decision_msgs(tx)
            elif tx.state in (COMMITTED, ABORTED) and \
                    tx.acked != tx.participants and \
                    self._tick - tx.last_send >= \
                    self.config.retry_interval_ticks:
                out += self._decision_msgs(tx)
        return out

    def handle(self, msg: Message) -> List[Message]:
        tx = self._txs.get(msg.payload.get("tx", ""))
        if tx is None:
            return []
        if msg.kind == "tx_vote":
            if tx.state != PREPARING:
                return []
            if not msg.payload.get("ok"):
                tx.state = ABORTED
                self._log({"phase": "abort", "tx": tx.tx_id})
                return self._decision_msgs(tx)
            tx.prepared.add(msg.src)
            if tx.prepared == tx.participants:
                tx.state = COMMITTED
                self._log({"phase": "commit", "tx": tx.tx_id})
                return self._decision_msgs(tx)
        elif msg.kind == "tx_ack":
            tx.acked.add(msg.src)
        return []

    def recover(self, records: List[dict]) -> List[Message]:
        """Rebuild from replayed coordinator WAL records after a crash.

        Decided txs re-broadcast their decision (participants are
        idempotent; acks were volatile). Undecided txs (begin without
        commit/abort) are PRESUMED ABORTED — the classic rule: a
        coordinator that crashed before logging commit must abort.
        """
        states: Dict[str, _CoordTx] = {}
        for rec in records:
            txid = rec.get("tx")
            phase = rec.get("phase")
            if phase == "begin":
                states[txid] = _CoordTx(
                    txid, set(rec.get("participants", [])))
            elif phase == "commit" and txid in states:
                states[txid].state = COMMITTED
            elif phase == "abort" and txid in states:
                states[txid].state = ABORTED
        out: List[Message] = []
        for txid, tx in states.items():
            self._txs[txid] = tx
            if tx.state == PREPARING:
                tx.state = ABORTED
                self._log({"phase": "abort", "tx": txid,
                           "reason": "recovery-presumed-abort"})
            out += self._decision_msgs(tx)
        # keep tx ids monotonic past anything recovered
        mx = 0
        for txid in states:
            try:
                mx = max(mx, int(txid.rsplit("tx", 1)[1]))
            except (IndexError, ValueError):
                pass
        self._seq = itertools.count(mx + 1)
        return out

    def state_of(self, tx_id: str) -> Optional[str]:
        tx = self._txs.get(tx_id)
        return tx.state if tx else None

    def abort(self, tx_id: str) -> List[Message]:
        tx = self._txs.get(tx_id)
        if tx is None or tx.state in (COMMITTED,):
            raise ChainError(f"cannot abort tx {tx_id}")
        tx.state = ABORTED
        self._log({"phase": "abort", "tx": tx_id})
        return self._decision_msgs(tx)

    def pending(self) -> List[str]:
        return [t for t, tx in self._txs.items()
                if tx.state == PREPARING]


@dataclass
class _Waiting:
    ops: list
    src: str
    deadline: int


class TwoPhaseParticipant:
    """Applies ops to a local store under locks.

    Lock conflicts WAIT (up to lock_wait_ticks) with wait-for edges
    registered in the deadlock detector; a detected cycle votes the
    victim (youngest tx) off immediately. Commit application is
    redo-logged: the "committing" record replays on crash recovery.
    """

    def __init__(self, node_id: str, store,
                 locks: Optional[LockManager] = None,
                 wal: Optional[Callable[[dict], None]] = None,
                 detector: Optional[DeadlockDetector] = None,
                 config: Optional[TwoPhaseConfig] = None):
        self.id = node_id
        self.store = store
        self.locks = locks or LockManager()
        self.detector = detector or DeadlockDetector()
        self.config = config or TwoPhaseConfig()
        self._staged: Dict[str, dict] = {}   # tx -> {} (prepared mark)
        self._ops: Dict[str, list] = {}
        self._waiting: Dict[str, _Waiting] = {}
        # decided txs: a prepare that arrives AFTER its tx's decision
        # (message reordering) must not re-acquire locks forever
        self._decided: Dict[str, str] = {}
        self._wal = wal
        self._tick = 0

    def _log(self, record: dict) -> None:
        if self._wal:
            self._wal(record)

    # -- lock acquisition with deadlock awareness --------------------------
    def _try_acquire(self, tx: str, ops: list) -> Optional[str]:
        """All-or-nothing lock grab; returns a blocking owner or None."""
        acquired = []
        for op in ops:
            k = op["key"]
            if self.locks.try_lock(k, tx):
                acquired.append(k)
            else:
                holder = self.locks.owner_of(k)
                # release only OUR locks (keys owned by others stay)
                self.locks.release_all(tx)
                return holder or "?"
        return None

    def _vote(self, tx: str, src: str, ok: bool) -> Message:
        if ok:
            self._log({"phase": "prepared", "tx": tx,
                       "ops": len(self._ops[tx]),
                       "ops_list": self._ops[tx]})
        else:
            self._log({"phase": "vote_no", "tx": tx})
        return Message("tx_vote", self.id, src, {"tx": tx, "ok": ok})

    def handle(self, msg: Message) -> List[Message]:
        tx = msg.payload.get("tx", "")
        if msg.kind == "tx_prepare":
            if tx in self._decided:
                # late prepare for an already-decided tx: never lock
                return [Message("tx_vote", self.id, msg.src,
                                {"tx": tx, "ok": False})]
            ops = msg.payload.get("ops", [])
            holder = self._try_acquire(tx, ops)
            if holder is None:
                self._ops[tx] = ops
                self._staged[tx] = {}
                return [self._vote(tx, msg.src, True)]
            # conflict: wait with a wait-for edge instead of refusing
            self.detector.add_wait(tx, holder)
            self._waiting[tx] = _Waiting(
                ops, msg.src,
                self._tick + self.config.lock_wait_ticks)
            cycle = self.detector.find_cycle()
            if cycle and self.detector.victim() == tx:
                # we are the deadlock victim: refuse now
                return self._give_up(tx)
            return []
        if msg.kind == "tx_commit":
            ops = self._ops.pop(tx, [])
            if ops:
                # redo log BEFORE mutating: a crash mid-application
                # replays these ops on recovery (use-the-log, not a
                # dead undo capture)
                self._log({"phase": "committing", "tx": tx,
                           "ops_list": ops})
                self._apply(ops)
            self._staged.pop(tx, None)
            self._drop_wait(tx)
            self.locks.release_all(tx)
            self._decided[tx] = COMMITTED
            self._log({"phase": "committed", "tx": tx})
            return ([Message("tx_ack", self.id, msg.src, {"tx": tx})]
                    + self._retry_waiters())
        if msg.kind == "tx_abort":
            self._ops.pop(tx, None)
            self._staged.pop(tx, None)
            self._drop_wait(tx)
            self.locks.release_all(tx)
            self._decided[tx] = ABORTED
            self._log({"phase": "aborted", "tx": tx})
            return ([Message("tx_ack", self.id, msg.src, {"tx": tx})]
                    + self._retry_waiters())
        return []

    def tick(self) -> List[Message]:
        """Advance lock waits: timed-out waiters vote no; freed locks
        let waiters proceed; deadlock victims are refused."""
        self._tick += 1
        return self._retry_waiters()

    def _retry_waiters(self) -> List[Message]:
        out: List[Message] = []
        for tx in list(self._waiting):
            w = self._waiting[tx]
            holder = self._try_acquire(tx, w.ops)
            if holder is None:
                self.detector.remove_waiter(tx)
                del self._waiting[tx]
                self._ops[tx] = w.ops
                self._staged[tx] = {}
                out.append(self._vote(tx, w.src, True))
                continue
            self.detector.add_wait(tx, holder)
            cycle = self.detector.find_cycle()
            if (cycle and self.detector.victim() == tx) or \
                    self._tick >= w.deadline:
                out += self._give_up(tx)
        return out

    def _give_up(self, tx: str) -> List[Message]:
        w = self._waiting.pop(tx)
        self.detector.remove_waiter(tx)
        self.locks.release_all(tx)
        return [self._vote(tx, w.src, False)]

    def _drop_wait(self, tx: str) -> None:
        self._waiting.pop(tx, None)
        self.detector.remove_waiter(tx)

    def _apply(self, ops: list) -> None:
        from neumann_tpu_torch.store.tensor_store import TensorData, \
            TensorValue

        for op in ops:
            key = op["key"]
            if op["op"] == "put":
                td = TensorData()
                for fname, fval in op.get("fields", {}).items():
                    td.set(fname, TensorValue.scalar(fval))
                self.store.put(key, td)
            elif op["op"] == "delete":
                self.store.delete(key)

    def recover(self, records: List[dict],
                coordinator_states: Optional[Dict[str, str]] = None
                ) -> List[str]:
        """Rebuild in-doubt state from replayed tx WAL records.

        "committing" without "committed" replays the redo ops (crash
        mid-application). Prepared-but-unresolved transactions
        re-acquire their locks (so conflicting work stays blocked) and
        are returned so the caller can ask the coordinator for the
        outcome; if `coordinator_states` resolves one, it is settled
        immediately. Parity with tx_wal.rs recovery.
        """
        in_doubt: Dict[str, List[dict]] = {}
        committing: Dict[str, List[dict]] = {}
        for rec in records:
            tx = rec.get("tx")
            phase = rec.get("phase")
            if phase == "prepared":
                in_doubt[tx] = rec.get("ops_list", [])
            elif phase == "committing":
                committing[tx] = rec.get("ops_list", [])
                in_doubt.pop(tx, None)
            elif phase in ("committed", "aborted", "vote_no"):
                in_doubt.pop(tx, None)
                committing.pop(tx, None)
                if phase != "vote_no":
                    self._decided[tx] = (COMMITTED
                                         if phase == "committed"
                                         else ABORTED)
        # redo: crashed after deciding to apply, before finishing
        for tx, ops in committing.items():
            self._apply(ops)
            self.locks.release_all(tx)
            self._log({"phase": "committed", "tx": tx})
        unresolved = []
        for tx, ops in in_doubt.items():
            outcome = (coordinator_states or {}).get(tx)
            if outcome == "committed":
                self._ops[tx] = ops
                for op in ops:
                    self.locks.try_lock(op["key"], tx)
                self.handle(Message("tx_commit", "recovery", self.id,
                                    {"tx": tx}))
            elif outcome == "aborted":
                self._log({"phase": "aborted", "tx": tx})
            else:
                # stay prepared: hold locks until the coordinator answers
                self._ops[tx] = ops
                self._staged[tx] = {}
                for op in ops:
                    self.locks.try_lock(op["key"], tx)
                unresolved.append(tx)
        return unresolved

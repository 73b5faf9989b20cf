"""Linearizability checking for register histories.

Parity with the reference's checker (integration_tests/src/
linearizability.rs, 707 LoC): given a history of operations with
invoke/complete timestamps over a single register, decide whether some
linearization — a total order consistent with real-time precedence and
register semantics — exists. Wing & Gong depth-first search with
memoization on (linearized-set, register-value), which is exact and fast
for the history sizes chaos tests produce.

The port's copy of ``neumann_tpu/chain/linearizability.py``:
only its import lines differ.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Set, Tuple


@dataclass(frozen=True)
class Op:
    client: str
    kind: str               # "write" | "read" | "cas"
    # write: the value written; read: the value observed;
    # cas: (expected, new, succeeded) — succeeded is what the client
    # was told, and must match whether the register held `expected`
    # at the linearization point (linearizability.rs OpType::Cas)
    value: object
    invoke: float
    complete: float
    key: str = "r"          # register name (KV histories: check_kv)

    def __post_init__(self):
        if self.complete < self.invoke:
            raise ValueError("complete before invoke")


@dataclass
class CheckResult:
    ok: bool
    reason: str = ""
    order: Optional[List[Op]] = None


def check_register(history: List[Op],
                   initial=None) -> CheckResult:
    """Search for a valid linearization of a single-register history."""
    if not history:
        return CheckResult(True, "empty history")
    ops = sorted(history, key=lambda o: o.invoke)

    # Sound reduction: a WRITE whose value no read ever observes and
    # that no operation real-time-follows (typically an indeterminate
    # complete=inf write from a partition era) can always be linearized
    # at the very end — writes are legal at any value, nothing is
    # ordered after it, and since it is unobserved it never sits
    # immediately before a read in any valid order. Dropping these is
    # equivalence-preserving and removes the main source of
    # exponential concurrency in chaos histories.
    # CAS disables the reduction entirely: a failed CAS(expected=e)
    # may NEED some unobserved write as the intermediate value that
    # makes value != e at its linearization point, so dropping one
    # produces false alarms (caught by the differential fuzzer,
    # tests/test_fuzz_targets7.py).
    observed = {op.value for op in ops if op.kind == "read"}
    has_cas = any(op.kind == "cas" for op in ops)
    tail: List[Op] = []
    kept: List[Op] = []
    for op in ops:
        if not has_cas and op.kind == "write" and \
                op.value not in observed and \
                not any(o is not op and op.complete < o.invoke
                        for o in ops):
            tail.append(op)
        else:
            kept.append(op)
    ops = kept
    n = len(ops)
    if n == 0:
        return CheckResult(True, "linearizable", tail)
    # Wing & Gong DFS with the standard performance structure: the
    # real-time precedence relation (a.complete < b.invoke) is an
    # INTERVAL ORDER, so successor lists are precomputed once, the
    # frontier of minimal pending ops is maintained incrementally via
    # in-degree counters, and the linearized set is a bitmask (O(1)
    # hash) rather than a frozenset. Memo key: (mask, register value).
    succs: List[List[int]] = [[] for _ in range(n)]
    npred = [0] * n
    for j, a in enumerate(ops):
        for i, b in enumerate(ops):
            if i != j and a.complete < b.invoke:
                succs[j].append(i)
                npred[i] += 1

    seen: Set[Tuple[int, object]] = set()
    order: List[Op] = []
    done_flag = [False] * n

    def dfs(mask: int, value) -> bool:
        if mask == (1 << n) - 1:
            return True
        key = (mask, value)
        if key in seen:
            return False
        seen.add(key)
        frontier = [i for i in range(n)
                    if not done_flag[i] and npred[i] == 0]
        # matching reads first: a read never changes the register, so
        # linearizing it is always "free" — write-first descents walk
        # straight into subtrees where stranded same-value reads can no
        # longer be placed (the classic blowup on stall-era histories)
        frontier.sort(key=lambda i: ops[i].kind != "read")
        for i in frontier:
            op = ops[i]
            if op.kind == "read":
                if op.value != value:
                    continue
                nxt = value
            elif op.kind == "cas":
                exp, new, succeeded = op.value
                if succeeded != (value == exp):
                    continue
                nxt = new if succeeded else value
            else:
                nxt = op.value
            done_flag[i] = True
            for s in succs[i]:
                npred[s] -= 1
            order.append(op)
            if dfs(mask | (1 << i), nxt):
                return True
            order.pop()
            for s in succs[i]:
                npred[s] += 1
            done_flag[i] = False
        return False

    if dfs(0, initial):
        return CheckResult(True, "linearizable", list(order) + tail)
    return CheckResult(False,
                       f"no valid linearization for {n} operations")


def check_kv(history: List[Op], initial=None) -> CheckResult:
    """Multi-key histories (the reference checker's HashMap model,
    linearizability.rs KvModel): linearizability is LOCAL — a history
    is linearizable iff its per-key subhistories each are — so the
    check partitions by ``Op.key`` and runs the register search per
    key. Returns the first failing key's result; on success, the
    concatenated per-key witness orders."""
    by_key: dict = {}
    for op in history:
        by_key.setdefault(op.key, []).append(op)
    full_order: List[Op] = []
    for key in sorted(by_key):
        res = check_register(by_key[key], initial)
        if not res.ok:
            return CheckResult(False, f"key {key!r}: {res.reason}")
        full_order += res.order or []
    return CheckResult(True, "linearizable", full_order)

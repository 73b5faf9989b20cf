"""Lock-order race detection.

The reference verifies lock discipline with loom's model checking; the
Python equivalent here is a runtime lock-ORDER tracker: every wrapped
lock acquisition records "held -> acquiring" edges in a global order
graph, and any cycle (A taken while holding B on one thread, B taken
while holding A on another) is a potential deadlock — reported with
both acquisition stacks even if the timing never actually deadlocked
in this run. Used by the concurrency stress tests
(tests/test_stress.py) and available standalone:

    with lock_order_tracking() as tracker:
        ... exercise the engines from many threads ...
    assert not tracker.violations()

The port's copy of ``neumann_tpu/utils/lockcheck.py``: besides its
imports, ``lock_order_tracking`` tracks the locks created in the port's
package (``only_module="neumann_tpu_torch"``) by default.
"""

from __future__ import annotations

import threading
import traceback
from contextlib import contextmanager
from typing import Dict, List, Tuple

_local = threading.local()


class LockOrderTracker:
    def __init__(self):
        # directed edges: (held_name, acquired_name) -> sample stack
        self.edges: Dict[Tuple[str, str], str] = {}
        self._lock = threading.Lock()
        self._violations: List[dict] = []

    def _held(self) -> List[str]:
        if not hasattr(_local, "held"):
            _local.held = []
        return _local.held

    def on_acquire(self, name: str) -> None:
        held = self._held()
        if held:
            stack = "".join(traceback.format_stack(limit=8)[:-2])
            with self._lock:
                for h in held:
                    if h == name:
                        continue  # re-entrant
                    edge = (h, name)
                    rev = (name, h)
                    if rev in self.edges and edge not in self.edges:
                        self._violations.append({
                            "order_a": edge, "order_b": rev,
                            "stack_a": stack,
                            "stack_b": self.edges[rev]})
                    self.edges.setdefault(edge, stack)
        held.append(name)

    def on_release(self, name: str) -> None:
        held = self._held()
        # release the most recent matching entry (re-entrant safe)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def violations(self) -> List[dict]:
        with self._lock:
            return list(self._violations)

    def report(self) -> str:
        out = []
        for v in self.violations():
            a, b = v["order_a"], v["order_b"]
            out.append(
                f"lock-order inversion: {a[0]} -> {a[1]} vs "
                f"{b[0]} -> {b[1]}\n  first order at:\n{v['stack_b']}"
                f"  reversed at:\n{v['stack_a']}")
        return "\n".join(out) or "no lock-order inversions"


class TrackedLock:
    """Wraps a threading.Lock/RLock, reporting to a tracker."""

    def __init__(self, inner, name: str, tracker: LockOrderTracker):
        self._inner = inner
        self._name = name
        self._tracker = tracker

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got:
            self._tracker.on_acquire(self._name)
        return got

    def release(self):
        self._tracker.on_release(self._name)
        return self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()

    def locked(self):
        return self._inner.locked()


def _creation_site(depth: int = 3) -> str:
    import sys

    frame = sys._getframe(depth)
    return f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:" \
           f"{frame.f_lineno}"


@contextmanager
def lock_order_tracking(only_module: str = "neumann_tpu_torch"):
    """Patch threading.Lock/RLock so every lock CREATED inside the
    target package while active is order-tracked. Locks are named by
    creation site, so all instances created at one line share an order
    class — exactly the granularity deadlock analysis needs."""
    tracker = LockOrderTracker()
    real_lock, real_rlock = threading.Lock, threading.RLock

    def make(factory):
        def ctor():
            import sys

            frame = sys._getframe(1)
            fn = frame.f_code.co_filename
            inner = factory()
            if only_module and only_module not in fn:
                return inner
            name = f"{fn.rsplit('/', 1)[-1]}:{frame.f_lineno}"
            return TrackedLock(inner, name, tracker)
        return ctor

    threading.Lock = make(real_lock)
    threading.RLock = make(real_rlock)
    try:
        yield tracker
    finally:
        threading.Lock = real_lock
        threading.RLock = real_rlock

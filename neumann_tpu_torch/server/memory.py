"""Server memory budget: accounting + load shedding.

Parity with neumann_server/src/memory.rs (MemoryBudgetConfig,
MemoryTracker): a byte budget tracked with atomic-style accounting;
when load shedding is enabled, allocations over budget are refused and
the request layer surfaces RESOURCE_EXHAUSTED. With shedding disabled
the tracker still accounts usage for observability.

The port's copy of ``neumann_tpu/server/memory.py``, unchanged.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass


@dataclass
class MemoryBudgetConfig:
    max_bytes: int = 1 << 30
    load_shedding: bool = True


class MemoryTracker:
    def __init__(self, config: MemoryBudgetConfig | None = None):
        self.config = config or MemoryBudgetConfig()
        self._used = 0
        self._peak = 0
        self._shed = 0
        self._lock = threading.Lock()

    def try_allocate(self, nbytes: int) -> bool:
        """Reserve bytes. False only when shedding is on and the budget
        would be exceeded; otherwise usage is tracked regardless."""
        with self._lock:
            if (self.config.load_shedding
                    and self._used + nbytes > self.config.max_bytes):
                self._shed += 1
                return False
            self._used += nbytes
            self._peak = max(self._peak, self._used)
            return True

    def release(self, nbytes: int) -> None:
        with self._lock:
            self._used = max(0, self._used - nbytes)

    def current_usage(self) -> int:
        with self._lock:
            return self._used

    def remaining(self) -> int:
        with self._lock:
            return max(0, self.config.max_bytes - self._used)

    def is_over_budget(self) -> bool:
        with self._lock:
            return self._used > self.config.max_bytes

    def stats(self) -> dict:
        with self._lock:
            return {"used": self._used, "peak": self._peak,
                    "max": self.config.max_bytes,
                    "shed_requests": self._shed,
                    "load_shedding": self.config.load_shedding}


class Reservation:
    """Context manager: shed the request if the budget refuses it."""

    def __init__(self, tracker: MemoryTracker, nbytes: int):
        self.tracker = tracker
        self.nbytes = nbytes
        self.ok = False

    def __enter__(self):
        self.ok = self.tracker.try_allocate(self.nbytes)
        return self

    def __exit__(self, *exc):
        if self.ok:
            self.tracker.release(self.nbytes)
        return False

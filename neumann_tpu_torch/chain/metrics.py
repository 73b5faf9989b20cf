"""Chain observability: timing stats + operation counters.

Parity with tensor_chain/src/metrics.rs (TimingStats with count /
total / min / max per category, snapshot/reset). Python's GIL makes a
plain lock the atomic — the shape and API mirror the reference's.

The port's copy of ``neumann_tpu/chain/metrics.py``:
only its import lines differ.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict


class TimingStats:
    """count / total / min / max for one operation category."""

    __slots__ = ("_lock", "count", "total_us", "min_us", "max_us")

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.total_us = 0
        self.min_us = None
        self.max_us = 0

    def record(self, duration_us: float) -> None:
        us = int(duration_us)
        with self._lock:
            self.count += 1
            self.total_us += us
            self.max_us = max(self.max_us, us)
            self.min_us = us if self.min_us is None \
                else min(self.min_us, us)

    def timed(self):
        """Context manager recording the block's wall time."""
        return _Timed(self)

    @property
    def avg_us(self) -> float:
        return self.total_us / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"count": self.count, "total_us": self.total_us,
                    "avg_us": self.avg_us,
                    "min_us": self.min_us or 0, "max_us": self.max_us}

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.total_us = 0
            self.min_us = None
            self.max_us = 0


class _Timed:
    __slots__ = ("_stats", "_t0")

    def __init__(self, stats: TimingStats):
        self._stats = stats

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._stats.record((time.perf_counter() - self._t0) * 1e6)
        return False


@dataclass
class ChainMetrics:
    """Counters + timings for the transaction/commit path
    (metrics.rs ChainMetrics role)."""

    commit: TimingStats = field(default_factory=TimingStats)
    conflict_check: TimingStats = field(default_factory=TimingStats)
    commits: int = 0
    rollbacks: int = 0
    conflicts_rejected: int = 0
    auto_merges: int = 0
    blocks: int = 0

    def snapshot(self) -> dict:
        return {
            "commits": self.commits,
            "rollbacks": self.rollbacks,
            "conflicts_rejected": self.conflicts_rejected,
            "auto_merges": self.auto_merges,
            "blocks": self.blocks,
            "commit_timing": self.commit.snapshot(),
            "conflict_check_timing": self.conflict_check.snapshot(),
        }

    def reset(self) -> None:
        self.commit.reset()
        self.conflict_check.reset()
        self.commits = self.rollbacks = 0
        self.conflicts_rejected = self.auto_merges = self.blocks = 0

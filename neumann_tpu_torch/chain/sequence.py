"""Bounded-memory replay detection for signed control messages.

Parity with tensor_chain/src/signing.rs:371-470 (SequenceTrackerConfig +
SequenceTracker): each sender's last-seen sequence number is tracked;
non-increasing sequences are rejected as replays, stale entries age out,
and the tracked-sender set is bounded so an attacker minting sender ids
cannot grow host memory (signing.rs check_and_record capacity path).

The port's copy of ``neumann_tpu/chain/sequence.py``:
only its import lines differ.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

_FUTURE_SKEW_MS = 60_000        # allow 1 minute of clock skew


@dataclass
class SequenceTrackerConfig:
    max_age_ms: int = 300_000           # 5 minutes
    max_entries: int = 10_000
    cleanup_interval: int = 100         # cleanup every N checks


class SequenceTracker:
    """Tracks (sender -> last sequence) with aging and a capacity bound.

    ``check_and_record`` returns ``(ok, reason)`` instead of raising:
    the callers sit on hot receive paths where a reject is routine, not
    exceptional.
    """

    def __init__(self, config: Optional[SequenceTrackerConfig] = None):
        self.config = config or SequenceTrackerConfig()
        self._seq: Dict[str, Tuple[int, float]] = {}   # sender -> (seq, mono)
        self._lock = threading.Lock()
        self._calls = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._seq)

    @property
    def is_empty(self) -> bool:
        return len(self) == 0

    def check_and_record(self, sender: str, sequence: int,
                         timestamp_ms: Optional[int] = None,
                         now_ms: Optional[int] = None) -> Tuple[bool, str]:
        """Accept iff ``sequence`` strictly exceeds the last seen one.

        ``timestamp_ms`` (when the message carries a wall clock) is
        checked for staleness and future skew; pass ``None`` to skip.
        ``now_ms`` overrides the wall clock for deterministic tests.
        """
        mono = time.monotonic()
        with self._lock:
            self._calls += 1
            if self._calls % self.config.cleanup_interval == 0:
                self._cleanup_locked(mono)

            if timestamp_ms is not None:
                now = time.time() * 1000.0 if now_ms is None else now_ms
                if timestamp_ms > now + _FUTURE_SKEW_MS:
                    return False, "message timestamp is in the future"
                if now > timestamp_ms + self.config.max_age_ms:
                    return False, "message too old"

            entry = self._seq.get(sender)
            if entry is None and len(self._seq) >= self.config.max_entries:
                self._cleanup_locked(mono)
                if len(self._seq) >= self.config.max_entries:
                    return False, "sequence tracker at capacity"
            last = entry[0] if entry is not None else 0
            if sequence <= last:
                return False, (f"replay detected: sequence {sequence} "
                               f"<= last seen {last}")
            self._seq[sender] = (sequence, mono)
            return True, ""

    def _cleanup_locked(self, mono: float) -> None:
        cutoff = mono - self.config.max_age_ms / 1000.0
        stale = [s for s, (_, seen) in self._seq.items() if seen <= cutoff]
        for s in stale:
            del self._seq[s]

    def last_sequence(self, sender: str) -> Optional[int]:
        with self._lock:
            entry = self._seq.get(sender)
            return entry[0] if entry is not None else None

    def forget(self, sender: str) -> None:
        with self._lock:
            self._seq.pop(sender, None)

    def clear(self) -> None:
        with self._lock:
            self._seq.clear()

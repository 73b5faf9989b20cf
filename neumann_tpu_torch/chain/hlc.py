"""Hybrid logical clocks (tensor_chain/src/hlc.rs parity).

HLC timestamps order events across nodes: (wall_ms, logical, node_id),
monotone under local events, sends, and receives.

The port's copy of ``neumann_tpu/chain/hlc.py``:
only its import lines differ.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from functools import total_ordering


@total_ordering
@dataclass(frozen=True)
class HLCTimestamp:
    wall_ms: int
    logical: int
    node_id: str = ""

    def _key(self):
        return (self.wall_ms, self.logical, self.node_id)

    def __lt__(self, other):
        return self._key() < other._key()

    def __eq__(self, other):
        return isinstance(other, HLCTimestamp) and \
            self._key() == other._key()

    def pack(self) -> tuple:
        return (self.wall_ms, self.logical, self.node_id)

    @staticmethod
    def unpack(t) -> "HLCTimestamp":
        return HLCTimestamp(t[0], t[1], t[2])


class HLC:
    def __init__(self, node_id: str = "", now_ms=None):
        self.node_id = node_id
        self._now = now_ms or (lambda: int(time.time() * 1000))
        self._wall = 0
        self._logical = 0
        self._lock = threading.Lock()

    def now(self) -> HLCTimestamp:
        """Local event / send."""
        with self._lock:
            wall = self._now()
            if wall > self._wall:
                self._wall = wall
                self._logical = 0
            else:
                self._logical += 1
            return HLCTimestamp(self._wall, self._logical, self.node_id)

    def update(self, remote: HLCTimestamp) -> HLCTimestamp:
        """Receive: merge a remote timestamp."""
        with self._lock:
            wall = self._now()
            if wall > self._wall and wall > remote.wall_ms:
                self._wall = wall
                self._logical = 0
            elif remote.wall_ms > self._wall:
                self._wall = remote.wall_ms
                self._logical = remote.logical + 1
            elif self._wall > remote.wall_ms:
                self._logical += 1
            else:
                self._logical = max(self._logical, remote.logical) + 1
            return HLCTimestamp(self._wall, self._logical, self.node_id)

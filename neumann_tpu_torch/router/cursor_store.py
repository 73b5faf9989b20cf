"""Bounded, TTL-expiring pagination cursor store.

Copy of ``neumann_tpu.router.cursor_store``, unchanged apart from this
note.

Capability parity with the reference's query_router/src/cursor_store.rs
(CursorStoreConfig, LRU eviction at capacity, sliding-TTL expiry,
cleanup_expired, optional background sweeper) and cursor.rs (CursorState
with created/last-accessed stamps and per-cursor TTL). Cursors here hold
the materialized result rows — the router executes once and pages from
memory — so the state carries `rows`/`pos` instead of re-executing at an
offset; expiry and eviction semantics match the reference.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class CursorError(Exception):
    """Base class for cursor store failures."""


class CursorNotFound(CursorError):
    pass


class CursorExpired(CursorError):
    pass


class CursorCapacityExceeded(CursorError):
    pass


@dataclass
class CursorStoreConfig:
    """Mirror of the reference CursorStoreConfig (cursor_store.rs:17-37)."""

    max_cursors: int = 10_000
    default_ttl: float = 300.0        # seconds; 5 minutes
    max_ttl: float = 1800.0           # 30 minutes
    cleanup_interval: float = 30.0

    @classmethod
    def from_env(cls) -> "CursorStoreConfig":
        cfg = cls()
        if v := os.environ.get("NEUMANN_MAX_CURSORS"):
            cfg.max_cursors = int(v)
        if v := os.environ.get("NEUMANN_CURSOR_TTL"):
            cfg.default_ttl = float(v)
        return cfg


@dataclass
class CursorState:
    """A live pagination cursor (reference cursor.rs:48-67).

    `rows` is the materialized result set; `pos` the next-row offset.
    """

    id: str
    query: str
    rows: List
    pos: int = 0
    page_size: int = 100
    ttl: float = 300.0
    created_at: float = field(default_factory=time.monotonic)
    last_accessed_at: float = field(default_factory=time.monotonic)

    @property
    def total_count(self) -> int:
        return len(self.rows)

    def has_more(self) -> bool:
        return self.pos < len(self.rows)

    def is_expired(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return (now - self.last_accessed_at) > self.ttl

    def touch(self) -> None:
        self.last_accessed_at = time.monotonic()


class CursorStore:
    """Thread-safe cursor storage with TTL expiry and LRU eviction.

    Semantics match the reference (cursor_store.rs:85-268): `get` on an
    expired cursor removes it and raises; inserting at capacity evicts
    the least-recently-accessed cursor; `cleanup_expired` sweeps the
    table. Expired-entry sweeps also run opportunistically every
    `cleanup_interval` seconds on any mutating call, so a dedicated
    sweeper thread is optional (`spawn_cleanup_thread`).
    """

    def __init__(self, config: Optional[CursorStoreConfig] = None):
        self.config = config or CursorStoreConfig.from_env()
        self._cursors: Dict[str, CursorState] = {}
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._last_sweep = time.monotonic()
        self._shutdown = threading.Event()
        self._sweeper: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def new_cursor(self, query: str, rows: List, page_size: int,
                   ttl: Optional[float] = None) -> CursorState:
        """Create, register, and return a cursor for a materialized result."""
        ttl = self.config.default_ttl if ttl is None else ttl
        ttl = min(ttl, self.config.max_ttl)
        state = CursorState(id=f"cur-{next(self._seq)}", query=query,
                            rows=rows, page_size=page_size, ttl=ttl)
        self.insert(state)
        return state

    def insert(self, state: CursorState) -> None:
        with self._lock:
            self._maybe_sweep()
            if len(self._cursors) >= self.config.max_cursors:
                self._evict_lru()
            if len(self._cursors) >= self.config.max_cursors:
                raise CursorCapacityExceeded(
                    f"cursor store at capacity ({self.config.max_cursors})")
            self._cursors[state.id] = state

    def get(self, cursor_id: str) -> CursorState:
        """Fetch and touch a cursor; expired cursors are removed."""
        with self._lock:
            state = self._cursors.get(cursor_id)
            if state is None:
                raise CursorNotFound(f"unknown cursor {cursor_id}")
            if state.is_expired():
                del self._cursors[cursor_id]
                raise CursorExpired(f"cursor {cursor_id} expired")
            state.touch()
            return state

    def remove(self, cursor_id: str) -> bool:
        with self._lock:
            return self._cursors.pop(cursor_id, None) is not None

    def __len__(self) -> int:
        return len(self._cursors)

    # -- sweeping ------------------------------------------------------------

    def cleanup_expired(self) -> int:
        """Remove every expired cursor; returns the count removed."""
        now = time.monotonic()
        with self._lock:
            dead = [cid for cid, s in self._cursors.items()
                    if s.is_expired(now)]
            for cid in dead:
                del self._cursors[cid]
            self._last_sweep = now
            return len(dead)

    def _maybe_sweep(self) -> None:
        # Caller holds the lock.
        now = time.monotonic()
        if now - self._last_sweep < self.config.cleanup_interval:
            return
        for cid in [c for c, s in self._cursors.items() if s.is_expired(now)]:
            del self._cursors[cid]
        self._last_sweep = now

    def _evict_lru(self) -> None:
        # Caller holds the lock.
        if not self._cursors:
            return
        oldest = min(self._cursors.values(), key=lambda s: s.last_accessed_at)
        del self._cursors[oldest.id]

    # -- background sweeper (reference spawn_cleanup_task) --------------------

    def spawn_cleanup_thread(self) -> None:
        if self._sweeper is not None and self._sweeper.is_alive():
            return
        self._shutdown.clear()

        def run():
            while not self._shutdown.wait(self.config.cleanup_interval):
                self.cleanup_expired()

        self._sweeper = threading.Thread(target=run, daemon=True,
                                         name="cursor-sweeper")
        self._sweeper.start()

    def shutdown(self) -> None:
        self._shutdown.set()
        if self._sweeper is not None:
            self._sweeper.join(timeout=2.0)
            self._sweeper = None

    def is_shutdown(self) -> bool:
        return self._shutdown.is_set()

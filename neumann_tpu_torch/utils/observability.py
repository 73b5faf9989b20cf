"""Observability: query metrics, slow-query log, index-miss tracking.

Parity with relational_engine/src/observability.rs (QueryMetrics,
IndexTracker, check_slow_query) and the server's OTLP counters
(neumann_server/src/metrics.rs capability): per-statement-kind counters
and latency histograms, a bounded slow-query log, index-usage tracking
for "add an index here" hints, and a span-style tracing context manager
over the stdlib logging module.

The port's copy of ``neumann_tpu/utils/observability.py``:
only its import lines differ.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

log = logging.getLogger("neumann_tpu")

_BUCKETS_MS = (0.1, 0.5, 1, 5, 10, 50, 100, 500, 1000, 5000)


@dataclass
class _KindStats:
    count: int = 0
    errors: int = 0
    total_ms: float = 0.0
    max_ms: float = 0.0
    histogram: List[int] = field(
        default_factory=lambda: [0] * (len(_BUCKETS_MS) + 1))

    def record(self, ms: float, error: bool) -> None:
        self.count += 1
        if error:
            self.errors += 1
        self.total_ms += ms
        self.max_ms = max(self.max_ms, ms)
        for i, b in enumerate(_BUCKETS_MS):
            if ms <= b:
                self.histogram[i] += 1
                return
        self.histogram[-1] += 1


class QueryMetrics:
    def __init__(self, slow_threshold_ms: float = 100.0,
                 slow_log_size: int = 256):
        self._stats: Dict[str, _KindStats] = {}
        self._slow: List[dict] = []
        self.slow_threshold_ms = slow_threshold_ms
        self._slow_log_size = slow_log_size
        self._lock = threading.Lock()
        # per-record observers, e.g. the dashboard's progress tracker
        self.listeners: List = []

    def record(self, kind: str, ms: float, error: bool = False,
               query: Optional[str] = None) -> None:
        with self._lock:
            self._stats.setdefault(kind, _KindStats()).record(ms, error)
            if ms >= self.slow_threshold_ms:
                self._slow.append({"ts": time.time(), "kind": kind,
                                   "ms": round(ms, 3),
                                   "query": (query or "")[:500]})
                if len(self._slow) > self._slow_log_size:
                    self._slow = self._slow[-self._slow_log_size:]
                log.warning("slow query (%.1f ms): %s", ms,
                            (query or kind)[:200])
        for fn in self.listeners:
            try:
                fn(kind, ms, error)
            except Exception:  # noqa: BLE001 — observers never break queries
                pass

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {
                kind: {"count": s.count, "errors": s.errors,
                       "avg_ms": round(s.total_ms / s.count, 3)
                       if s.count else 0.0,
                       "max_ms": round(s.max_ms, 3)}
                for kind, s in self._stats.items()}

    def slow_queries(self) -> List[dict]:
        with self._lock:
            return list(self._slow)


class IndexTracker:
    """Counts indexed vs full-scan lookups per (table, column)."""

    def __init__(self):
        self._hits: Dict[tuple, int] = {}
        self._misses: Dict[tuple, int] = {}
        self._lock = threading.Lock()

    def record(self, table: str, column: str, used_index: bool) -> None:
        with self._lock:
            d = self._hits if used_index else self._misses
            d[(table, column)] = d.get((table, column), 0) + 1

    def suggestions(self, min_misses: int = 100) -> List[dict]:
        """Columns scanned often without an index."""
        with self._lock:
            return [{"table": t, "column": c, "full_scans": n}
                    for (t, c), n in sorted(self._misses.items(),
                                            key=lambda kv: -kv[1])
                    if n >= min_misses]


# Optional global span sink (utils/otlp.SpanRecorder); span() records
# into it when installed so OTLP trace export sees every span.
_span_recorder = None


def set_span_recorder(recorder) -> None:
    global _span_recorder
    _span_recorder = recorder


@contextmanager
def span(name: str, **fields):
    """Lightweight tracing span -> DEBUG log with duration (+ OTLP
    recorder when one is installed)."""
    t0 = time.perf_counter()
    start_ns = time.time_ns()
    try:
        yield
    finally:
        ms = (time.perf_counter() - t0) * 1e3
        if _span_recorder is not None:
            _span_recorder.record(name, start_ns,
                                  start_ns + int(ms * 1e6), fields)
        if fields:
            extras = " ".join(f"{k}={v}" for k, v in fields.items())
            log.debug("%s %s took %.2f ms", name, extras, ms)
        else:
            log.debug("%s took %.2f ms", name, ms)

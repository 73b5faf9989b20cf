"""Query batcher: coalesce concurrent searches into one device call
(port of ``neumann_tpu/server/batcher.py``).

Requests are collected for up to ``max_wait_ms``, grouped into cohorts
by filter, and each cohort runs as ONE ``batch_search_ns`` on the
engine's device; per-query results go back to the waiting callers.
Kept from the reference: several dispatch workers (each owns one
in-flight device call), per-request validation at submit (a bad
dimension or top_k fails only its caller), failure isolation (a cohort
whose device call raises is re-run per request, so only the offending
request fails), and cohorts keyed by filter inside a batcher that the
router keys by (namespace, dim, metric).

Three departures from the reference:

* **No padding to buckets.** The JAX batcher pads each cohort to
  (1, 4, 16, 64, 256) rows so XLA reuses its executables. On the card a
  padded row is only waste: it moves a cohort onto a wider kernel (the
  int8 scan's ``mma.sync`` kernel takes up to 8 queries) and its
  results are built on the host and dropped. Each cohort runs at its
  own size, up to ``max_batch``; results are per row, so they equal the
  padded batcher's.
* **Hashable cohort keys.** The reference groups by the
  ``FilterCondition`` itself, and one built with a list value (an
  ``in`` filter) cannot be hashed: the worker thread dies and its
  requests hang. Here a filter is frozen into a hashable key (lists
  become tuples); one that still cannot be hashed (a dict value from
  JSON) runs as a cohort of its own. The workers stay alive either way.
* **Timed-out requests leave the queue.** The reference leaves a
  request whose caller timed out queued, to be run for no one;
  ``search`` removes it on timeout.

The completion callback (``submit(..., callback=)``) fires exactly once
per request, as in the reference, with one repair: a cohort's results
are all taken before any request finishes, and a callback that raises
is logged, so a failing callback can no longer send its cohort down the
per-request re-run and fire the callbacks a second time. The workers
also count batches and queries under the batcher's lock, where the
reference's unlocked ``+=`` from several workers can lose a count.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from neumann_tpu_torch.engines.vector import (
    FilterCondition,
    SearchResult,
    VectorEngine,
)

_log = logging.getLogger(__name__)


@dataclass(eq=False)
class _Request:
    query: np.ndarray
    top_k: int
    filter_cond: Optional[FilterCondition] = None
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[SearchResult]] = None
    error: Optional[Exception] = None
    # async completion hook (QueryStream serving): called exactly once
    # with (results, error) from a worker thread
    callback: Optional[Callable] = None

    def finish(self) -> None:
        self.event.set()
        if self.callback is not None:
            try:
                self.callback(self.result, self.error)
            except Exception:  # noqa: BLE001 — the caller's fault
                _log.exception("batcher completion callback failed")


class BatcherClosed(RuntimeError):
    """The server is shutting down; the request was not executed."""


def _freeze(v):
    """A filter tree (or value) as nested tuples: equal filters give
    equal keys, and list values become hashable."""
    if isinstance(v, FilterCondition):
        return (v.op, v.fieldname, _freeze(v.value), _freeze(v.left),
                _freeze(v.right))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def _cohort_key(req: _Request):
    key = _freeze(req.filter_cond)
    try:
        hash(key)
    except TypeError:
        return ("alone", id(req))    # e.g. a dict value: its own cohort
    return key


class QueryBatcher:
    def __init__(self, engine: VectorEngine, dim: int,
                 ns: str = "", metric: Optional[str] = "cosine",
                 max_wait_ms: float = 2.0,
                 max_batch: int = 256, workers: int = 4):
        self.engine = engine
        self.dim = dim
        self.ns = ns
        self.metric = metric
        self.max_wait_s = max_wait_ms / 1e3
        self.max_batch = max_batch
        self._queue: List[_Request] = []
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._loop, daemon=True,
                             name=f"batcher-{ns or 'emb'}-{dim}-{i}")
            for i in range(max(1, workers))]
        for t in self._threads:
            t.start()
        self.batches_run = 0
        self.queries_served = 0

    # ------------------------------------------------------------------
    def search(self, query, top_k: int, timeout_s: float = 30.0,
               filter_cond: Optional[FilterCondition] = None
               ) -> List[SearchResult]:
        """Blocking search; coalesced with concurrent callers.

        Validation happens at submit, before the request can join a
        cohort, so a malformed query fails only its own caller. On
        timeout the request leaves the queue if no worker took it."""
        req = self.submit(query, top_k, filter_cond)
        if not req.event.wait(timeout_s):
            with self._cond:
                for i, queued in enumerate(self._queue):
                    if queued is req:
                        del self._queue[i]
                        break
            raise TimeoutError("batched search timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def submit(self, query, top_k: int,
               filter_cond: Optional[FilterCondition] = None,
               callback: Optional[Callable] = None) -> _Request:
        """Non-blocking enqueue; validation errors raise HERE (in the
        submitting thread); the request's ``event`` is set on
        completion. ``callback(results, error)`` fires once from a
        worker thread on completion — the QueryStream pipelined-serving
        hook."""
        q = np.asarray(query, np.float32)
        if q.shape != (self.dim,):
            raise ValueError(f"query dim {q.shape} != ({self.dim},)")
        if top_k <= 0:
            raise ValueError("top_k must be positive")
        req = _Request(q, top_k, filter_cond, callback=callback)
        with self._cond:
            if self._stop.is_set():
                raise BatcherClosed("batcher is closed")
            self._queue.append(req)
            self._cond.notify()
        return req

    def close(self) -> None:
        """Drain: queued requests are still executed (workers keep
        processing until the queue is empty), then threads exit."""
        with self._cond:
            self._stop.set()
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=10.0)
        # anything still queued (workers timed out): fail fast instead
        # of leaving callers to hit their timeout
        with self._cond:
            leftovers, self._queue = self._queue, []
        for req in leftovers:
            req.error = BatcherClosed("batcher closed before execution")
            req.finish()

    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop.is_set():
                    self._cond.wait()
                if not self._queue:     # stopping and drained
                    return
                coalesce = (self.max_wait_s > 0
                            and len(self._queue) < 4
                            and not self._stop.is_set())
            if coalesce:
                # small collection window lets concurrent callers join
                # (skipped when load has already queued a real batch)
                time.sleep(self.max_wait_s)
            with self._cond:
                batch = self._queue[: self.max_batch]
                del self._queue[: len(batch)]
                if self._queue:
                    self._cond.notify()     # leftovers -> next worker
            if batch:
                self._run(batch)

    def _run(self, batch: List[_Request]) -> None:
        # group by filter: identical concurrent filtered queries share
        # one masked scan; distinct filters run as separate cohorts
        groups: Dict[object, List[_Request]] = {}
        for req in batch:
            groups.setdefault(_cohort_key(req), []).append(req)
        for cohort in groups.values():
            self._run_cohort(cohort[0].filter_cond, cohort)

    def _run_cohort(self, filt: Optional[FilterCondition],
                    cohort: List[_Request]) -> None:
        try:
            q = np.stack([req.query for req in cohort])
            max_k = max(r.top_k for r in cohort)
            # one device call for the whole cohort, at its own size
            all_results = self.engine.batch_search_ns(
                q, max_k, self.metric, self.ns, filter_cond=filt)
            results = [all_results[i][: req.top_k]
                       for i, req in enumerate(cohort)]
        except Exception as e:  # noqa: BLE001 — isolate, then propagate
            if len(cohort) == 1:
                cohort[0].error = e
                cohort[0].finish()
                return
            # failure isolation: re-run per request so only the
            # offending one fails
            for req in cohort:
                try:
                    req.result = self.engine.batch_search_ns(
                        req.query[None, :], req.top_k, self.metric,
                        self.ns, filter_cond=filt)[0]
                    with self._lock:
                        self.queries_served += 1
                except Exception as e2:  # noqa: BLE001
                    req.error = e2
                req.finish()
            return
        with self._lock:       # several workers count
            self.batches_run += 1
            self.queries_served += len(cohort)
        for req, res in zip(cohort, results):
            req.result = res
            req.finish()

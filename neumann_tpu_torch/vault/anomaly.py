"""Anomaly detection for vault agent behavior.

Parity with tensor_vault/src/anomaly.rs: per-agent behavioral profiles
(known secrets, access counts, sliding-window timestamps) checked on
every operation for four event classes — first secret access, frequency
spike, bulk operation on one secret, and dormant agent resumption.
Profiles persist in the shared TensorStore under ``_vap:`` keys so they
survive restarts via the WAL like everything else.

The port's copy of ``neumann_tpu/vault/anomaly.py``:
only its import lines differ.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from neumann_tpu_torch.store.tensor_store import TensorData, TensorStore, TensorValue

_PROFILE_PREFIX = "_vap:"


@dataclass
class AnomalyThresholds:
    frequency_spike_limit: int = 50
    frequency_window_ms: int = 60_000
    bulk_operation_threshold: int = 10
    inactive_threshold_ms: int = 86_400_000  # 24h


@dataclass
class AgentProfile:
    known_secrets: Set[str] = field(default_factory=set)
    access_counts: Dict[str, int] = field(default_factory=dict)
    last_activity_ms: int = 0
    total_ops: int = 0
    recent_timestamps: List[int] = field(default_factory=list)

    def to_json(self) -> str:
        return json.dumps({
            "known": sorted(self.known_secrets),
            "counts": self.access_counts,
            "last": self.last_activity_ms,
            "total": self.total_ops,
            "recent": self.recent_timestamps[-256:]})

    @staticmethod
    def from_json(raw: str) -> "AgentProfile":
        o = json.loads(raw)
        return AgentProfile(set(o["known"]), dict(o["counts"]),
                            o["last"], o["total"], list(o["recent"]))


@dataclass(frozen=True)
class AnomalyEvent:
    kind: str      # first_access | frequency_spike | bulk_operation
    #                | inactive_resumed
    entity: str
    detail: dict


class AnomalyMonitor:
    """Tracks per-agent behavior; ``check()`` on every vault op returns
    the anomalies that op triggered."""

    def __init__(self, thresholds: Optional[AnomalyThresholds] = None,
                 store: Optional[TensorStore] = None):
        self.thresholds = thresholds or AnomalyThresholds()
        self._profiles: Dict[str, AgentProfile] = {}
        self._lock = threading.Lock()
        self._store = store
        if store is not None:
            for key in store.scan(_PROFILE_PREFIX):
                data = store.get(key)
                if data is not None and data.get("profile") is not None:
                    self._profiles[key[len(_PROFILE_PREFIX):]] = \
                        AgentProfile.from_json(data.get("profile").value)

    def check(self, entity: str, secret_key: str,
              now_ms: Optional[int] = None) -> List[AnomalyEvent]:
        now = now_ms if now_ms is not None else int(time.time() * 1000)
        th = self.thresholds
        events: List[AnomalyEvent] = []
        with self._lock:
            prof = self._profiles.setdefault(entity, AgentProfile())
            # dormant resumption (before updating last_activity)
            if prof.total_ops > 0 and prof.last_activity_ms > 0:
                idle = now - prof.last_activity_ms
                if idle >= th.inactive_threshold_ms:
                    events.append(AnomalyEvent(
                        "inactive_resumed", entity,
                        {"inactive_ms": idle}))
            # first access to this secret
            if secret_key not in prof.known_secrets:
                prof.known_secrets.add(secret_key)
                events.append(AnomalyEvent(
                    "first_access", entity, {"secret": secret_key}))
            # bulk operations on one secret
            count = prof.access_counts.get(secret_key, 0) + 1
            prof.access_counts[secret_key] = count
            if count == th.bulk_operation_threshold:
                events.append(AnomalyEvent(
                    "bulk_operation", entity,
                    {"secret": secret_key, "count": count,
                     "threshold": th.bulk_operation_threshold}))
            # sliding-window frequency spike
            window_start = now - th.frequency_window_ms
            prof.recent_timestamps = [
                t for t in prof.recent_timestamps if t >= window_start]
            prof.recent_timestamps.append(now)
            in_window = len(prof.recent_timestamps)
            if in_window == th.frequency_spike_limit:
                events.append(AnomalyEvent(
                    "frequency_spike", entity,
                    {"ops_in_window": in_window,
                     "threshold": th.frequency_spike_limit}))
            prof.last_activity_ms = now
            prof.total_ops += 1
        return events

    def get_profile(self, entity: str) -> Optional[AgentProfile]:
        with self._lock:
            return self._profiles.get(entity)

    def monitored_entities(self) -> List[str]:
        with self._lock:
            return sorted(self._profiles)

    def reset_profile(self, entity: str) -> None:
        with self._lock:
            self._profiles.pop(entity, None)
        if self._store is not None:
            self._store.delete(f"{_PROFILE_PREFIX}{entity}")

    def persist(self, store: Optional[TensorStore] = None) -> int:
        store = store or self._store
        if store is None:
            return 0
        with self._lock:
            profiles = {e: p.to_json() for e, p in self._profiles.items()}
        for entity, raw in profiles.items():
            td = TensorData()
            td.set("profile", TensorValue.scalar(raw))
            store.put(f"{_PROFILE_PREFIX}{entity}", td)
        return len(profiles)

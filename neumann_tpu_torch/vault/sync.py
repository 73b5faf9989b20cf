"""Vault sync targets + geo routing.

Parity with the reference's vault PITR-sync surface
(integration_tests/tests/vault_pitr_sync.rs + tensor_vault geo_routing):
pluggable SyncTargets (file target included), per-secret subscriptions,
trigger_sync pushing the CIPHERTEXT (secrets never leave the vault in
the clear), per-target health, and a GeoRouter that scores targets by
latency/throughput/failure-rate EMAs and excludes those over the
configured latency ceiling.

The port's copy of ``neumann_tpu/vault/sync.py``:
only its import lines differ.
"""

from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from neumann_tpu_torch.utils.errors import VaultError


class SyncTarget:
    """A replication destination for encrypted secrets."""

    name: str = "target"

    def push(self, key: str, ciphertext: bytes) -> None:
        raise NotImplementedError

    def healthy(self) -> bool:
        return True


class FileSyncTarget(SyncTarget):
    """Writes ciphertexts under a directory (one file per secret)."""

    def __init__(self, name: str, base_dir: str):
        self.name = name
        self.base_dir = str(base_dir)

    def _path(self, key: str) -> str:
        safe = key.replace("/", "__").replace("..", "_")
        return os.path.join(self.base_dir, safe + ".bin")

    def push(self, key: str, ciphertext: bytes) -> None:
        os.makedirs(self.base_dir, exist_ok=True)
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(ciphertext)
        os.replace(tmp, self._path(key))

    def healthy(self) -> bool:
        return os.path.isdir(self.base_dir)


class MemorySyncTarget(SyncTarget):
    """In-process target for tests and fan-in pipelines."""

    def __init__(self, name: str):
        self.name = name
        self.received: Dict[str, bytes] = {}

    def push(self, key: str, ciphertext: bytes) -> None:
        self.received[key] = ciphertext


class VaultSync:
    """Sync-target registry + subscriptions for one vault.

    Attach with ``VaultSync(vault)``; it reads ciphertexts straight from
    the vault's store so plaintext never transits.
    """

    def __init__(self, vault):
        self.vault = vault
        self._targets: Dict[str, SyncTarget] = {}
        self._subs: Dict[str, Set[str]] = {}   # secret key -> target names
        self._lock = threading.Lock()
        self.router: Optional["GeoRouter"] = None

    def register_sync_target(self, target: SyncTarget) -> None:
        with self._lock:
            if target.name in self._targets:
                raise VaultError(f"sync target '{target.name}' exists")
            self._targets[target.name] = target

    def list_sync_targets(self) -> List[str]:
        with self._lock:
            return sorted(self._targets)

    def subscribe_sync(self, key: str, target_name: str) -> None:
        with self._lock:
            if target_name not in self._targets:
                raise VaultError(f"no sync target '{target_name}'")
            self._subs.setdefault(key, set()).add(target_name)

    def unsubscribe_sync(self, key: str, target_name: str) -> None:
        with self._lock:
            self._subs.get(key, set()).discard(target_name)

    def trigger_sync(self, key: str) -> int:
        """Push `key`'s current ciphertext to its subscribed targets;
        returns the number of successful pushes. Routed through the
        GeoRouter when one is attached."""
        data = self.vault.store.get(self.vault._skey(key))
        if data is None or data.get("cipher") is None:
            raise VaultError(f"no secret '{key}'")
        blob = data.get("cipher").value
        with self._lock:
            names = sorted(self._subs.get(key, set()))
            targets = [self._targets[n] for n in names
                       if n in self._targets]
        if self.router is not None and targets:
            decision = self.router.route(key, None,
                                         [t.name for t in targets])
            chosen = {g.target_name for g in decision.selected_targets}
            targets = [t for t in targets if t.name in chosen]
        import time

        count = 0
        for t in targets:
            t0 = time.perf_counter()
            try:
                t.push(key, blob)
                ok = True
                count += 1
            except Exception:
                ok = False
            if self.router is not None:
                self.router.record_sync_result(
                    t.name, (time.perf_counter() - t0) * 1e3, ok)
        return count

    def sync_health(self) -> List[Tuple[str, bool]]:
        with self._lock:
            targets = sorted(self._targets.items())
        return [(name, t.healthy()) for name, t in targets]


# ---------------------------------------------------------------------------
# geo routing
# ---------------------------------------------------------------------------

@dataclass
class GeoCoordinate:
    x: float
    y: float
    z: Optional[float] = None

    def distance(self, other: "GeoCoordinate") -> float:
        dz = (self.z or 0.0) - (other.z or 0.0)
        return math.sqrt((self.x - other.x) ** 2
                         + (self.y - other.y) ** 2 + dz * dz)


@dataclass
class TargetGeometry:
    target_name: str
    location: GeoCoordinate
    avg_latency_ms: float = 0.0
    avg_throughput: float = 0.0
    failure_rate: float = 0.0
    last_health_check_ms: int = 0


@dataclass
class RoutingConfig:
    sync_fanout: int = 3
    max_latency_ms: float = 250.0
    max_failure_rate: float = 0.5
    ema_alpha: float = 0.2


@dataclass
class RoutingDecision:
    selected_targets: List[TargetGeometry] = field(default_factory=list)
    excluded_targets: List[TargetGeometry] = field(default_factory=list)


class GeoRouter:
    """Scores sync targets by latency/throughput/failure EMAs; routes
    each key to the best `sync_fanout` targets, excluding any over the
    latency or failure ceilings (tensor_vault/src/geo_routing.rs)."""

    def __init__(self, config: Optional[RoutingConfig] = None):
        self.config = config or RoutingConfig()
        self._geo: Dict[str, TargetGeometry] = {}
        self._lock = threading.Lock()

    def update_geometry(self, geometry: TargetGeometry) -> None:
        with self._lock:
            self._geo[geometry.target_name] = geometry

    def geometries(self) -> List[TargetGeometry]:
        with self._lock:
            return list(self._geo.values())

    def record_sync_result(self, target_name: str, latency_ms: float,
                           ok: bool) -> None:
        a = self.config.ema_alpha
        with self._lock:
            g = self._geo.get(target_name)
            if g is None:
                return
            g.avg_latency_ms = a * latency_ms + (1 - a) * g.avg_latency_ms
            g.failure_rate = a * (0.0 if ok else 1.0) \
                + (1 - a) * g.failure_rate

    def _score(self, g: TargetGeometry,
               origin: Optional[GeoCoordinate]) -> float:
        score = 1000.0 - g.avg_latency_ms + 0.1 * g.avg_throughput \
            - 500.0 * g.failure_rate
        if origin is not None:
            score -= g.location.distance(origin)
        return score

    def route(self, key: str, origin: Optional[GeoCoordinate],
              available: List[str]) -> RoutingDecision:
        with self._lock:
            geos = [self._geo[n] for n in available if n in self._geo]
        decision = RoutingDecision()
        eligible = []
        for g in geos:
            if g.avg_latency_ms > self.config.max_latency_ms or \
                    g.failure_rate > self.config.max_failure_rate:
                decision.excluded_targets.append(g)
            else:
                eligible.append(g)
        eligible.sort(key=lambda g: -self._score(g, origin))
        decision.selected_targets = eligible[: self.config.sync_fanout]
        return decision

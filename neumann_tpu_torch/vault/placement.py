"""Manifold-aware secret placement.

Parity with tensor_vault/src/manifold.rs: vault deployment regions with
geographic centers, capacities and inter-region latencies; entity
(accessor) locations; placement recommendations that put each secret's
primary copy in the region closest to its accessors' centroid, balanced
against load and replication latency.

The latency-aware *sync* routing half of the reference
(geo_routing.rs) lives in vault/sync.py (GeoRouter), already wired
into VaultSync.  This module is the placement half.

The scoring math is vectorized: ``batch_recommend`` scores every
(secret, region) pair as one numpy distance matrix instead of the
reference's per-secret loop — the natural array idiom for this
framework (and trivially jit-able if placement ever moves on-device).

The port's copy of ``neumann_tpu/vault/placement.py``:
only its import lines differ.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from neumann_tpu_torch.utils.errors import VaultError
from neumann_tpu_torch.vault.sync import GeoCoordinate


def _as_array(c: GeoCoordinate) -> np.ndarray:
    return np.array([c.x, c.y, c.z or 0.0], np.float64)


@dataclass
class VaultRegion:
    """A deployment region with capacity + inter-region latencies."""

    name: str
    center: GeoCoordinate
    capacity: int
    current_load: int = 0
    latencies: Dict[str, float] = field(default_factory=dict)


@dataclass
class PlacementConfig:
    locality_weight: float = 0.7
    load_balance_weight: float = 0.2
    replication_weight: float = 0.1
    replica_count: int = 1


@dataclass
class PlacementRecommendation:
    secret_key: str
    primary_region: str
    replica_regions: List[str]
    placement_score: float          # lower is better
    access_centroid: GeoCoordinate


class ManifoldPlacer:
    """Recommends which region(s) should hold each secret, from the
    geographic centroid of its accessors (manifold.rs)."""

    def __init__(self, config: Optional[PlacementConfig] = None):
        self.config = config or PlacementConfig()
        self._regions: Dict[str, VaultRegion] = {}
        self._entities: Dict[str, GeoCoordinate] = {}
        self._lock = threading.Lock()

    def add_region(self, region: VaultRegion) -> None:
        with self._lock:
            self._regions[region.name] = region

    def set_entity_location(self, entity: str, coord: GeoCoordinate
                            ) -> None:
        with self._lock:
            self._entities[entity] = coord

    def regions(self) -> List[VaultRegion]:
        with self._lock:
            return list(self._regions.values())

    def entity_location(self, entity: str) -> Optional[GeoCoordinate]:
        with self._lock:
            return self._entities.get(entity)

    # -- scoring ----------------------------------------------------------
    def _region_matrix(self) -> Tuple[List[VaultRegion], np.ndarray,
                                      np.ndarray, np.ndarray]:
        regions = list(self._regions.values())
        if not regions:
            raise VaultError("no regions registered")
        centers = np.stack([_as_array(r.center) for r in regions])
        load = np.array([r.current_load / max(r.capacity, 1)
                         for r in regions])
        # average inter-region latency per region (replication cost)
        lat = np.array([
            (sum(r.latencies.values()) / len(r.latencies))
            if r.latencies else 0.0 for r in regions])
        return regions, centers, load, lat

    def _centroids(self, accessors_per_secret: Sequence[Sequence[str]]
                   ) -> np.ndarray:
        cents = []
        for accessors in accessors_per_secret:
            pts = [_as_array(self._entities[a]) for a in accessors
                   if a in self._entities]
            cents.append(np.mean(pts, axis=0) if pts
                         else np.zeros(3, np.float64))
        return np.stack(cents) if cents else np.zeros((0, 3), np.float64)

    def recommend_placement(self, secret_key: str,
                            accessors: Sequence[str]
                            ) -> PlacementRecommendation:
        return self.batch_recommend([(secret_key, list(accessors))])[0]

    def batch_recommend(self,
                        items: Sequence[Tuple[str, Sequence[str]]]
                        ) -> List[PlacementRecommendation]:
        """Score every (secret, region) pair at once:
        score = locality*dist + load_balance*(load/cap) + replication*lat
        (lower is better), primary = argmin, replicas = next-best."""
        cfg = self.config
        with self._lock:
            regions, centers, load, lat = self._region_matrix()
            cents = self._centroids([a for _, a in items])
        if not items:
            return []
        # [S, R] distance matrix; normalize each term to comparable scale
        dist = np.linalg.norm(cents[:, None, :] - centers[None, :, :],
                              axis=-1)
        dn = dist / max(float(dist.max()), 1e-9)
        ln = lat / max(float(lat.max()), 1e-9) if lat.size else lat
        score = (cfg.locality_weight * dn
                 + cfg.load_balance_weight * load[None, :]
                 + cfg.replication_weight * ln[None, :])
        order = np.argsort(score, axis=1)
        out = []
        for i, (key, _) in enumerate(items):
            ranked = [regions[j].name for j in order[i]]
            out.append(PlacementRecommendation(
                secret_key=key,
                primary_region=ranked[0],
                replica_regions=ranked[1:1 + cfg.replica_count],
                placement_score=float(score[i, order[i][0]]),
                access_centroid=GeoCoordinate(*cents[i].tolist())))
        return out

    def record_placement(self, region_name: str, n: int = 1) -> None:
        """Bump a region's load after actually placing secrets."""
        with self._lock:
            r = self._regions.get(region_name)
            if r is None:
                raise VaultError(f"no region '{region_name}'")
            r.current_load += n

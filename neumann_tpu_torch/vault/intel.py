"""Vault access intelligence: tensors, diffusion, graph introspection.

Condensed capability parity with tensor_vault/src/{access_tensor,
heat_kernel, graph_intel, similarity}.rs:

- AccessTensor: the audit log as a dense H[entity, secret, time_bucket]
  tensor — marginals, hot pairs, per-entity temporal profiles, and a
  drift score, all as array reductions (the TPU-natural formulation).
- HeatKernelTrust: trust as heat flow on the access-control graph.
  exp(-t L) is approximated with a truncated Chebyshev series over the
  normalized adjacency — repeated matvecs, no eigendecomposition.
- GraphIntel: blast radius, path explanation, grant simulation, and a
  security audit (sole-admin SPOFs, unused grants, over-privilege).
- SecretSimilarity: operational-metadata feature vectors per secret
  (age, versions, access frequency, rotation staleness, grant count)
  with cosine top-k neighbors — "which secrets behave like this one".

The port's copy of ``neumann_tpu/vault/intel.py``:
only its import lines differ.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# access tensor
# ---------------------------------------------------------------------------

@dataclass
class AccessTensorConfig:
    bucket_size_s: float = 3600.0
    num_buckets: int = 168           # one week of hourly buckets
    start_time: Optional[float] = None
    operations: Optional[List[str]] = None   # None = all


class AccessTensor:
    """H[entity, secret, bucket] built from the vault audit log."""

    def __init__(self, vault, config: Optional[AccessTensorConfig] = None):
        cfg = config or AccessTensorConfig()
        self.config = cfg
        events = vault.audit_log(limit=100_000)
        end = time.time()
        start = (cfg.start_time if cfg.start_time is not None
                 else end - cfg.bucket_size_s * cfg.num_buckets)
        self.entities: List[str] = []
        self.secrets: List[str] = []
        e_ix: Dict[str, int] = {}
        s_ix: Dict[str, int] = {}
        rows = []
        for ev in events:
            if cfg.operations is not None and \
                    ev["action"] not in cfg.operations:
                continue
            if ev["key"] in ("*",) or not ev["ok"]:
                continue
            b = int((ev["ts"] - start) // cfg.bucket_size_s)
            if not (0 <= b < cfg.num_buckets):
                continue
            e = e_ix.setdefault(ev["actor"], len(self.entities))
            if e == len(self.entities):
                self.entities.append(ev["actor"])
            s = s_ix.setdefault(ev["key"], len(self.secrets))
            if s == len(self.secrets):
                self.secrets.append(ev["key"])
            rows.append((e, s, b))
        ne = max(len(self.entities), 1)
        ns = max(len(self.secrets), 1)
        self.h = np.zeros((ne, ns, cfg.num_buckets), np.float32)
        for e, s, b in rows:
            self.h[e, s, b] += 1.0

    # -- marginals ---------------------------------------------------------
    def entity_activity(self) -> Dict[str, float]:
        tot = self.h.sum(axis=(1, 2))
        return {e: float(tot[i]) for i, e in enumerate(self.entities)}

    def secret_activity(self) -> Dict[str, float]:
        tot = self.h.sum(axis=(0, 2))
        return {s: float(tot[i]) for i, s in enumerate(self.secrets)}

    def temporal_profile(self, entity: str) -> np.ndarray:
        """Per-bucket access counts for one entity."""
        if entity not in self.entities:
            return np.zeros(self.config.num_buckets, np.float32)
        return self.h[self.entities.index(entity)].sum(axis=0)

    def hot_pairs(self, k: int = 5) -> List[Tuple[str, str, float]]:
        """Heaviest (entity, secret) cells."""
        flat = self.h.sum(axis=2)
        order = np.argsort(-flat, axis=None)[:k]
        out = []
        for o in order:
            e, s = np.unravel_index(o, flat.shape)
            if flat[e, s] <= 0:
                break
            out.append((self.entities[e], self.secrets[s],
                        float(flat[e, s])))
        return out

    def drift_score(self, entity: str) -> float:
        """Cosine distance between the entity's secret-usage vectors in
        the first vs second half of the window (0 = stable)."""
        if entity not in self.entities:
            return 0.0
        m = self.h[self.entities.index(entity)]
        half = m.shape[1] // 2
        a = m[:, :half].sum(axis=1)
        b = m[:, half:].sum(axis=1)
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0 or nb == 0:
            return 0.0
        return float(1.0 - (a @ b) / (na * nb))


# ---------------------------------------------------------------------------
# heat-kernel trust diffusion
# ---------------------------------------------------------------------------

class HeatKernelTrust:
    """Trust diffusion over the grant graph.

    Nodes = entities + secrets; edges = live grants (weight by
    permission level). Trust from seed entities diffuses as
    u(t) = exp(-t L) u(0), approximated by the truncated series
    sum_k (t^k / k!) (A_norm - I)^k — plain repeated matvecs."""

    def __init__(self, vault, t: float = 1.0, terms: int = 8):
        self.t = t
        self.terms = terms
        ents: Dict[str, int] = {}
        secs: Dict[str, int] = {}
        edges = []
        with vault._lock:
            grants = list(vault._grants.items())
        for (entity, key), g in grants:
            if not g.live():
                continue
            e = ents.setdefault(entity, len(ents))
            s = secs.setdefault(key, len(secs))
            edges.append((e, s, float(int(g.level))))
        self.entities = list(ents)
        self.secrets = list(secs)
        ne, ns = len(self.entities), len(self.secrets)
        n = ne + ns
        a = np.zeros((max(n, 1), max(n, 1)), np.float32)
        for e, s, w in edges:
            a[e, ne + s] = w
            a[ne + s, e] = w
        deg = np.maximum(a.sum(axis=1), 1e-9)
        self._a_norm = a / np.sqrt(np.outer(deg, deg))
        self._ne = ne

    def trust_from(self, seeds: List[str]) -> Dict[str, float]:
        """Diffused trust score per entity, from unit heat on seeds."""
        n = self._a_norm.shape[0]
        u = np.zeros(n, np.float32)
        for s in seeds:
            if s in self.entities:
                u[self.entities.index(s)] = 1.0
        # exp(-t(I - A)) u = e^{-t} exp(tA) u ; truncated Taylor in A
        acc = u.copy()
        term = u.copy()
        for k in range(1, self.terms + 1):
            term = (self.t / k) * (self._a_norm @ term)
            acc += term
        acc *= np.exp(-self.t)
        return {e: float(acc[i]) for i, e in enumerate(self.entities)}

    def low_trust_heavy_hitters(self, tensor: AccessTensor,
                                seeds: List[str],
                                trust_floor: float = 0.05
                                ) -> List[str]:
        """Entities with high access volume but little diffused trust —
        the heat-kernel anomaly signal."""
        trust = self.trust_from(seeds)
        act = tensor.entity_activity()
        med = np.median([v for v in act.values()]) if act else 0.0
        return sorted(
            e for e, v in act.items()
            if v > med and trust.get(e, 0.0) < trust_floor
            and e not in seeds)


# ---------------------------------------------------------------------------
# graph intel
# ---------------------------------------------------------------------------

@dataclass
class SecurityAudit:
    sole_admins: List[Tuple[str, str]] = field(default_factory=list)
    unused_grants: List[Tuple[str, str]] = field(default_factory=list)
    over_privileged: List[Tuple[str, str]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not (self.sole_admins or self.unused_grants
                    or self.over_privileged)


class GraphIntel:
    """Security introspection over the vault's grant structure."""

    def __init__(self, vault):
        self.vault = vault

    def _live_grants(self):
        with self.vault._lock:
            return [((e, k), g) for (e, k), g in
                    self.vault._grants.items() if g.live()]

    def blast_radius(self, entity: str) -> List[str]:
        """Secrets reachable if this entity is compromised (direct
        grants plus policy-template matches)."""
        from fnmatch import fnmatch

        direct = {k for (e, k), _ in self._live_grants() if e == entity}
        for tpl in self.vault.policies.list():
            if fnmatch(entity, tpl.match_pattern):
                for key in self.vault.list():
                    if fnmatch(key, tpl.secret_pattern):
                        direct.add(key)
        return sorted(direct)

    def explain_access(self, entity: str, key: str) -> List[str]:
        """Why can (or can't) entity touch key — every matching rule."""
        from fnmatch import fnmatch

        reasons = []
        for (e, k), g in self._live_grants():
            if e == entity and k == key:
                reasons.append(f"direct grant {g.level.name}")
        for tpl in self.vault.policies.list():
            if fnmatch(entity, tpl.match_pattern) and \
                    fnmatch(key, tpl.secret_pattern):
                reasons.append(f"policy '{tpl.name}' "
                               f"(level {tpl.permission})")
        return reasons or ["no access"]

    def simulate_grant(self, entity: str, key: str) -> dict:
        """Blast-radius delta if this grant were added."""
        before = self.blast_radius(entity)
        after = sorted(set(before) | {key})
        return {"before": len(before), "after": len(after),
                "added": [k for k in after if k not in before]}

    def audit(self, recent_events: int = 10_000) -> SecurityAudit:
        from neumann_tpu_torch.vault.vault import Permission

        out = SecurityAudit()
        grants = self._live_grants()
        # sole-admin SPOF: exactly one ADMIN grant on a secret
        by_key: Dict[str, List[Tuple[str, object]]] = {}
        for (e, k), g in grants:
            by_key.setdefault(k, []).append((e, g))
        for k, gs in by_key.items():
            admins = [e for e, g in gs if g.level >= Permission.ADMIN]
            if len(admins) == 1:
                out.sole_admins.append((admins[0], k))
        # unused grants: granted but never seen in the audit log
        used = {(ev["actor"], ev["key"])
                for ev in self.vault.audit_log(limit=recent_events)
                if ev["ok"]}
        for (e, k), g in grants:
            if (e, k) not in used:
                out.unused_grants.append((e, k))
        # over-privilege: WRITE/ADMIN grants only ever used for reads
        reads_only = {}
        for ev in self.vault.audit_log(limit=recent_events):
            if not ev["ok"]:
                continue
            cur = reads_only.get((ev["actor"], ev["key"]), True)
            reads_only[(ev["actor"], ev["key"])] = \
                cur and ev["action"] in ("get", "denied")
        for (e, k), g in grants:
            if g.level >= Permission.WRITE and \
                    reads_only.get((e, k), False):
                out.over_privileged.append((e, k))
        out.sole_admins.sort()
        out.unused_grants.sort()
        out.over_privileged.sort()
        return out


# ---------------------------------------------------------------------------
# secret similarity
# ---------------------------------------------------------------------------

class SecretSimilarity:
    """Operational-metadata neighbors: secrets that BEHAVE alike."""

    FEATURES = ("age_events", "version_count", "access_frequency",
                "grant_count", "sets_seen")

    def __init__(self, vault):
        self.vault = vault
        keys = vault.list()
        events = vault.audit_log(limit=100_000)
        feats = np.zeros((max(len(keys), 1), len(self.FEATURES)),
                         np.float32)
        first_seen = {}
        for i, ev in enumerate(events):
            if ev["ok"] and ev["key"] in keys:
                first_seen.setdefault(ev["key"], i)
        grants = {}
        with vault._lock:
            for (e, k), g in vault._grants.items():
                if g.live():
                    grants[k] = grants.get(k, 0) + 1
        for j, k in enumerate(keys):
            acc = [ev for ev in events if ev["key"] == k and ev["ok"]]
            feats[j, 0] = len(events) - first_seen.get(k, len(events))
            try:
                feats[j, 1] = vault.versions(k)
            except Exception:
                feats[j, 1] = 0
            feats[j, 2] = sum(1 for ev in acc if ev["action"] == "get")
            feats[j, 3] = grants.get(k, 0)
            feats[j, 4] = sum(1 for ev in acc if ev["action"] == "set")
        # z-normalize features so no single scale dominates
        mu = feats.mean(axis=0, keepdims=True)
        sd = feats.std(axis=0, keepdims=True)
        self.keys = keys
        self._z = (feats - mu) / np.maximum(sd, 1e-9)

    def similar(self, key: str, k: int = 3
                ) -> List[Tuple[str, float]]:
        if key not in self.keys:
            return []
        i = self.keys.index(key)
        q = self._z[i]
        norms = np.linalg.norm(self._z, axis=1) * \
            max(np.linalg.norm(q), 1e-9)
        sims = (self._z @ q) / np.maximum(norms, 1e-9)
        order = np.argsort(-sims)
        out = []
        for j in order:
            if j == i:
                continue
            out.append((self.keys[j], float(sims[j])))
            if len(out) >= k:
                break
        return out


# ---------------------------------------------------------------------------
# access topology (tensor_vault/src/topology.rs)
# ---------------------------------------------------------------------------

class AccessTopology:
    """The permission structure as a dense [entities, secrets, 3]
    tensor (read/write/admin channels), with optional Tensor-Train
    compression for large matrices and batch permission checks."""

    def __init__(self, vault, enable_tt: bool = True,
                 compression_threshold: int = 10_000):
        from fnmatch import fnmatch

        from neumann_tpu_torch.vault.vault import Permission

        ents: Dict[str, int] = {}
        secs: Dict[str, int] = {}
        with vault._lock:
            grants = [((e, k), g) for (e, k), g in
                      vault._grants.items() if g.live()]
        keys = vault.list()
        for (e, k), _ in grants:
            ents.setdefault(e, len(ents))
            secs.setdefault(k, len(secs))
        policies = vault.policies.list()
        for tpl in policies:
            for k in keys:
                if fnmatch(k, tpl.secret_pattern):
                    secs.setdefault(k, len(secs))
        self.entities = list(ents)
        self.secrets = list(secs)
        ne, ns = max(len(ents), 1), max(len(secs), 1)
        m = np.zeros((ne, ns, 3), np.float32)
        for (e, k), g in grants:
            lvl = int(g.level)
            ei, si = ents[e], secs[k]
            m[ei, si, 0] = 1.0
            if lvl >= int(Permission.WRITE):
                m[ei, si, 1] = 1.0
            if lvl >= int(Permission.ADMIN):
                m[ei, si, 2] = 1.0
        for tpl in policies:
            for e, ei in ents.items():
                if not fnmatch(e, tpl.match_pattern):
                    continue
                for k, si in secs.items():
                    if fnmatch(k, tpl.secret_pattern):
                        m[ei, si, 0] = 1.0
                        if tpl.permission >= int(Permission.WRITE):
                            m[ei, si, 1] = 1.0
                        if tpl.permission >= int(Permission.ADMIN):
                            m[ei, si, 2] = 1.0
        self.matrix = m
        self._tt = None
        if enable_tt and m.size >= compression_threshold:
            from neumann_tpu_torch.compress.tensor_train import (
                TTConfig,
                tt_decompose,
            )

            flat = m.reshape(-1)
            self._tt = tt_decompose(flat, TTConfig.for_dim(flat.size))

    # -- queries -----------------------------------------------------------
    def check(self, entity: str, secret: str) -> dict:
        if entity not in self.entities or secret not in self.secrets:
            return {"entity": entity, "secret": secret,
                    "has_read": False, "has_write": False,
                    "has_admin": False}
        v = self.matrix[self.entities.index(entity),
                        self.secrets.index(secret)]
        return {"entity": entity, "secret": secret,
                "has_read": bool(v[0] > 0.5),
                "has_write": bool(v[1] > 0.5),
                "has_admin": bool(v[2] > 0.5)}

    def batch_check(self, pairs) -> List[dict]:
        return [self.check(e, s) for e, s in pairs]

    def compression_stats(self) -> dict:
        if self._tt is None:
            return {"compressed": False, "ratio": 1.0}
        raw = self.matrix.size * 4
        tt = sum(c.size for c in self._tt.cores) * 4
        return {"compressed": True,
                "ratio": raw / max(tt, 1),
                "raw_bytes": raw, "tt_bytes": tt}

    def diff(self, other: "AccessTopology") -> dict:
        """Permission drift between two topologies (policy reviews)."""
        out = {"added": [], "removed": []}
        chans = ("read", "write", "admin")
        all_e = sorted(set(self.entities) | set(other.entities))
        all_s = sorted(set(self.secrets) | set(other.secrets))
        for e in all_e:
            for s in all_s:
                a = self.check(e, s)
                b = other.check(e, s)
                for c in chans:
                    av, bv = a[f"has_{c}"], b[f"has_{c}"]
                    if av and not bv:
                        out["removed"].append((e, s, c))
                    elif bv and not av:
                        out["added"].append((e, s, c))
        return out

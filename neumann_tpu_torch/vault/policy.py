"""Attribute-based policy templates for declarative access control.

Capability parity with tensor_vault/src/policy.rs: a PolicyTemplate
grants a permission level to every entity whose name matches
``match_pattern`` on every secret whose key matches ``secret_pattern``
(glob syntax), optionally with a TTL. Templates persist in the shared
store under ``_vpol:`` so they survive restarts; evaluation happens
inline at access-check time (no grant materialization needed) or
eagerly via ``apply_to`` for TTL-stamped grants.

The port's copy of ``neumann_tpu/vault/policy.py``:
only its import lines differ.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from fnmatch import fnmatch
from typing import List, Optional

from neumann_tpu_torch.store.tensor_store import TensorData, TensorValue
from neumann_tpu_torch.utils.errors import VaultError

_PREFIX = "_vpol:"


@dataclass
class PolicyTemplate:
    name: str
    match_pattern: str        # entity glob, e.g. "team:eng/*"
    secret_pattern: str       # secret glob, e.g. "staging/*"
    permission: int           # Permission int value
    ttl_seconds: Optional[float] = None

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @staticmethod
    def from_json(s: str) -> "PolicyTemplate":
        return PolicyTemplate(**json.loads(s))


@dataclass
class PolicyMatch:
    policy_name: str
    secret_pattern: str
    permission: int
    ttl_seconds: Optional[float]


class PolicyEngine:
    def __init__(self, store, namespace: str = "default"):
        self.store = store
        self.namespace = namespace

    def _key(self, name: str) -> str:
        return f"{_PREFIX}{self.namespace}:{name}"

    def define(self, tpl: PolicyTemplate) -> None:
        if not tpl.name:
            raise VaultError("policy needs a name")
        td = TensorData()
        td.set("policy", TensorValue.scalar(tpl.to_json()))
        self.store.put(self._key(tpl.name), td)

    def remove(self, name: str) -> bool:
        return self.store.delete(self._key(name))

    def list(self) -> List[PolicyTemplate]:
        prefix = f"{_PREFIX}{self.namespace}:"
        out = []
        for k in self.store.scan(prefix):
            data = self.store.get(k)
            if data is not None and data.get("policy") is not None:
                out.append(PolicyTemplate.from_json(
                    data.get("policy").value))
        return sorted(out, key=lambda t: t.name)

    def evaluate(self, entity: str) -> List[PolicyMatch]:
        """Every policy whose entity pattern matches."""
        return [PolicyMatch(t.name, t.secret_pattern, t.permission,
                            t.ttl_seconds)
                for t in self.list()
                if fnmatch(entity, t.match_pattern)]

    def permission_for(self, entity: str, secret_key: str
                       ) -> Optional[int]:
        """Highest policy-granted permission of entity on secret."""
        best = None
        for m in self.evaluate(entity):
            if fnmatch(secret_key, m.secret_pattern):
                if best is None or m.permission > best:
                    best = m.permission
        return best

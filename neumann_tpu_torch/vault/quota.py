"""Per-namespace resource quotas and usage tracking.

Capability parity with tensor_vault/src/quota.rs: a ResourceQuota caps
secret count, total ciphertext bytes, and operations per hour for one
namespace. Quota configs persist under ``_vquota:``; usage is computed
live from the store (counts/bytes) plus an in-memory hourly op window.

The port's copy of ``neumann_tpu/vault/quota.py``:
only its import lines differ.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from neumann_tpu_torch.store.tensor_store import TensorData, TensorValue
from neumann_tpu_torch.utils.errors import VaultError

_PREFIX = "_vquota:"


@dataclass
class ResourceQuota:
    max_secrets: int = 0          # 0 = unlimited
    max_storage_bytes: int = 0
    max_ops_per_hour: int = 0

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @staticmethod
    def from_json(s: str) -> "ResourceQuota":
        return ResourceQuota(**json.loads(s))


@dataclass
class ResourceUsage:
    secret_count: int = 0
    storage_bytes: int = 0
    ops_this_hour: int = 0


class QuotaManager:
    def __init__(self, store, namespace: str = "default",
                 secret_prefix: str = "_vault:"):
        self.store = store
        self.namespace = namespace
        self._secret_prefix = f"{secret_prefix}{namespace}:"
        self._ops = 0
        self._hour_start = time.time()

    def _key(self) -> str:
        return f"{_PREFIX}{self.namespace}"

    def set_quota(self, quota: ResourceQuota) -> None:
        td = TensorData()
        td.set("quota", TensorValue.scalar(quota.to_json()))
        self.store.put(self._key(), td)

    def get_quota(self) -> Optional[ResourceQuota]:
        data = self.store.get(self._key())
        if data is None or data.get("quota") is None:
            return None
        return ResourceQuota.from_json(data.get("quota").value)

    def clear_quota(self) -> bool:
        return self.store.delete(self._key())

    def usage(self) -> ResourceUsage:
        self._roll_hour()
        count, total = 0, 0
        for k in self.store.scan(self._secret_prefix):
            data = self.store.get(k)
            if data is None:
                continue
            count += 1
            for name, val in data.fields.items():
                v = val.value
                if isinstance(v, (bytes, bytearray)):
                    total += len(v)
        return ResourceUsage(count, total, self._ops)

    def _roll_hour(self) -> None:
        now = time.time()
        if now - self._hour_start >= 3600.0:
            self._hour_start = now
            self._ops = 0

    def record_op(self) -> None:
        """Count one operation against the hourly budget; raises when
        the budget is exhausted."""
        self._roll_hour()
        q = self.get_quota()
        if q is not None and q.max_ops_per_hour and \
                self._ops >= q.max_ops_per_hour:
            raise VaultError(
                f"namespace '{self.namespace}' exceeded "
                f"{q.max_ops_per_hour} ops/hour")
        self._ops += 1

    def check_write(self, new_bytes: int, is_new_secret: bool) -> None:
        """Enforce count/storage caps before a secret write."""
        q = self.get_quota()
        if q is None:
            return
        u = self.usage()
        if q.max_secrets and is_new_secret and \
                u.secret_count >= q.max_secrets:
            raise VaultError(
                f"namespace '{self.namespace}' at max_secrets="
                f"{q.max_secrets}")
        if q.max_storage_bytes and \
                u.storage_bytes + new_bytes > q.max_storage_bytes:
            raise VaultError(
                f"namespace '{self.namespace}' would exceed "
                f"max_storage_bytes={q.max_storage_bytes}")

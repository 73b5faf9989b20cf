"""Automated rotation policy management.

Capability parity with tensor_vault/src/rotation.rs: a declarative
RotationPolicy per secret (interval, generator, advance-notice window)
persisted in the store under ``_vrot:``; the manager reports due and
soon-due secrets and can rotate everything due in one call, generating
new values with the dynamic-secret generators (password / token) or
requiring manual rotation for generator "none".

The port's copy of ``neumann_tpu/vault/rotation.py``:
only its import lines differ.
"""

from __future__ import annotations

import json
import secrets as pysecrets
import string
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from neumann_tpu_torch.store.tensor_store import TensorData, TensorValue
from neumann_tpu_torch.utils.errors import VaultError

_PREFIX = "_vrot:"


@dataclass
class PasswordGen:
    length: int = 24
    symbols: bool = True

    def generate(self) -> str:
        alpha = string.ascii_letters + string.digits
        if self.symbols:
            alpha += "!@#$%^&*-_=+"
        return "".join(pysecrets.choice(alpha)
                       for _ in range(self.length))


@dataclass
class TokenGen:
    n_bytes: int = 32
    prefix: str = "ntk_"

    def generate(self) -> str:
        return self.prefix + pysecrets.token_urlsafe(self.n_bytes)


@dataclass
class RotationPolicy:
    secret_key: str
    interval_s: float
    generator: str = "none"         # none | password | token
    gen_config: dict = field(default_factory=dict)
    notify_before_s: float = 0.0
    last_rotated: float = 0.0

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @staticmethod
    def from_json(s: str) -> "RotationPolicy":
        return RotationPolicy(**json.loads(s))

    def due_at(self) -> float:
        return self.last_rotated + self.interval_s

    def make_value(self) -> Optional[str]:
        if self.generator == "password":
            return PasswordGen(**self.gen_config).generate()
        if self.generator == "token":
            return TokenGen(**self.gen_config).generate()
        return None                  # manual rotation required


class RotationManager:
    """Policy store + due-rotation driver over a TensorVault."""

    def __init__(self, vault):
        self.vault = vault
        self.store = vault.store
        self.namespace = vault.namespace

    def _key(self, secret_key: str) -> str:
        return f"{_PREFIX}{self.namespace}:{secret_key}"

    def define(self, policy: RotationPolicy,
               actor: str = "root") -> None:
        self.vault._require_root(actor, "rotation_policy")
        if policy.interval_s <= 0:
            raise VaultError("rotation interval must be positive")
        if policy.generator not in ("none", "password", "token"):
            raise VaultError(f"unknown generator {policy.generator}")
        if policy.last_rotated == 0.0:
            policy.last_rotated = time.time()
        td = TensorData()
        td.set("policy", TensorValue.scalar(policy.to_json()))
        self.store.put(self._key(policy.secret_key), td)

    def remove(self, secret_key: str, actor: str = "root") -> bool:
        self.vault._require_root(actor, "rotation_policy")
        return self.store.delete(self._key(secret_key))

    def list(self) -> List[RotationPolicy]:
        prefix = f"{_PREFIX}{self.namespace}:"
        out = []
        for k in self.store.scan(prefix):
            data = self.store.get(k)
            if data is not None and data.get("policy") is not None:
                out.append(RotationPolicy.from_json(
                    data.get("policy").value))
        return sorted(out, key=lambda p: p.secret_key)

    def due(self, now: Optional[float] = None) -> List[str]:
        now = time.time() if now is None else now
        return [p.secret_key for p in self.list() if p.due_at() <= now]

    def pending_notifications(self, now: Optional[float] = None
                              ) -> List[str]:
        """Secrets inside their advance-notice window but not yet due."""
        now = time.time() if now is None else now
        return [p.secret_key for p in self.list()
                if p.notify_before_s > 0
                and p.due_at() - p.notify_before_s <= now < p.due_at()]

    def rotate_due(self, now: Optional[float] = None,
                   actor: str = "root") -> Dict[str, str]:
        """Rotate every due secret with an auto-generator. Returns
        {key: "rotated" | "manual"} (manual = generator none; the old
        value stays until someone rotates it explicitly)."""
        self.vault._require_root(actor, "rotate_due")
        now = time.time() if now is None else now
        out: Dict[str, str] = {}
        for p in self.list():
            if p.due_at() > now:
                continue
            val = p.make_value()
            if val is None:
                out[p.secret_key] = "manual"
                continue
            self.vault.set(p.secret_key, val, actor=actor)
            p.last_rotated = now
            td = TensorData()
            td.set("policy", TensorValue.scalar(p.to_json()))
            self.store.put(self._key(p.secret_key), td)
            out[p.secret_key] = "rotated"
        return out

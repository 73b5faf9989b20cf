"""Scoped vault API: delegation chains, response wrapping, dependency
graph, dynamic secrets, secret templates.

Parity with the reference's scoped-secrets surface across
tensor_vault/src/{delegation,dependency,dynamic,wrapping,
template_store}.rs:

- ``vault.scope(actor)`` pins an actor so call sites stop threading it
- delegation: an actor re-grants a subset of its OWN access to a child
  (capability attenuation — never more than the parent holds), with TTL,
  delegation *chains* (child re-delegates; depth-limited), permission
  decay by chain depth (vault/attenuation.py), cascading revocation,
  and persistence (delegations survive a vault reopen and re-apply
  their grants)
- response wrapping: single-use, TTL'd tokens that unwrap to a value
  exactly once (Vault-style cubbyhole handoff).  The value is captured
  AT WRAP TIME, AES-GCM-encrypted with the token as AAD, and persisted
  — like wrapping.rs, the token is the only way back to the plaintext
- dependency graph: declare weighted secret->secret edges; impact
  analysis walks the closure (depth, per-edge weight, impact score =
  weight/depth) and reports affected agents from live grants;
  ``rotation_plan`` orders rotations by impact priority
- dynamic secrets: template-generated credentials (password / api-key /
  hex token) with TTL, renewable, listable, revocable; encrypted value
  + metadata persist under ``_vdyn:``
- template store: named, persisted generation templates (``_vtpl:``)

The port's copy of ``neumann_tpu/vault/scoped.py``:
only its import lines differ.
"""

from __future__ import annotations

import json
import secrets as pysecrets
import string
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from neumann_tpu_torch.vault.vault import Permission, _Grant
from neumann_tpu_torch.utils.errors import VaultError


@dataclass
class DelegationRecord:
    parent: str
    child: str
    keys: List[str]
    level: Permission
    expires_at: Optional[float]
    depth: int = 1          # hops from a non-delegated actor

    def live(self) -> bool:
        return self.expires_at is None or time.time() < self.expires_at


@dataclass
class ImpactReport:
    root_secret: str
    affected_secrets: List[str]
    affected_agents: List[str] = field(default_factory=list)
    depth: int = 0


@dataclass
class WeightedAffectedSecret:
    secret: str
    depth: int
    weight: str                  # critical / high / medium / low
    impact_score: float          # weight_value / depth


@dataclass
class WeightedImpactReport:
    root_secret: str
    affected_secrets: List[WeightedAffectedSecret]
    affected_agents: List[str]
    max_depth: int
    total_impact_score: float


@dataclass
class RotationPlan:
    root_secret: str
    rotation_order: List[WeightedAffectedSecret]   # priority desc
    total_secrets: int


@dataclass
class WrappingToken:
    token: str
    created_at: float
    expires_at: float
    consumed: bool = False


@dataclass
class DynamicSecretMeta:
    secret_id: str
    template: str
    created_at: float
    expires_at: float
    renewable: bool


# weight name -> numeric impact value (dependency.rs DependencyWeight)
_WEIGHTS = {"critical": 1.0, "high": 0.7, "medium": 0.4, "low": 0.1}


@dataclass
class PasswordConfig:
    length: int = 24
    symbols: bool = True


class SecretTemplate:
    """Factory namespace for dynamic-secret templates."""

    @staticmethod
    def password(config: Optional[PasswordConfig] = None):
        return ("password", config or PasswordConfig())

    @staticmethod
    def api_key(prefix: str = "nk"):
        return ("api_key", prefix)

    @staticmethod
    def hex_token(n_bytes: int = 32):
        return ("hex_token", n_bytes)


def _generate(template) -> Tuple[str, str]:
    kind, arg = template
    if kind == "password":
        alphabet = string.ascii_letters + string.digits
        if arg.symbols:
            alphabet += "!@#$%^&*-_=+"
        value = "".join(pysecrets.choice(alphabet)
                        for _ in range(arg.length))
    elif kind == "api_key":
        value = f"{arg}-{pysecrets.token_urlsafe(24)}"
    elif kind == "hex_token":
        value = pysecrets.token_hex(arg)
    else:
        raise VaultError(f"unknown secret template '{kind}'")
    return kind, value


def _template_to_json(template) -> dict:
    kind, arg = template
    if kind == "password":
        return {"kind": kind, "length": arg.length, "symbols": arg.symbols}
    if kind == "api_key":
        return {"kind": kind, "prefix": arg}
    if kind == "hex_token":
        return {"kind": kind, "n_bytes": arg}
    raise VaultError(f"unknown secret template '{kind}'")


def _template_from_json(doc: dict):
    kind = doc.get("kind")
    if kind == "password":
        return ("password", PasswordConfig(doc["length"], doc["symbols"]))
    if kind == "api_key":
        return ("api_key", doc["prefix"])
    if kind == "hex_token":
        return ("hex_token", doc["n_bytes"])
    raise VaultError(f"unknown stored template kind '{kind}'")


class ScopedVault:
    """All operations act as the pinned actor; shared state (delegations,
    wrap tokens, dependencies, dynamic secrets, templates) lives on the
    underlying vault — every scope over it sees the same records, and
    persisted records reload on vault reopen."""

    MAX_DELEGATION_DEPTH = 5

    def __init__(self, vault, actor: str):
        self.vault = vault
        self.actor = actor
        if not hasattr(vault, "_scoped_state"):
            vault._scoped_state = {
                "delegations": {},   # child -> DelegationRecord
                "deps": {},          # parent -> {child: weight_name}
                "dynamic": {},       # id -> DynamicSecretMeta
                "lock": threading.RLock(),
            }
            self._state = vault._scoped_state
            self._load_persisted()
        self._state = vault._scoped_state

    # -- persistence -------------------------------------------------------
    def _pkey(self, kind: str, name: str = "") -> str:
        return f"_v{kind}:{self.vault.namespace}:{name}"

    def _put_json(self, key: str, doc: dict) -> None:
        from neumann_tpu_torch.store.tensor_store import TensorData, TensorValue

        td = TensorData()
        td.set("j", TensorValue.scalar(json.dumps(doc)))
        self.vault.store.put(key, td)

    def _get_json(self, key: str) -> Optional[dict]:
        data = self.vault.store.get(key)
        if data is None or data.get("j") is None:
            return None
        return json.loads(data.get("j").value)

    def _load_persisted(self) -> None:
        """Reload delegations / dependencies / dynamic metadata from the
        store on first scope over a reopened vault.  Delegation grants
        re-apply so children keep their (attenuated) access."""
        st = self.vault._scoped_state
        for skey in self.vault.store.scan(self._pkey("del")):
            doc = self._get_json(skey)
            if doc is None:
                continue
            rec = DelegationRecord(
                doc["parent"], doc["child"], doc["keys"],
                Permission(doc["level"]), doc.get("expires_at"),
                doc.get("depth", 1))
            if not rec.live():
                self.vault.store.delete(skey)
                continue
            st["delegations"][rec.child] = rec
            with self.vault._lock:
                for key in rec.keys:
                    self.vault._grants[(rec.child, key)] = _Grant(
                        rec.level, rec.expires_at)
        doc = self._get_json(self._pkey("dep"))
        if doc is not None:
            st["deps"] = {p: dict(cs) for p, cs in doc.items()}
        for skey in self.vault.store.scan(self._pkey("dyn")):
            doc = self._get_json(skey)
            if doc is None:
                continue
            meta = DynamicSecretMeta(
                doc["secret_id"], doc["template"], doc["created_at"],
                doc["expires_at"], doc["renewable"])
            if meta.expires_at >= time.time():
                st["dynamic"][meta.secret_id] = meta

    def _persist_delegation(self, rec: DelegationRecord) -> None:
        self._put_json(self._pkey("del", rec.child), {
            "parent": rec.parent, "child": rec.child, "keys": rec.keys,
            "level": int(rec.level), "expires_at": rec.expires_at,
            "depth": rec.depth})

    def _persist_deps(self) -> None:
        self._put_json(self._pkey("dep"), self._state["deps"])

    # -- plain lifecycle, actor pinned -------------------------------------
    def set(self, key: str, value: str) -> None:
        self.vault.set(key, value, actor=self.actor)

    def get(self, key: str) -> str:
        return self.vault.get(key, actor=self.actor)

    def rotate(self, key: str, new_value: str) -> None:
        self.vault.rotate(key, new_value, actor=self.actor)

    def delete(self, key: str) -> bool:
        return self.vault.delete(key, actor=self.actor)

    def list(self, pattern: Optional[str] = None) -> List[str]:
        return self.vault.list(pattern, actor=self.actor)

    # -- delegation ---------------------------------------------------------
    def _level_on(self, key: str) -> Optional[Permission]:
        if self.actor == self.vault.ROOT:
            return Permission.ADMIN
        g = self.vault._grants.get((self.actor, key))
        return g.level if g is not None and g.live() else None

    def _my_depth(self) -> int:
        """Delegation hops between a non-delegated actor and me."""
        rec = self._state["delegations"].get(self.actor)
        return rec.depth if rec is not None and rec.live() else 0

    def delegate(self, child: str, keys: List[str], level: Permission,
                 ttl_seconds: Optional[float] = None) -> DelegationRecord:
        """Re-grant a subset of the actor's own access to `child`.

        Capability attenuation is enforced twice: the actor must hold
        >= `level` on every key it delegates, and the granted level
        decays with chain depth via the vault's attenuation policy
        (vault/attenuation.py; override with ``vault.attenuation``).
        Chains are depth-limited (delegation.rs max_depth)."""
        for key in keys:
            held = self._level_on(key)
            if held is None or held < level:
                raise VaultError(
                    f"'{self.actor}' cannot delegate {level.name} on "
                    f"'{key}' (holds {held.name if held else 'nothing'})")
        depth = self._my_depth() + 1
        if depth > self.MAX_DELEGATION_DEPTH:
            raise VaultError(
                f"delegation chain too deep ({depth} > "
                f"{self.MAX_DELEGATION_DEPTH})")
        policy = getattr(self.vault, "attenuation", None)
        if policy is None:
            from neumann_tpu_torch.vault.attenuation import AttenuationPolicy

            policy = AttenuationPolicy()
        eff = policy.attenuate(level, depth)
        if eff is None:
            raise VaultError(
                f"attenuation horizon: nothing survives {depth} hops")
        expires = time.time() + ttl_seconds if ttl_seconds else None
        with self.vault._lock:
            for key in keys:
                self.vault._grants[(child, key)] = _Grant(eff, expires)
        record = DelegationRecord(self.actor, child, list(keys), eff,
                                  expires, depth)
        with self._state["lock"]:
            self._state["delegations"][child] = record
        self._persist_delegation(record)
        self.vault._log(self.actor, "delegate", ",".join(keys), True)
        return record

    def children_of(self, parent: Optional[str] = None) -> List[str]:
        parent = parent if parent is not None else self.actor
        with self._state["lock"]:
            return sorted(c for c, r in self._state["delegations"].items()
                          if r.parent == parent and r.live())

    def descendants_of(self, entity: Optional[str] = None) -> List[str]:
        """Transitive delegation closure below `entity` (BFS order)."""
        entity = entity if entity is not None else self.actor
        with self._state["lock"]:
            kids: Dict[str, List[str]] = {}
            for c, r in self._state["delegations"].items():
                if r.live():
                    kids.setdefault(r.parent, []).append(c)
        out, frontier = [], sorted(kids.get(entity, []))
        seen = set(frontier)
        while frontier:
            cur = frontier.pop(0)
            out.append(cur)
            for nxt in sorted(kids.get(cur, [])):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        return out

    def delegation_depth(self, entity: Optional[str] = None) -> int:
        entity = entity if entity is not None else self.actor
        rec = self._state["delegations"].get(entity)
        return rec.depth if rec is not None and rec.live() else 0

    def revoke_delegation(self, child: str, cascade: bool = True
                          ) -> List[str]:
        """Revoke a delegation (and, by default, the whole sub-tree the
        child delegated onward — delegation.rs revoke_cascading).
        Returns the keys un-granted."""
        with self._state["lock"]:
            record = self._state["delegations"].get(child)
        if record is None:
            raise VaultError(f"no delegation to '{child}'")
        if record.parent != self.actor and self.actor != self.vault.ROOT:
            raise VaultError("only the delegating parent may revoke")
        doomed = [child] + (self.descendants_of(child) if cascade else [])
        revoked_keys: List[str] = []
        with self._state["lock"]:
            for ent in doomed:
                rec = self._state["delegations"].pop(ent, None)
                if rec is None:
                    continue
                with self.vault._lock:
                    for key in rec.keys:
                        self.vault._grants.pop((ent, key), None)
                revoked_keys.extend(rec.keys)
                self.vault.store.delete(self._pkey("del", ent))
        self.vault._log(self.actor, "revoke_delegation", child, True)
        return revoked_keys

    def cleanup_expired_delegations(self) -> int:
        """Drop expired delegation records (+ their grants)."""
        n = 0
        with self._state["lock"]:
            for child, rec in list(self._state["delegations"].items()):
                if rec.live():
                    continue
                self._state["delegations"].pop(child)
                with self.vault._lock:
                    for key in rec.keys:
                        self.vault._grants.pop((child, key), None)
                self.vault.store.delete(self._pkey("del", child))
                n += 1
        return n

    # -- response wrapping ----------------------------------------------------
    def wrap_secret(self, key: str, ttl_ms: int) -> str:
        """Single-use token redeemable for the secret's value until the
        TTL.  Access is checked NOW (at wrap time) as the wrapping
        actor, and the value is captured now — later rotations don't
        change what the token unwraps to (wrapping.rs semantics)."""
        return self.wrap_value(self.get(key), ttl_ms)

    def wrap_value(self, value: str, ttl_ms: int) -> str:
        """Wrap an arbitrary value (not necessarily a stored secret)
        behind a single-use token.  AES-GCM with the token as AAD; the
        ciphertext persists, so tokens survive a vault reopen."""
        token = pysecrets.token_hex(32)
        now = time.time()
        nonce = pysecrets.token_bytes(12)
        ct = self.vault._cipher().encrypt(
            nonce, value.encode("utf-8"), token.encode())
        self._put_json(self._pkey("wrap", token), {
            "created_at": now, "expires_at": now + ttl_ms / 1000.0,
            "blob": (nonce + ct).hex()})
        self.vault._log(self.actor, "wrap", token[:8], True)
        return token

    def unwrap_secret(self, token: str) -> str:
        skey = self._pkey("wrap", token)
        doc = self._get_json(skey)
        if doc is None:
            raise VaultError("invalid or already-used wrap token")
        self.vault.store.delete(skey)      # single use, even on expiry
        if time.time() > doc["expires_at"]:
            raise VaultError("wrap token expired")
        blob = bytes.fromhex(doc["blob"])
        try:
            pt = self.vault._cipher().decrypt(
                blob[:12], blob[12:], token.encode())
        except Exception as e:
            raise VaultError("wrap token decryption failed") from e
        self.vault._log(self.actor, "unwrap", token[:8], True)
        return pt.decode("utf-8")

    def wrapping_token_info(self, token: str) -> Optional[WrappingToken]:
        doc = self._get_json(self._pkey("wrap", token))
        if doc is None:
            return None
        return WrappingToken(token, doc["created_at"], doc["expires_at"],
                             consumed=False)

    # -- dependency graph -----------------------------------------------------
    def add_dependency(self, parent_key: str, child_key: str,
                       weight: str = "medium") -> None:
        """`child_key` depends on `parent_key` with a severity weight
        (critical/high/medium/low — dependency.rs DependencyWeight).
        Cycles are rejected."""
        if weight not in _WEIGHTS:
            raise VaultError(f"unknown dependency weight '{weight}'")
        with self._state["lock"]:
            deps: Dict[str, Dict[str, str]] = self._state["deps"]
            # reject cycles: child's closure must not reach parent
            frontier, seen = [child_key], set()
            while frontier:
                cur = frontier.pop()
                if cur == parent_key:
                    raise VaultError("dependency cycle rejected")
                if cur in seen:
                    continue
                seen.add(cur)
                frontier.extend(deps.get(cur, {}))
            deps.setdefault(parent_key, {})[child_key] = weight
            self._persist_deps()

    def remove_dependency(self, parent_key: str, child_key: str) -> bool:
        with self._state["lock"]:
            kids = self._state["deps"].get(parent_key)
            if kids is None or kids.pop(child_key, None) is None:
                return False
            if not kids:
                self._state["deps"].pop(parent_key)
            self._persist_deps()
            return True

    def get_dependencies(self, key: str) -> List[str]:
        """Secrets `key` depends on (its parents)."""
        with self._state["lock"]:
            return sorted(p for p, cs in self._state["deps"].items()
                          if key in cs)

    def get_dependents(self, key: str) -> List[str]:
        """Secrets that depend on `key` directly (its children)."""
        with self._state["lock"]:
            return sorted(self._state["deps"].get(key, {}))

    def _walk_closure(self, root_key: str
                      ) -> List[Tuple[str, int, str]]:
        """BFS the dependents closure: [(secret, depth, weight)]."""
        with self._state["lock"]:
            deps = {p: dict(cs) for p, cs in self._state["deps"].items()}
        out: List[Tuple[str, int, str]] = []
        seen: Set[str] = {root_key}
        frontier: List[Tuple[str, int]] = [(root_key, 0)]
        while frontier:
            cur, depth = frontier.pop(0)
            for child, weight in sorted(deps.get(cur, {}).items()):
                if child in seen:
                    continue
                seen.add(child)
                out.append((child, depth + 1, weight))
                frontier.append((child, depth + 1))
        return out

    def _agents_with_access(self, keys: Sequence[str]) -> List[str]:
        keyset = set(keys)
        with self.vault._lock:
            return sorted({e for (e, k), g in self.vault._grants.items()
                           if k in keyset and g.live()})

    def impact_analysis(self, root_key: str) -> ImpactReport:
        """Transitive closure of secrets affected by rotating root_key,
        plus the agents holding live grants on any of them."""
        closure = self._walk_closure(root_key)
        affected = [s for s, _, _ in closure]
        return ImpactReport(
            root_key, affected,
            affected_agents=self._agents_with_access(
                [root_key] + affected),
            depth=max((d for _, d, _ in closure), default=0))

    def weighted_impact_analysis(self, root_key: str
                                 ) -> WeightedImpactReport:
        """Per-edge severity: impact score = weight_value / depth
        (dependency.rs weighted_impact_analysis)."""
        closure = self._walk_closure(root_key)
        affected = [WeightedAffectedSecret(s, d, w, _WEIGHTS[w] / d)
                    for s, d, w in closure]
        return WeightedImpactReport(
            root_secret=root_key,
            affected_secrets=affected,
            affected_agents=self._agents_with_access(
                [root_key] + [a.secret for a in affected]),
            max_depth=max((a.depth for a in affected), default=0),
            total_impact_score=sum(a.impact_score for a in affected))

    def rotation_plan(self, root_key: str) -> RotationPlan:
        """Rotation order for root_key's blast radius, highest impact
        first (dependency.rs rotation_plan)."""
        report = self.weighted_impact_analysis(root_key)
        steps = sorted(report.affected_secrets,
                       key=lambda a: -a.impact_score)
        return RotationPlan(root_key, steps, len(steps))

    # -- secret templates (template_store.rs) ---------------------------------
    def save_template(self, name: str, template) -> None:
        doc = _template_to_json(template)
        doc.update({"created_by": self.actor, "created_at": time.time()})
        self._put_json(self._pkey("tpl", name), doc)
        self.vault._log(self.actor, "template_save", name, True)

    def get_template(self, name: str):
        doc = self._get_json(self._pkey("tpl", name))
        if doc is None:
            raise VaultError(f"no template '{name}'")
        return _template_from_json(doc)

    def list_templates(self) -> List[str]:
        prefix = self._pkey("tpl")
        return sorted(k[len(prefix):]
                      for k in self.vault.store.scan(prefix))

    def delete_template(self, name: str) -> bool:
        ok = self.vault.store.delete(self._pkey("tpl", name))
        self.vault._log(self.actor, "template_delete", name, ok)
        return ok

    # -- dynamic secrets --------------------------------------------------------
    def _persist_dynamic(self, meta: DynamicSecretMeta, value: str
                         ) -> None:
        nonce = pysecrets.token_bytes(12)
        ct = self.vault._cipher().encrypt(
            nonce, value.encode("utf-8"), meta.secret_id.encode())
        self._put_json(self._pkey("dyn", meta.secret_id), {
            "secret_id": meta.secret_id, "template": meta.template,
            "created_at": meta.created_at, "expires_at": meta.expires_at,
            "renewable": meta.renewable, "blob": (nonce + ct).hex()})

    def generate_dynamic_secret(self, template, ttl_ms: int,
                                renewable: bool = False
                                ) -> Tuple[str, str]:
        """Generate a credential from a template (or a stored template's
        name) with a TTL lease.  The value persists encrypted (AAD =
        lease id) so leases survive a vault reopen."""
        if isinstance(template, str):
            template = self.get_template(template)
        kind, value = _generate(template)
        secret_id = f"dyn-{pysecrets.token_hex(8)}"
        now = time.time()
        meta = DynamicSecretMeta(secret_id, kind, now,
                                 now + ttl_ms / 1000.0, renewable)
        with self._state["lock"]:
            self._state["dynamic"][secret_id] = meta
        self._persist_dynamic(meta, value)
        self.vault._log(self.actor, "dynamic_generate", secret_id, True)
        return secret_id, value

    def get_dynamic_secret(self, secret_id: str) -> str:
        doc = self._get_json(self._pkey("dyn", secret_id))
        if doc is None:
            raise VaultError(f"no dynamic secret '{secret_id}'")
        if time.time() > doc["expires_at"]:
            self.revoke_dynamic_secret(secret_id)
            raise VaultError(f"dynamic secret '{secret_id}' expired")
        blob = bytes.fromhex(doc["blob"])
        try:
            pt = self.vault._cipher().decrypt(
                blob[:12], blob[12:], secret_id.encode())
        except Exception as e:
            raise VaultError("dynamic secret decryption failed") from e
        return pt.decode("utf-8")

    def renew_dynamic_secret(self, secret_id: str, ttl_ms: int) -> None:
        doc = self._get_json(self._pkey("dyn", secret_id))
        if doc is None:
            raise VaultError(f"no dynamic secret '{secret_id}'")
        if not doc["renewable"]:
            raise VaultError(
                f"dynamic secret '{secret_id}' is not renewable")
        doc["expires_at"] = time.time() + ttl_ms / 1000.0
        self._put_json(self._pkey("dyn", secret_id), doc)
        with self._state["lock"]:
            meta = self._state["dynamic"].get(secret_id)
            if meta is not None:
                meta.expires_at = doc["expires_at"]

    def list_dynamic_secrets(self) -> List[DynamicSecretMeta]:
        now = time.time()
        with self._state["lock"]:
            for sid, meta in list(self._state["dynamic"].items()):
                if meta.expires_at < now:
                    self._state["dynamic"].pop(sid)
                    self.vault.store.delete(self._pkey("dyn", sid))
            return sorted(self._state["dynamic"].values(),
                          key=lambda m: m.created_at)

    def revoke_dynamic_secret(self, secret_id: str) -> None:
        with self._state["lock"]:
            known = self._state["dynamic"].pop(secret_id, None)
        ok = self.vault.store.delete(self._pkey("dyn", secret_id))
        if known is None and not ok:
            raise VaultError(f"no dynamic secret '{secret_id}'")
        self.vault._log(self.actor, "dynamic_revoke", secret_id, True)

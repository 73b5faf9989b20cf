"""Encrypted secret store.

Capability parity with tensor_vault (tensor_vault/src/vault.rs): AES-256-GCM
encryption at rest, KDF-derived master key (scrypt here; the reference uses
Argon2id), per-secret versioning with rollback, entity ACL grants with
permission levels and TTL, audit log, namespaces, rate limiting, key
zeroization on close. Secrets persist in the shared TensorStore under
``_vault:`` keys, so WAL/snapshot durability covers them.

The port's copy of ``neumann_tpu/vault/vault.py``:
only its import lines differ.
"""

from __future__ import annotations

import os
import secrets as pysecrets
import threading
import time
from dataclasses import dataclass, field
from enum import IntEnum
from fnmatch import fnmatch
from typing import Dict, List, Optional, Tuple

from cryptography.hazmat.primitives.ciphers.aead import AESGCM

from neumann_tpu_torch.store.tensor_store import TensorData, TensorStore, TensorValue
from neumann_tpu_torch.utils.errors import VaultError

_PREFIX = "_vault:"
_SALT_KEY = "_vault_meta:salt"


class Permission(IntEnum):
    READ = 1
    WRITE = 2
    ADMIN = 3


@dataclass
class _Grant:
    level: Permission
    expires_at: Optional[float] = None  # unix seconds

    def live(self) -> bool:
        return self.expires_at is None or time.time() < self.expires_at


@dataclass
class _AuditEvent:
    ts: float
    actor: str
    action: str
    key: str
    ok: bool


class TensorVault:
    """Root-identity vault; other identities act through grants."""

    ROOT = "root"

    def __init__(self, store: Optional[TensorStore] = None,
                 master_password: str = "",
                 namespace: str = "default",
                 rate_limit_per_min: int = 0,
                 anomaly_monitor=None,
                 obfuscate: bool = False):
        if not master_password:
            raise VaultError("master password required")
        # optional behavioral anomaly detection (vault/anomaly.py)
        self.anomaly = anomaly_monitor
        self._anomaly_events: list = []
        self.store = store if store is not None else TensorStore()
        self.namespace = namespace
        self._lock = threading.RLock()
        self._grants: Dict[Tuple[str, str], _Grant] = {}
        self._access = None          # graph topology: enable_graph_access()
        self._edge_signer = None
        self._attenuation = None
        self._audit: List[_AuditEvent] = []
        self._rate_limit = rate_limit_per_min
        self._rate_window: Dict[str, List[float]] = {}
        salt = self._load_or_create_salt()
        key = self._derive_key(master_password.encode(), salt)
        self._aead: Optional[AESGCM] = AESGCM(key)
        self._key = bytearray(key)
        # attribute-based policies + per-namespace quotas
        # (tensor_vault/src/{policy,quota}.rs capability)
        from neumann_tpu_torch.vault.policy import PolicyEngine
        from neumann_tpu_torch.vault.quota import QuotaManager

        self.policies = PolicyEngine(self.store, namespace)
        self.quotas = QuotaManager(self.store, namespace)
        # optional metadata/name obfuscation (obfuscation.rs)
        self._obf = None
        if obfuscate:
            from neumann_tpu_torch.vault.obfuscation import ObfuscationLayer

            self._obf = ObfuscationLayer(bytes(self._key))
        self._ensure_canary()
        # direct ACL grants persist (the reference stores ACL edges in
        # the shared store — tensor_vault/src/access.rs); reload the
        # live ones, reap the expired
        self._load_grants()
        # seal state persists: a sealed vault stays sealed on reopen
        # until unseal() verifies the password (seal.rs capability)
        self._sealed = False
        st = self.store.get(self._seal_state_key())
        if st is not None and st.get("sealed") is not None \
                and st.get("sealed").value:
            self._zeroize()
            self._sealed = True

    # -- key management --------------------------------------------------
    def _load_or_create_salt(self) -> bytes:
        data = self.store.get(_SALT_KEY)
        if data is not None:
            return data.get("salt").value
        salt = os.urandom(16)
        td = TensorData()
        td.set("salt", TensorValue.scalar(salt))
        self.store.put(_SALT_KEY, td)
        return salt

    @staticmethod
    def _derive_key(password: bytes, salt: bytes) -> bytes:
        """Master-key KDF.

        DELIBERATE DEVIATION from the reference: tensor_vault uses
        Argon2id (tensor_vault/src/key.rs). No Argon2 implementation
        ships in the Python stdlib and this build vendors no crypto
        dependencies, so the KDF is scrypt — the other
        memory-hard password KDF with first-class CVE-free stdlib
        support (hashlib.scrypt -> OpenSSL). Parameters follow the
        OWASP password-storage cheat-sheet recommendation for scrypt
        (N=2^14 soon-to-be-minimum work factor, r=8 => 16 MiB memory,
        p=1), giving the same brute-force-hardening role as the
        reference's Argon2id(m=19 MiB, t=2, p=1) defaults. If a
        packaging environment allows argon2-cffi, swap it in here —
        the derived-key length and salt handling are already
        compatible (32-byte key, 16-byte random salt).
        """
        import hashlib

        return hashlib.scrypt(password, salt=salt, n=2 ** 14, r=8, p=1,
                              dklen=32)

    def close(self) -> None:
        """Zeroize key material."""
        with self._lock:
            self._zeroize()

    def _zeroize(self) -> None:
        for i in range(len(self._key)):
            self._key[i] = 0
        self._aead = None

    def _cipher(self) -> AESGCM:
        if self._sealed:
            raise VaultError("vault is sealed")
        if self._aead is None:
            raise VaultError("vault is closed")
        return self._aead

    # -- seal / unseal (tensor_vault/src/seal.rs capability) ---------------
    _CANARY_AAD = b"neumann-vault-canary"

    def _seal_state_key(self) -> str:
        return f"_vault_meta:sealed:{self.namespace}"

    def _canary_key(self) -> str:
        return f"_vault_meta:check:{self.namespace}"

    def _ensure_canary(self) -> None:
        """A known plaintext encrypted under the master key, so
        unseal() can verify a password without touching secrets."""
        if self.store.get(self._canary_key()) is not None:
            return
        nonce = os.urandom(12)
        ct = self._aead.encrypt(nonce, b"ok", self._CANARY_AAD)
        td = TensorData()
        td.set("canary", TensorValue.scalar(nonce + ct))
        self.store.put(self._canary_key(), td)

    def _persist_seal_state(self, sealed: bool) -> None:
        td = TensorData()
        td.set("sealed", TensorValue.scalar(bool(sealed)))
        self.store.put(self._seal_state_key(), td)

    def is_sealed(self) -> bool:
        return self._sealed

    def seal(self, actor: str = "root") -> None:
        """Zeroize key material and refuse every operation until
        unseal(). Survives restarts (state persists in the store)."""
        self._require_root(actor, "seal")
        with self._lock:
            self._zeroize()
            self._sealed = True
            self._persist_seal_state(True)
        self._log(actor, "seal", "*", True)

    def unseal(self, master_password: str, actor: str = "root") -> None:
        """Re-derive the key and verify it against the canary; the
        vault stays sealed on a wrong password."""
        self._require_root(actor, "unseal")
        with self._lock:
            salt = self._load_or_create_salt()
            key = self._derive_key(master_password.encode(), salt)
            aead = AESGCM(key)
            data = self.store.get(self._canary_key())
            if data is not None:
                blob = data.get("canary").value
                try:
                    if aead.decrypt(blob[:12], blob[12:],
                                    self._CANARY_AAD) != b"ok":
                        raise VaultError("bad canary")
                except Exception:
                    self._log(actor, "unseal", "*", False)
                    raise VaultError("unseal failed: wrong password") \
                        from None
            self._aead = aead
            self._key = bytearray(key)
            if self._obf is not None:
                from neumann_tpu_torch.vault.obfuscation import (
                    ObfuscationLayer,
                )

                self._obf = ObfuscationLayer(key)
            self._sealed = False
            self._persist_seal_state(False)
        self._log(actor, "unseal", "*", True)

    # -- master-key rotation (tensor_vault/src/rotation.rs + key.rs) -------
    def rotate_master_key(self, new_password: str,
                          actor: str = "root") -> int:
        """Re-encrypt EVERY secret version and snapshot under a key
        derived from the new password + a fresh salt. Returns the
        number of ciphertexts rewritten."""
        self._require_root(actor, "rotate_master")
        with self._lock:
            old = self._cipher()
            new_salt = os.urandom(16)
            new_key = self._derive_key(new_password.encode(), new_salt)
            new_aead = AESGCM(new_key)

            def recrypt(blob: bytes, aad_old: bytes,
                        aad_new: bytes) -> bytes:
                pt = old.decrypt(blob[:12], blob[12:], aad_old)
                nonce = os.urandom(12)
                return nonce + new_aead.encrypt(nonce, pt, aad_new)

            # with obfuscation on, storage suffixes are MACs of the
            # master key, so the rotation also REKEYS them (the
            # encrypted name index supplies the logical names)
            new_obf = None
            suffix_map = {}
            if self._obf is not None:
                from neumann_tpu_torch.vault.obfuscation import (
                    ObfuscationLayer,
                )

                new_obf = ObfuscationLayer(new_key)
                for name in self._index_names():
                    suffix_map[self._obf.obfuscate_key(name)] = \
                        new_obf.obfuscate_key(name)

            rewritten = 0
            prefix = f"{_PREFIX}{self.namespace}:"
            for skey in list(self.store.scan(prefix)):
                data = self.store.get(skey)
                if data is None or data.get("cipher") is None:
                    continue
                suffix = skey[len(prefix):]
                new_suffix = suffix_map.get(suffix, suffix)
                aad_old = self._aad(suffix)
                aad_new = self._aad(new_suffix)
                td = TensorData()
                td.set("cipher", TensorValue.scalar(recrypt(
                    data.get("cipher").value, aad_old, aad_new)))
                versions = [recrypt(b, aad_old, aad_new)
                            for b in self._read_versions(data)]
                self._write_versions(td, versions)
                if new_suffix != suffix:
                    self.store.delete(skey)
                self.store.put(prefix + new_suffix, td)
                rewritten += 1 + len(versions)
            # snapshots hold ciphertexts too (PITR must survive the
            # rotation); obfuscated entries whose secret was deleted
            # before the rotation have unrecoverable names BY DESIGN
            # and drop out of the snapshot
            import json as _json

            snap_prefix = f"{self._SNAP_PREFIX}{self.namespace}:"
            for skey in list(self.store.scan(snap_prefix)):
                data = self.store.get(skey)
                if data is None or data.get("meta") is None:
                    continue
                meta = _json.loads(data.get("meta").value)
                td = TensorData()
                kept = []
                for i, suffix in enumerate(meta.get("keys", [])):
                    blob = data.get(f"c{i}")
                    if blob is None:
                        continue
                    if self._obf is not None and suffix not in suffix_map:
                        continue
                    new_suffix = suffix_map.get(suffix, suffix)
                    td.set(f"c{len(kept)}", TensorValue.scalar(recrypt(
                        blob.value, self._aad(suffix),
                        self._aad(new_suffix))))
                    kept.append(new_suffix)
                    rewritten += 1
                meta["keys"] = kept
                td.set("meta", TensorValue.scalar(_json.dumps(meta)))
                self.store.put(skey, td)

            # swap salt, canary, and live key LAST (any decrypt error
            # above aborts before the old key is discarded)
            td = TensorData()
            td.set("salt", TensorValue.scalar(new_salt))
            self.store.put(_SALT_KEY, td)
            self.store.delete(self._canary_key())
            self._aead = new_aead
            self._key = bytearray(new_key)
            if new_obf is not None:
                names = self._index_names()      # old layer decrypts
                self._obf = new_obf
                td = TensorData()
                td.set("ix", TensorValue.scalar(
                    self._obf.encrypt_metadata({"names": names})))
                self.store.put(self._index_key(), td)
            self._ensure_canary()
        self._log(actor, "rotate_master", "*", True)
        return rewritten

    # -- access control -----------------------------------------------------
    def _check(self, actor: str, key: str, need: Permission) -> None:
        if actor == self.ROOT:
            return
        grant = self._grants.get((actor, key))
        if grant is not None and grant.live() and grant.level >= need:
            return
        # no direct grant: attribute-based policies may still allow
        # (tensor_vault/src/policy.rs)
        pol = self.policies.permission_for(actor, key)
        if pol is not None and pol >= int(need):
            return
        # graph topology: signed access edges through group membership,
        # attenuated by distance (vault.rs:1204-1238
        # check_access_with_permission)
        if self._access is not None:
            node = self.secret_node_key(key)
            if self._access.check_path_with_permission_verified(
                    actor, node, need, self._edge_signer,
                    self._attenuation):
                return
            if self._access.check_path(actor, node):
                self._log(actor, "denied", key, False)
                raise VaultError(
                    f"'{actor}' has access but not {need.name} on '{key}'")
        self._log(actor, "denied", key, False)
        raise VaultError(f"'{actor}' lacks {need.name} on '{key}'")

    # -- graph-based (topological) access -------------------------------------
    def enable_graph_access(self, graph=None, signer_key: bytes = b"",
                            attenuation=None):
        """Turn on topological access control (vault.rs:1204-1285 +
        access.rs): permission checks additionally walk a graph of
        MEMBER (traversal-only) and HMAC-signed VAULT_ACCESS_* (grant)
        edges, with distance attenuation. Pass a GraphEngine to persist
        or share the topology; default is a private in-memory graph."""
        from neumann_tpu_torch.engines.graph import GraphEngine
        from neumann_tpu_torch.vault.access import AccessController, EdgeSigner
        from neumann_tpu_torch.vault.attenuation import AttenuationPolicy

        self._access = AccessController(
            graph if graph is not None else GraphEngine())
        self._edge_signer = EdgeSigner(signer_key or bytes(self._key))
        self._attenuation = (attenuation if attenuation is not None
                             else AttenuationPolicy())
        return self._access

    def secret_node_key(self, key: str) -> str:
        return f"vaultsecret:{self.namespace}:{key}"

    def add_to_group(self, member: str, group: str,
                     actor: str = "root") -> None:
        """MEMBER edge: traversal only, grants nothing by itself."""
        self._require_graph_access()
        if actor != self.ROOT:
            raise VaultError("only root manages group membership")
        self._access.add_member_edge(member, group)
        self._log(actor, "add_to_group", f"{member}->{group}", True)

    def grant_path(self, source: str, key: str,
                   level: Permission = Permission.READ,
                   capacity: Optional[Permission] = None,
                   actor: str = "root") -> None:
        """Signed access edge ``source -> secret(key)`` — source may be
        a group, in which case members inherit (attenuated)."""
        self._require_graph_access()
        self._check(actor, key, Permission.ADMIN)
        self._access.add_access_edge(
            source, self.secret_node_key(key), level,
            signer=self._edge_signer, timestamp=int(time.time()),
            capacity=capacity)
        self._log(actor, "grant_path", key, True)

    def get_permission(self, requester: str, key: str
                       ) -> Optional[Permission]:
        """Effective permission: direct grant, else policy, else the
        verified graph level (vault.rs:1271-1285 get_permission)."""
        if requester == self.ROOT:
            return Permission.ADMIN
        best: Optional[Permission] = None
        g = self._grants.get((requester, key))
        if g is not None and g.live():
            best = g.level
        pol = self.policies.permission_for(requester, key)
        if pol is not None:
            p = Permission(pol)
            best = p if best is None else max(best, p)
        if self._access is not None:
            gp = self._access.get_permission_level_verified(
                requester, self.secret_node_key(key), self._edge_signer,
                self._attenuation)
            if gp is not None:
                best = gp if best is None else max(best, gp)
        return best

    def _require_graph_access(self) -> None:
        if self._access is None:
            raise VaultError("call enable_graph_access() first")

    def _rate_check(self, actor: str) -> None:
        if not self._rate_limit:
            return
        now = time.time()
        window = self._rate_window.setdefault(actor, [])
        window[:] = [t for t in window if now - t < 60.0]
        if len(window) >= self._rate_limit:
            raise VaultError(f"rate limit exceeded for '{actor}'")
        window.append(now)

    def _grant_key(self, entity: str, key: str) -> str:
        # \x1f separates entity from secret name (either may contain ':')
        return f"_vgrant:{self.namespace}:{entity}\x1f{key}"

    def _load_grants(self) -> None:
        import json as _json

        for skey in list(self.store.scan(f"_vgrant:{self.namespace}:")):
            data = self.store.get(skey)
            if data is None or data.get("j") is None:
                continue
            doc = _json.loads(data.get("j").value)
            g = _Grant(Permission(doc["level"]), doc.get("expires_at"))
            if not g.live():
                self.store.delete(skey)
                continue
            self._grants[(doc["entity"], doc["key"])] = g

    def grant(self, entity: str, key: str,
              level: Permission = Permission.READ,
              ttl_seconds: Optional[float] = None,
              actor: str = "root") -> None:
        import json as _json

        self._check(actor, key, Permission.ADMIN)
        expires = time.time() + ttl_seconds if ttl_seconds else None
        with self._lock:
            self._grants[(entity, key)] = _Grant(level, expires)
        td = TensorData()
        td.set("j", TensorValue.scalar(_json.dumps(
            {"entity": entity, "key": key, "level": int(level),
             "expires_at": expires})))
        self.store.put(self._grant_key(entity, key), td)
        self._log(actor, "grant", key, True)

    def revoke(self, entity: str, key: str, actor: str = "root") -> None:
        self._check(actor, key, Permission.ADMIN)
        with self._lock:
            self._grants.pop((entity, key), None)
        self.store.delete(self._grant_key(entity, key))
        self._log(actor, "revoke", key, True)

    def grants_for(self, key: str) -> List[Tuple[str, str]]:
        with self._lock:
            return [(e, g.level.name) for (e, k), g in self._grants.items()
                    if k == key and g.live()]

    # -- secret CRUD ----------------------------------------------------------
    def _suffix(self, key: str) -> str:
        """Storage-name for a logical secret name (MAC'd when the
        obfuscation layer is on, so the store leaks no names)."""
        return (self._obf.obfuscate_key(key) if self._obf is not None
                else key)

    def _skey(self, key: str) -> str:
        return f"{_PREFIX}{self.namespace}:{self._suffix(key)}"

    def _aad(self, suffix: str) -> bytes:
        return f"{self.namespace}:{suffix}".encode("utf-8")

    # encrypted name index: with obfuscation on, list() cannot read
    # names from storage keys, so they live in one AEAD blob
    def _index_key(self) -> str:
        return f"_vault_meta:obfindex:{self.namespace}"

    def _index_names(self) -> list:
        data = self.store.get(self._index_key())
        if data is None or data.get("ix") is None:
            return []
        return self._obf.decrypt_metadata(
            data.get("ix").value).get("names", [])

    def _index_update(self, add=None, remove=None) -> None:
        if self._obf is None:
            return
        names = set(self._index_names())
        if add:
            names.add(add)
        if remove:
            names.discard(remove)
        td = TensorData()
        td.set("ix", TensorValue.scalar(
            self._obf.encrypt_metadata({"names": sorted(names)})))
        self.store.put(self._index_key(), td)

    _MAX_VERSIONS = 10

    @staticmethod
    def _read_versions(data: Optional[TensorData]) -> List[bytes]:
        if data is None:
            return []
        out = []
        i = 0
        while True:
            v = data.get(f"v{i}")
            if v is None:
                break
            out.append(v.value)
            i += 1
        return out

    @staticmethod
    def _write_versions(td: TensorData, versions: List[bytes]) -> None:
        for i, blob in enumerate(versions):
            td.set(f"v{i}", TensorValue.scalar(blob))

    def set(self, key: str, value: str, actor: str = "root") -> None:
        self._rate_check(actor)
        if actor != self.ROOT:
            self._check(actor, key, Permission.WRITE)
        self.quotas.record_op()
        nonce = os.urandom(12)
        pt = value.encode("utf-8")
        if self._obf is not None:
            pt = self._obf.pad(pt)      # length hiding
        ct = self._cipher().encrypt(nonce, pt,
                                    self._aad(self._suffix(key)))
        data = self.store.get(self._skey(key))
        self.quotas.check_write(len(ct) + 12, is_new_secret=data is None)
        versions = self._read_versions(data)
        if data is not None and data.get("cipher") is not None:
            versions.append(data.get("cipher").value)
            versions = versions[-self._MAX_VERSIONS:]
        td = TensorData()
        td.set("cipher", TensorValue.scalar(nonce + ct))
        self._write_versions(td, versions)
        self.store.put(self._skey(key), td)
        self._index_update(add=key)
        self._log(actor, "set", key, True)
        self._anomaly_check(actor, key)

    def get(self, key: str, actor: str = "root") -> str:
        self._rate_check(actor)
        if actor != self.ROOT:
            self._check(actor, key, Permission.READ)
        self.quotas.record_op()
        data = self.store.get(self._skey(key))
        if data is None:
            self._log(actor, "get", key, False)
            raise VaultError(f"no secret '{key}'")
        blob = data.get("cipher").value
        out = self._decrypt(blob, key)
        self._log(actor, "get", key, True)
        self._anomaly_check(actor, key)
        return out

    def _decrypt(self, blob: bytes, key: str) -> str:
        nonce, ct = blob[:12], blob[12:]
        aead = self._cipher()       # sealed/closed raise as themselves
        try:
            pt = aead.decrypt(nonce, ct, self._aad(self._suffix(key)))
        except Exception as e:
            raise VaultError("decryption failed (wrong key or tamper)") \
                from e
        if self._obf is not None:
            pt = self._obf.unpad(pt)
        return pt.decode("utf-8")

    def delete(self, key: str, actor: str = "root") -> bool:
        if actor != self.ROOT:
            self._check(actor, key, Permission.ADMIN)
        ok = self.store.delete(self._skey(key))
        if ok:
            self._index_update(remove=key)
        self._log(actor, "delete", key, ok)
        return ok

    def list(self, pattern: Optional[str] = None, actor: str = "root"
             ) -> List[str]:
        if self._obf is not None:
            keys = self._index_names()
        else:
            prefix = f"{_PREFIX}{self.namespace}:"
            keys = [k[len(prefix):] for k in self.store.scan(prefix)]
        if actor != self.ROOT:
            keys = [k for k in keys
                    if (g := self._grants.get((actor, k))) is not None
                    and g.live()]
        if pattern:
            keys = [k for k in keys if fnmatch(k, pattern)]
        return keys

    def rotate(self, key: str, new_value: str, actor: str = "root") -> None:
        """New version; old value retrievable via version history."""
        self.get(key, actor)  # must exist + perm check
        if actor != self.ROOT:
            self._check(actor, key, Permission.WRITE)
        self.set(key, new_value, actor)
        self._log(actor, "rotate", key, True)

    def versions(self, key: str, actor: str = "root") -> int:
        if actor != self.ROOT:
            self._check(actor, key, Permission.READ)
        data = self.store.get(self._skey(key))
        if data is None:
            raise VaultError(f"no secret '{key}'")
        return len(self._read_versions(data))

    def rollback_version(self, key: str, actor: str = "root") -> str:
        """Restore the previous version; returns the restored value."""
        if actor != self.ROOT:
            self._check(actor, key, Permission.ADMIN)
        data = self.store.get(self._skey(key))
        if data is None:
            raise VaultError(f"no secret '{key}'")
        versions = self._read_versions(data)
        if not versions:
            raise VaultError(f"no prior versions of '{key}'")
        prev = versions.pop()
        td = TensorData()
        td.set("cipher", TensorValue.scalar(prev))
        self._write_versions(td, versions)
        self.store.put(self._skey(key), td)
        self._log(actor, "rollback", key, True)
        return self._decrypt(prev, key)

    def _anomaly_check(self, actor: str, key: str) -> None:
        if self.anomaly is None:
            return
        events = self.anomaly.check(actor, key)
        if events:
            with self._lock:
                self._anomaly_events.extend(events)
                if len(self._anomaly_events) > 1000:
                    self._anomaly_events = self._anomaly_events[-1000:]

    def drain_anomalies(self) -> list:
        with self._lock:
            out, self._anomaly_events = self._anomaly_events, []
            return out

    def scope(self, actor: str) -> "ScopedVault":
        """Actor-pinned view with delegation / wrapping / dependencies /
        dynamic secrets (vault/scoped.py)."""
        from neumann_tpu_torch.vault.scoped import ScopedVault

        return ScopedVault(self, actor)

    # -- point-in-time recovery (snapshots) -------------------------------
    # Parity with the reference's vault PITR
    # (integration_tests/tests/vault_pitr_sync.rs): root-only snapshot
    # create/list/restore/delete; restore overwrites the captured secrets
    # but does NOT delete secrets added after the snapshot. Ciphertexts
    # are captured as-is (never decrypted), so snapshots are as safe at
    # rest as the secrets themselves and persist via the shared store.

    _SNAP_PREFIX = "_vault_snap:"

    def _snap_key(self, snap_id: str) -> str:
        return f"{self._SNAP_PREFIX}{self.namespace}:{snap_id}"

    def _require_root(self, actor: str, action: str) -> None:
        if actor != self.ROOT:
            self._log(actor, action, "*", False)
            raise VaultError(f"{action} requires root")

    def create_snapshot(self, actor: str = "root", label: str = "") -> str:
        self._require_root(actor, "snapshot")
        snap_id = f"snap-{int(time.time() * 1000):x}-{pysecrets.token_hex(4)}"
        prefix = f"{_PREFIX}{self.namespace}:"
        td = TensorData()
        names: List[str] = []
        for skey in self.store.scan(prefix):
            data = self.store.get(skey)
            if data is None or data.get("cipher") is None:
                continue
            name = skey[len(prefix):]
            td.set(f"c{len(names)}", TensorValue.scalar(
                data.get("cipher").value))
            names.append(name)
        import json

        td.set("meta", TensorValue.scalar(json.dumps(
            {"id": snap_id, "label": label, "created_at": time.time(),
             "keys": names})))
        self.store.put(self._snap_key(snap_id), td)
        self._log(actor, "snapshot", snap_id, True)
        return snap_id

    def list_snapshots(self, actor: str = "root") -> List[dict]:
        self._require_root(actor, "snapshot_list")
        import json

        out = []
        prefix = f"{self._SNAP_PREFIX}{self.namespace}:"
        for skey in self.store.scan(prefix):
            data = self.store.get(skey)
            if data is None or data.get("meta") is None:
                continue
            meta = json.loads(data.get("meta").value)
            out.append({"id": meta["id"], "label": meta.get("label", ""),
                        "created_at": meta["created_at"],
                        "n_secrets": len(meta.get("keys", []))})
        return sorted(out, key=lambda m: m["created_at"])

    def restore_snapshot(self, snapshot_id: str, actor: str = "root"
                         ) -> int:
        """Restore every secret captured in the snapshot; the displaced
        current values are pushed onto each secret's version history.
        Returns the number of secrets restored."""
        self._require_root(actor, "restore")
        data = self.store.get(self._snap_key(snapshot_id))
        if data is None:
            raise VaultError(f"no snapshot '{snapshot_id}'")
        import json

        meta = json.loads(data.get("meta").value)
        restored = 0
        prefix = f"{_PREFIX}{self.namespace}:"
        for i, suffix in enumerate(meta.get("keys", [])):
            blob = data.get(f"c{i}")
            if blob is None:
                continue
            # keys in the snapshot are STORAGE suffixes (obfuscated
            # names stay obfuscated; never re-MAC them)
            skey = prefix + suffix
            cur = self.store.get(skey)
            versions = self._read_versions(cur)
            if cur is not None and cur.get("cipher") is not None:
                versions.append(cur.get("cipher").value)
                versions = versions[-self._MAX_VERSIONS:]
            td = TensorData()
            td.set("cipher", TensorValue.scalar(blob.value))
            self._write_versions(td, versions)
            self.store.put(skey, td)
            restored += 1
        self._log(actor, "restore", snapshot_id, True)
        return restored

    def delete_snapshot(self, snapshot_id: str, actor: str = "root"
                        ) -> bool:
        self._require_root(actor, "snapshot_delete")
        ok = self.store.delete(self._snap_key(snapshot_id))
        self._log(actor, "snapshot_delete", snapshot_id, ok)
        return ok

    # -- audit ------------------------------------------------------------------
    def _log(self, actor: str, action: str, key: str, ok: bool) -> None:
        with self._lock:
            self._audit.append(_AuditEvent(time.time(), actor, action,
                                           key, ok))
            if len(self._audit) > 10_000:
                self._audit = self._audit[-5_000:]

    def audit_log(self, limit: int = 100) -> List[dict]:
        with self._lock:
            return [e.__dict__ for e in self._audit[-limit:]]

"""PKI engine: internal CA, certificate issuance, revocation, CRL.

Parity with tensor_vault/src/pki.rs (PkiEngine): init_ca creates a
self-signed CA whose material lives in the shared TensorStore
(``_vpki_ca:``), issue_certificate signs leaf certs with SANs and TTL,
issued certs are tracked under ``_vpki:{serial}`` for list/revoke/CRL,
and verify_certificate checks signature + validity window + revocation.
Uses the ``cryptography`` package (the reference uses rcgen).

The port's copy of ``neumann_tpu/vault/pki.py``:
only its import lines differ.
"""

from __future__ import annotations

import datetime
import ipaddress
import json
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from neumann_tpu_torch.store.tensor_store import TensorData, TensorStore, TensorValue
from neumann_tpu_torch.utils.errors import VaultError

_PKI_PREFIX = "_vpki:"
_CA_KEY = "_vpki_ca:"


@dataclass
class CertInfo:
    serial: str
    subject: str
    issuer: str
    not_before_ms: int
    not_after_ms: int
    revoked: bool


def _now():
    return datetime.datetime.now(datetime.timezone.utc)


def _name(common_name: str):
    from cryptography import x509
    from cryptography.x509.oid import NameOID

    return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         common_name)])


def _san_list(sans: List[str]):
    from cryptography import x509

    out = []
    for san in sans:
        try:
            out.append(x509.IPAddress(ipaddress.ip_address(san)))
        except ValueError:
            out.append(x509.DNSName(san))
    return out


class PkiEngine:
    """All methods are static over a TensorStore, like the reference."""

    @staticmethod
    def init_ca(store: TensorStore, common_name: str = "neumann-tpu-ca",
                ttl_days: int = 3650) -> bytes:
        """Create (or return) the internal CA; returns the CA cert PEM."""
        existing = store.get(_CA_KEY)
        if existing is not None:
            return existing.get("cert").value
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec

        key = ec.generate_private_key(ec.SECP256R1())
        name = _name(common_name)
        now = _now()
        cert = (x509.CertificateBuilder()
                .subject_name(name).issuer_name(name)
                .public_key(key.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now)
                .not_valid_after(now + datetime.timedelta(days=ttl_days))
                .add_extension(x509.BasicConstraints(ca=True,
                                                     path_length=0),
                               critical=True)
                .sign(key, hashes.SHA256()))
        td = TensorData()
        td.set("cert", TensorValue.scalar(
            cert.public_bytes(serialization.Encoding.PEM)))
        td.set("key", TensorValue.scalar(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption())))
        store.put(_CA_KEY, td)
        return cert.public_bytes(serialization.Encoding.PEM)

    @staticmethod
    def _load_ca(store: TensorStore):
        from cryptography import x509
        from cryptography.hazmat.primitives.serialization import (
            load_pem_private_key,
        )

        data = store.get(_CA_KEY)
        if data is None:
            raise VaultError("CA not initialized (call init_ca)")
        cert = x509.load_pem_x509_certificate(data.get("cert").value)
        key = load_pem_private_key(data.get("key").value, password=None)
        return cert, key

    @staticmethod
    def issue_certificate(store: TensorStore, subject: str,
                          sans: Optional[List[str]] = None,
                          ttl_days: int = 365
                          ) -> Tuple[bytes, bytes, str]:
        """(cert_pem, key_pem, serial) for a CA-signed leaf cert."""
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import ec

        ca_cert, ca_key = PkiEngine._load_ca(store)
        key = ec.generate_private_key(ec.SECP256R1())
        now = _now()
        builder = (x509.CertificateBuilder()
                   .subject_name(_name(subject))
                   .issuer_name(ca_cert.subject)
                   .public_key(key.public_key())
                   .serial_number(x509.random_serial_number())
                   .not_valid_before(now)
                   .not_valid_after(now + datetime.timedelta(
                       days=ttl_days))
                   .add_extension(x509.BasicConstraints(ca=False,
                                                        path_length=None),
                                  critical=True))
        if sans:
            builder = builder.add_extension(
                x509.SubjectAlternativeName(_san_list(sans)),
                critical=False)
        cert = builder.sign(ca_key, hashes.SHA256())
        serial = format(cert.serial_number, "x")
        cert_pem = cert.public_bytes(serialization.Encoding.PEM)
        info = {"serial": serial, "subject": subject,
                "issuer": ca_cert.subject.rfc4514_string(),
                "not_before_ms": int(now.timestamp() * 1000),
                "not_after_ms": int((now + datetime.timedelta(
                    days=ttl_days)).timestamp() * 1000),
                "revoked": False}
        td = TensorData()
        td.set("info", TensorValue.scalar(json.dumps(info)))
        td.set("cert", TensorValue.scalar(cert_pem))
        store.put(f"{_PKI_PREFIX}{serial}", td)
        key_pem = key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption())
        return cert_pem, key_pem, serial

    @staticmethod
    def list_certificates(store: TensorStore) -> List[CertInfo]:
        out = []
        for k in store.scan(_PKI_PREFIX):
            data = store.get(k)
            if data is None or data.get("info") is None:
                continue
            info = json.loads(data.get("info").value)
            out.append(CertInfo(**{k: v for k, v in info.items()
                                   if k in CertInfo.__annotations__}))
        return sorted(out, key=lambda c: c.serial)

    @staticmethod
    def revoke_certificate(store: TensorStore, serial: str) -> None:
        key = f"{_PKI_PREFIX}{serial}"
        data = store.get(key)
        if data is None:
            raise VaultError(f"unknown certificate serial '{serial}'")
        info = json.loads(data.get("info").value)
        info["revoked"] = True
        info["revoked_at_ms"] = int(time.time() * 1000)
        td = TensorData()
        td.set("info", TensorValue.scalar(json.dumps(info)))
        td.set("cert", TensorValue.scalar(data.get("cert").value))
        store.put(key, td)

    @staticmethod
    def is_revoked(store: TensorStore, serial: str) -> bool:
        data = store.get(f"{_PKI_PREFIX}{serial}")
        if data is None:
            return False
        return bool(json.loads(data.get("info").value).get("revoked"))

    @staticmethod
    def generate_crl(store: TensorStore) -> bytes:
        """Signed X.509 CRL of all revoked serials, PEM-encoded."""
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization

        ca_cert, ca_key = PkiEngine._load_ca(store)
        now = _now()
        builder = (x509.CertificateRevocationListBuilder()
                   .issuer_name(ca_cert.subject)
                   .last_update(now)
                   .next_update(now + datetime.timedelta(days=7)))
        for info in PkiEngine.list_certificates(store):
            if info.revoked:
                builder = builder.add_revoked_certificate(
                    x509.RevokedCertificateBuilder()
                    .serial_number(int(info.serial, 16))
                    .revocation_date(now)
                    .build())
        crl = builder.sign(ca_key, hashes.SHA256())
        return crl.public_bytes(serialization.Encoding.PEM)

    @staticmethod
    def get_ca_certificate(store: TensorStore) -> bytes:
        data = store.get(_CA_KEY)
        if data is None:
            raise VaultError("CA not initialized")
        return data.get("cert").value

    @staticmethod
    def verify_certificate(store: TensorStore, cert_pem: bytes) -> bool:
        """CA signature + validity window + not revoked."""
        from cryptography import x509
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives.asymmetric import ec

        ca_cert, _ = PkiEngine._load_ca(store)
        cert = x509.load_pem_x509_certificate(cert_pem)
        try:
            ca_cert.public_key().verify(
                cert.signature, cert.tbs_certificate_bytes,
                ec.ECDSA(cert.signature_hash_algorithm))
        except InvalidSignature:
            return False
        now = _now()
        if not (cert.not_valid_before_utc <= now
                <= cert.not_valid_after_utc):
            return False
        return not PkiEngine.is_revoked(store,
                                        format(cert.serial_number, "x"))

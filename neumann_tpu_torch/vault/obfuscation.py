"""Obfuscation layer: hide secret names, lengths, and storage patterns.

Capability parity with tensor_vault/src/obfuscation.rs:
- key obfuscation: storage keys are keyed-BLAKE2b MACs of the secret
  name, so the store reveals nothing about what is stored;
- length hiding: plaintexts pad (with a u32 length prefix) to the next
  block size from {256, 1K, 4K, 16K, 32K}, so ciphertext length leaks
  only a coarse bucket;
- metadata AEAD: arbitrary metadata dicts encrypt with per-record
  nonces under the same master key.

The port's copy of ``neumann_tpu/vault/obfuscation.py``:
only its import lines differ.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Dict

from cryptography.hazmat.primitives.ciphers.aead import AESGCM

from neumann_tpu_torch.utils.errors import VaultError

PADDING_SIZES = (256, 1024, 4096, 16384, 32768)
MAX_PLAINTEXT = PADDING_SIZES[-1] - 4


class ObfuscationLayer:
    def __init__(self, key: bytes):
        if len(key) != 32:
            raise VaultError("obfuscation needs a 32-byte key")
        self._mac_key = hashlib.blake2b(
            key, key=b"neumann-obf-mac", digest_size=32).digest()
        self._aead = AESGCM(hashlib.blake2b(
            key, key=b"neumann-obf-enc", digest_size=32).digest())

    # -- key obfuscation ---------------------------------------------------
    def obfuscate_key(self, name: str) -> str:
        return hashlib.blake2b(name.encode("utf-8"), key=self._mac_key,
                               digest_size=24).hexdigest()

    # -- length hiding -----------------------------------------------------
    @staticmethod
    def pad(plaintext: bytes) -> bytes:
        if len(plaintext) > MAX_PLAINTEXT:
            raise VaultError(
                f"plaintext over {MAX_PLAINTEXT} bytes")
        framed = struct.pack("<I", len(plaintext)) + plaintext
        for size in PADDING_SIZES:
            if len(framed) <= size:
                return framed + b"\0" * (size - len(framed))
        raise VaultError("unreachable: size table exhausted")

    @staticmethod
    def unpad(padded: bytes) -> bytes:
        if len(padded) < 4:
            raise VaultError("padded blob too short")
        (n,) = struct.unpack_from("<I", padded, 0)
        if 4 + n > len(padded):
            raise VaultError("corrupt padding frame")
        return padded[4: 4 + n]

    # -- metadata AEAD -----------------------------------------------------
    def encrypt_metadata(self, meta: Dict[str, object]) -> bytes:
        nonce = os.urandom(12)
        blob = json.dumps(meta, separators=(",", ":")).encode("utf-8")
        return nonce + self._aead.encrypt(nonce, self.pad(blob), b"meta")

    def decrypt_metadata(self, blob: bytes) -> Dict[str, object]:
        nonce, ct = blob[:12], blob[12:]
        try:
            padded = self._aead.decrypt(nonce, ct, b"meta")
        except Exception as e:
            raise VaultError("metadata decrypt failed") from e
        return json.loads(self.unpad(padded).decode("utf-8"))

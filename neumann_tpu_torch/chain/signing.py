"""Ed25519 node identities with geometric embedding derivation.

Parity with tensor_chain/src/signing.rs: each cluster node holds an
Ed25519 keypair; blocks/messages are signed and verified against the
known public keys; the node's "geometric identity" is a deterministic
unit embedding derived from its public key (used by geometric
membership ranking).

The port's copy of ``neumann_tpu/chain/signing.py``:
only its import lines differ.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey,
    Ed25519PublicKey,
)
from cryptography.exceptions import InvalidSignature

from neumann_tpu_torch.utils.errors import ChainError


class NodeIdentity:
    def __init__(self, private_key: Optional[Ed25519PrivateKey] = None):
        self._sk = private_key or Ed25519PrivateKey.generate()
        self._pk = self._sk.public_key()

    # -- keys -----------------------------------------------------------
    @staticmethod
    def from_seed(seed: bytes) -> "NodeIdentity":
        if len(seed) != 32:
            seed = hashlib.sha256(seed).digest()
        return NodeIdentity(Ed25519PrivateKey.from_private_bytes(seed))

    def public_bytes(self) -> bytes:
        from cryptography.hazmat.primitives.serialization import (
            Encoding,
            PublicFormat,
        )

        return self._pk.public_bytes(Encoding.Raw, PublicFormat.Raw)

    # -- signing -----------------------------------------------------------
    def sign(self, message: bytes) -> bytes:
        return self._sk.sign(message)

    @staticmethod
    def verify(public_bytes: bytes, message: bytes,
               signature: bytes) -> bool:
        try:
            Ed25519PublicKey.from_public_bytes(public_bytes).verify(
                signature, message)
            return True
        except (InvalidSignature, ValueError):
            return False

    # -- geometric identity --------------------------------------------------
    def embedding(self, dim: int = 64) -> np.ndarray:
        """Deterministic unit vector derived from the public key."""
        return derive_embedding(self.public_bytes(), dim)


def derive_embedding(public_bytes: bytes, dim: int = 64) -> np.ndarray:
    out = np.empty(dim, np.float32)
    counter = 0
    i = 0
    while i < dim:
        h = hashlib.blake2b(public_bytes + counter.to_bytes(4, "little"),
                            digest_size=32).digest()
        for off in range(0, 32, 4):
            if i >= dim:
                break
            word = int.from_bytes(h[off: off + 4], "little")
            out[i] = (word / 2 ** 32) * 2.0 - 1.0
            i += 1
        counter += 1
    norm = float(np.linalg.norm(out))
    return out / norm if norm > 0 else out


def sign_block(identity: NodeIdentity, block) -> None:
    """Attach an Ed25519 signature to a chain Block (replaces the
    default HMAC when cluster identities are in play)."""
    block.signature = "ed25519:" + identity.sign(
        block.header_bytes()).hex()


def verify_block(public_bytes: bytes, block) -> bool:
    sig = block.signature
    if not sig.startswith("ed25519:"):
        raise ChainError("block is not ed25519-signed")
    return NodeIdentity.verify(public_bytes, block.header_bytes(),
                               bytes.fromhex(sig[len("ed25519:"):]))

"""Shamir secret sharing over GF(256).

Parity with tensor_vault/src/shamir.rs: split a secret into n shares
with threshold k; any k shares reconstruct, k-1 reveal nothing. Each
byte of the secret is the constant term of a random degree-(k-1)
polynomial over GF(2^8) (AES polynomial 0x11B); share i is the
polynomial evaluated at x=i.

The port's copy of ``neumann_tpu/vault/shamir.py``:
only its import lines differ.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

from neumann_tpu_torch.utils.errors import VaultError

_EXP = [0] * 512
_LOG = [0] * 256


def _init_tables() -> None:
    x = 1
    for i in range(255):
        _EXP[i] = x
        _LOG[x] = i
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)
        x &= 0xFF
    for i in range(255, 512):
        _EXP[i] = _EXP[i - 255]


_init_tables()


def _mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP[_LOG[a] + _LOG[b]]


def _div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError
    if a == 0:
        return 0
    return _EXP[(_LOG[a] - _LOG[b]) % 255]


def _eval_poly(coeffs: List[int], x: int) -> int:
    out = 0
    for c in reversed(coeffs):
        out = _mul(out, x) ^ c
    return out


def split(secret: bytes, n: int, k: int) -> Dict[int, bytes]:
    """Split into n shares, threshold k. Returns {x: share_bytes}."""
    if not (1 <= k <= n <= 255):
        raise VaultError("need 1 <= k <= n <= 255")
    shares = {x: bytearray() for x in range(1, n + 1)}
    for byte in secret:
        coeffs = [byte] + list(os.urandom(k - 1))
        for x in shares:
            shares[x].append(_eval_poly(coeffs, x))
    return {x: bytes(b) for x, b in shares.items()}


def combine(shares: Dict[int, bytes]) -> bytes:
    """Lagrange interpolation at x=0 over any >= k shares."""
    if not shares:
        raise VaultError("no shares")
    xs = list(shares)
    lengths = {len(v) for v in shares.values()}
    if len(lengths) != 1:
        raise VaultError("share length mismatch")
    (length,) = lengths
    out = bytearray()
    for i in range(length):
        acc = 0
        for xj in xs:
            num, den = 1, 1
            for xm in xs:
                if xm == xj:
                    continue
                num = _mul(num, xm)
                den = _mul(den, xj ^ xm)
            acc ^= _mul(shares[xj][i], _div(num, den))
        out.append(acc)
    return bytes(out)

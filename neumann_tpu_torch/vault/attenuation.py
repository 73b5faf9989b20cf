"""Distance-based permission attenuation.

Parity with tensor_vault/src/attenuation.rs: permissions degrade with
graph/delegation distance (hop count).  Two policies:

- ``AttenuationPolicy`` — step thresholds: ADMIN preserved within
  ``admin_limit`` hops, decays to WRITE within ``write_limit``, READ
  beyond, nothing past ``horizon``.
- ``ExponentialAttenuationPolicy`` — permission strength decays as
  ``exp(-decay_rate * hops)`` and thresholds map the continuous
  strength back to discrete levels.

Both offer a vectorized ``attenuate_batch`` (numpy) so access-matrix
sweeps (vault/intel.py) can attenuate whole permission tensors at
once instead of looping Python-side.

The port's copy of ``neumann_tpu/vault/attenuation.py``:
only its import lines differ.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from neumann_tpu_torch.vault.vault import Permission


@dataclass
class AttenuationPolicy:
    """Step attenuation (attenuation.rs AttenuationPolicy)."""

    admin_limit: int = 1      # hops at which ADMIN is still preserved
    write_limit: int = 2      # hops at which WRITE is still preserved
    horizon: int = 10         # hard traversal cutoff

    @classmethod
    def none(cls) -> "AttenuationPolicy":
        """No attenuation: ADMIN at any depth (legacy behavior)."""
        big = 1 << 30
        return cls(admin_limit=big, write_limit=big, horizon=big)

    def attenuate(self, perm: Permission, hops: int
                  ) -> Optional[Permission]:
        if hops > self.horizon:
            return None
        if perm == Permission.ADMIN:
            if hops <= self.admin_limit:
                return Permission.ADMIN
            return Permission.WRITE if hops <= self.write_limit \
                else Permission.READ
        if perm == Permission.WRITE:
            return Permission.WRITE if hops <= self.write_limit \
                else Permission.READ
        return Permission.READ

    def attenuate_batch(self, levels: np.ndarray, hops: np.ndarray
                        ) -> np.ndarray:
        """Vectorized: int levels [..] x hop counts [..] -> attenuated
        int levels, 0 where past the horizon."""
        levels = np.asarray(levels, np.int64)
        hops = np.asarray(hops, np.int64)
        out = np.minimum(levels, int(Permission.READ))  # READ floor
        out = np.where(
            (levels >= int(Permission.WRITE)) & (hops <= self.write_limit),
            np.minimum(levels, int(Permission.WRITE)), out)
        out = np.where(
            (levels >= int(Permission.ADMIN)) & (hops <= self.admin_limit),
            int(Permission.ADMIN), out)
        return np.where(hops > self.horizon, 0, out)


@dataclass
class ExponentialAttenuationPolicy:
    """Smooth decay (attenuation.rs ExponentialAttenuationPolicy):
    strength ``exp(-decay_rate * hops)`` mapped to levels by
    thresholds."""

    decay_rate: float = 0.5
    admin_threshold: float = 0.7
    write_threshold: float = 0.3
    read_threshold: float = 0.05
    max_depth: int = 20

    def strength(self, hops: int) -> float:
        return float(np.exp(-self.decay_rate * hops))

    def attenuate(self, perm: Permission, hops: int
                  ) -> Optional[Permission]:
        if hops > self.max_depth:
            return None
        s = self.strength(hops)
        if s < self.read_threshold:
            return None
        if perm == Permission.ADMIN and s >= self.admin_threshold:
            return Permission.ADMIN
        if perm >= Permission.WRITE and s >= self.write_threshold:
            return min(perm, Permission.WRITE)
        return Permission.READ

    def attenuate_batch(self, levels: np.ndarray, hops: np.ndarray
                        ) -> np.ndarray:
        levels = np.asarray(levels, np.int64)
        hops = np.asarray(hops, np.int64)
        s = np.exp(-self.decay_rate * hops.astype(np.float64))
        out = np.minimum(levels, int(Permission.READ))
        out = np.where((levels >= int(Permission.WRITE))
                       & (s >= self.write_threshold),
                       np.minimum(levels, int(Permission.WRITE)), out)
        out = np.where((levels >= int(Permission.ADMIN))
                       & (s >= self.admin_threshold),
                       int(Permission.ADMIN), out)
        dead = (hops > self.max_depth) | (s < self.read_threshold)
        return np.where(dead, 0, out)

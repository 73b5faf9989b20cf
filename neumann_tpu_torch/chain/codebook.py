"""Hierarchical vector-quantization codebooks for chain state.

Parity with tensor_chain/src/codebook.rs: a static GlobalCodebook of
archetype centroids validates/compresses block delta embeddings, and a
per-domain LocalCodebook adapts with EMA updates as new deltas commit.
Quantizing a block's delta to its nearest code both compresses history
(store the code id, not the vector) and flags anomalous transitions
(distance above a calibrated threshold).

The port's copy of ``neumann_tpu/chain/codebook.py``: only its
import lines differ, and its books take the ``device`` their k-means
runs on at scale (the chain's own; "cuda" by default), as the JAX
package's runs on its default device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class GlobalCodebook:
    """Static codebook trained once over representative deltas."""

    def __init__(self, dim: int, n_codes: int = 64, device="cuda"):
        self.dim = dim
        self.n_codes = n_codes
        self.device = device
        self.codes: Optional[np.ndarray] = None
        self._threshold: Optional[float] = None

    def train(self, deltas: np.ndarray, iters: int = 20) -> None:
        from neumann_tpu_torch.parallel.partitioner import kmeans

        x = np.asarray(deltas, np.float32)
        self.codes = kmeans(x, min(self.n_codes, len(x)), iters,
                            device=self.device)
        # calibrate anomaly threshold: p99 of training distances
        d = self._distances(x)
        self._threshold = float(np.percentile(d.min(axis=1), 99)) * 1.5

    def _distances(self, x: np.ndarray) -> np.ndarray:
        c = self.codes
        return (np.sum(x * x, 1)[:, None] - 2 * x @ c.T
                + np.sum(c * c, 1)[None, :])

    def quantize(self, delta: np.ndarray) -> Tuple[int, float]:
        """(code id, quantization distance)."""
        if self.codes is None:
            raise ValueError("codebook not trained")
        d = self._distances(np.asarray(delta, np.float32)[None, :])[0]
        idx = int(np.argmin(d))
        return idx, float(np.sqrt(max(d[idx], 0.0)))

    def decode(self, code: int) -> np.ndarray:
        return self.codes[code].copy()

    def is_anomalous(self, delta: np.ndarray) -> bool:
        """Transition far from every known archetype."""
        if self._threshold is None:
            return False
        _, dist = self.quantize(delta)
        return dist * dist > self._threshold


class LocalCodebook:
    """EMA-adaptive per-domain codebook layered over the global one."""

    def __init__(self, global_codebook: GlobalCodebook,
                 ema: float = 0.1):
        self.base = global_codebook
        self.ema = ema
        self.codes = (global_codebook.codes.copy()
                      if global_codebook.codes is not None else None)
        self.usage = np.zeros(
            len(self.codes) if self.codes is not None else 0, np.int64)

    def observe(self, delta: np.ndarray) -> int:
        """Quantize and adapt the winning code toward the delta."""
        if self.codes is None:
            raise ValueError("codebook not trained")
        x = np.asarray(delta, np.float32)
        d = (np.sum(x * x) - 2 * self.codes @ x
             + np.sum(self.codes * self.codes, 1))
        idx = int(np.argmin(d))
        self.codes[idx] = (1 - self.ema) * self.codes[idx] + self.ema * x
        self.usage[idx] += 1
        return idx

    def drift_from_global(self) -> float:
        """How far local codes have adapted away from the global book."""
        if self.codes is None or self.base.codes is None:
            return 0.0
        return float(np.linalg.norm(self.codes - self.base.codes)
                     / max(np.linalg.norm(self.base.codes), 1e-30))


class CodebookManager:
    """Chain-attached codebook lifecycle (tensor_chain commit path,
    lib.rs:1040-1049: quantize each block's delta; the reference's
    SHOW CODEBOOK / ANALYZE CODEBOOK TRANSITIONS statements read this
    state — its router stubs those with zeros; here they are real).

    The global book trains itself from the first `train_after` block
    deltas, then every commit quantizes its delta (code recorded on the
    block), EMA-adapts the per-domain local book, and logs a transition
    validity record (anomalous = far from every archetype)."""

    def __init__(self, n_codes: int = 16, train_after: int = 16,
                 device="cuda"):
        self.n_codes = n_codes
        self.train_after = train_after
        self.device = device
        self.global_book: Optional[GlobalCodebook] = None
        self.locals: dict = {}
        self._buffer: list = []        # (height, delta) pre-training
        self.transitions: list = []    # {height, code, dist, valid}

    def observe(self, delta, height: int,
                domain: str = "default") -> Optional[int]:
        delta = np.asarray(delta, np.float32)
        if self.global_book is None:
            self._buffer.append((height, delta))
            if len(self._buffer) < self.train_after:
                return None
            dims = {d.shape[0] for _, d in self._buffer}
            dim = max(dims)
            train = np.stack([d for _, d in self._buffer
                              if d.shape[0] == dim])
            gb = GlobalCodebook(dim, self.n_codes, self.device)
            gb.train(train)
            self.global_book = gb
            # replay buffered blocks so early history carries codes
            last = None
            for h, d in self._buffer:
                last = self._record(h, d, domain)
            self._buffer.clear()
            return last
        return self._record(height, delta, domain)

    def _record(self, height: int, delta: np.ndarray, domain: str
                ) -> Optional[int]:
        gb = self.global_book
        if delta.shape[0] != gb.dim:
            return None                # mixed-dim delta: skip quantize
        code, dist = gb.quantize(delta)
        lb = self.locals.get(domain)
        if lb is None:
            lb = self.locals[domain] = LocalCodebook(gb)
        lb.observe(delta)
        self.transitions.append({
            "height": height, "code": code, "dist": dist,
            "valid": not gb.is_anomalous(delta)})
        return code

    def info(self, scope: str, domain: Optional[str] = None) -> dict:
        gb = self.global_book
        out = {"scope": scope, "domain": domain,
               "entry_count": (gb.n_codes if gb and gb.codes is not None
                               else 0),
               "dimension": gb.dim if gb else 0,
               "trained": gb is not None,
               "pending_deltas": len(self._buffer)}
        if scope == "local":
            lb = self.locals.get(domain or "default")
            out["entry_count"] = (len(lb.codes) if lb is not None
                                  and lb.codes is not None else 0)
            out["drift_from_global"] = (lb.drift_from_global()
                                        if lb is not None else 0.0)
            out["usage_total"] = (int(lb.usage.sum())
                                  if lb is not None else 0)
        return out

    def analyze_transitions(self) -> dict:
        total = len(self.transitions)
        valid = sum(1 for t in self.transitions if t["valid"])
        dists = [t["dist"] for t in self.transitions]
        return {
            "total_transitions": total,
            "valid_transitions": valid,
            "invalid_transitions": total - valid,
            "avg_quantization_distance": (float(np.mean(dists))
                                          if dists else 0.0),
            "avg_validity_score": (valid / total) if total else 0.0,
        }

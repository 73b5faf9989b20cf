"""Vault temporal access analysis: seasonality, drift, bursts.

Parity with tensor_vault/src/temporal_analysis.rs
(TemporalAnalysisConfig, SeasonalPattern via find_dominant_period,
DriftDetection, TemporalAnalysisReport): bucket the audit log's access
timestamps into a time series, find the dominant period by
autocorrelation, detect rate drift between the halves of the window,
and flag burst buckets.

The port's copy of ``neumann_tpu/vault/temporal.py``:
only its import lines differ.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class TemporalConfig:
    bucket_seconds: float = 3600.0     # hourly buckets by default
    min_buckets: int = 8
    drift_threshold: float = 0.5       # relative rate change
    burst_sigma: float = 3.0           # stddevs above mean


@dataclass(frozen=True)
class SeasonalPattern:
    period_buckets: int
    strength: float                    # autocorrelation at the period


@dataclass(frozen=True)
class DriftDetection:
    drifting: bool
    early_rate: float
    late_rate: float
    relative_change: float


@dataclass
class TemporalReport:
    buckets: List[int] = field(default_factory=list)
    seasonal: Optional[SeasonalPattern] = None
    drift: Optional[DriftDetection] = None
    bursts: List[int] = field(default_factory=list)   # bucket indices

    def as_dict(self) -> dict:
        return {
            "buckets": self.buckets,
            "seasonal": (None if self.seasonal is None else
                         {"period_buckets": self.seasonal.period_buckets,
                          "strength": round(self.seasonal.strength, 4)}),
            "drift": (None if self.drift is None else
                      {"drifting": self.drift.drifting,
                       "early_rate": round(self.drift.early_rate, 4),
                       "late_rate": round(self.drift.late_rate, 4),
                       "relative_change":
                           round(self.drift.relative_change, 4)}),
            "bursts": self.bursts,
        }


def bucketize(timestamps: Sequence[float],
              bucket_seconds: float) -> List[int]:
    if not timestamps:
        return []
    t0 = min(timestamps)
    span = max(timestamps) - t0
    n = int(span // bucket_seconds) + 1
    out = [0] * n
    for t in timestamps:
        out[int((t - t0) // bucket_seconds)] += 1
    return out


def autocorrelation(series: Sequence[float], lag: int) -> float:
    n = len(series)
    if lag <= 0 or lag >= n:
        return 0.0
    mean = sum(series) / n
    var = sum((x - mean) ** 2 for x in series)
    if var == 0:
        return 0.0
    cov = sum((series[i] - mean) * (series[i + lag] - mean)
              for i in range(n - lag))
    return cov / var


def find_dominant_period(series: Sequence[float]) -> int:
    """Lag (in buckets) with the highest autocorrelation, 0 if none
    stands out (temporal_analysis.rs:298)."""
    n = len(series)
    best_lag, best = 0, 0.25          # demand a real signal
    for lag in range(2, n // 2 + 1):
        ac = autocorrelation(series, lag)
        if ac > best:
            best, best_lag = ac, lag
    return best_lag


def detect_drift(series: Sequence[int],
                 threshold: float) -> DriftDetection:
    half = len(series) // 2
    early = sum(series[:half]) / max(half, 1)
    late = sum(series[half:]) / max(len(series) - half, 1)
    base = max(early, 1e-9)
    rel = (late - early) / base
    return DriftDetection(abs(rel) >= threshold, early, late, rel)


def analyze_temporal_patterns(
    timestamps: Sequence[float],
    config: Optional[TemporalConfig] = None,
) -> TemporalReport:
    cfg = config or TemporalConfig()
    buckets = bucketize(timestamps, cfg.bucket_seconds)
    report = TemporalReport(buckets=buckets)
    if len(buckets) < cfg.min_buckets:
        return report
    period = find_dominant_period(buckets)
    if period:
        report.seasonal = SeasonalPattern(
            period, autocorrelation(buckets, period))
    report.drift = detect_drift(buckets, cfg.drift_threshold)
    mean = sum(buckets) / len(buckets)
    std = math.sqrt(sum((b - mean) ** 2 for b in buckets)
                    / len(buckets))
    if std > 0:
        report.bursts = [i for i, b in enumerate(buckets)
                         if b > mean + cfg.burst_sigma * std]
    return report


def analyze_vault_access(vault, actor: Optional[str] = None,
                         config: Optional[TemporalConfig] = None
                         ) -> TemporalReport:
    """Run the analysis over a vault's audit log (optionally one actor)."""
    events = vault.audit_log(limit=10_000)
    ts = [e["ts"] for e in events
          if actor is None or e.get("actor") == actor]
    return analyze_temporal_patterns(ts, config)

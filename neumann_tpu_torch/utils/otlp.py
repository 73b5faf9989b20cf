"""OTLP export: metrics + spans as OTLP/HTTP JSON.

Parity with the reference server's OpenTelemetry export capability
(neumann_server metrics/telemetry wiring): QueryMetrics snapshots become
``resourceMetrics`` (sums + latency histograms) and recorded spans become
``resourceSpans``, serialized in the OTLP 1.x JSON encoding and POSTed to
``{endpoint}/v1/metrics`` / ``{endpoint}/v1/traces`` with stdlib urllib —
no collector SDK dependency. A ``file://`` endpoint appends JSON lines
instead, for air-gapped runs.

The port's copy of ``neumann_tpu/utils/otlp.py``: only its import lines
differ.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import Dict, List, Optional

from neumann_tpu_torch.utils.observability import _BUCKETS_MS, QueryMetrics, log


def _attr(key: str, value) -> dict:
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    if isinstance(value, float):
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


def _resource(service_name: str) -> dict:
    return {"attributes": [_attr("service.name", service_name)]}


def metrics_to_otlp(metrics: QueryMetrics, service_name: str = "neumann-tpu"
                    ) -> dict:
    """OTLP JSON ExportMetricsServiceRequest for a QueryMetrics snapshot."""
    now = str(time.time_ns())
    sums_count, sums_err, hists = [], [], []
    with metrics._lock:
        stats = {k: (s.count, s.errors, s.total_ms, s.max_ms,
                     list(s.histogram))
                 for k, s in metrics._stats.items()}
    for kind, (count, errors, total_ms, max_ms, hist) in sorted(
            stats.items()):
        attrs = [_attr("statement.kind", kind)]
        sums_count.append({"attributes": attrs, "timeUnixNano": now,
                           "asInt": str(count)})
        sums_err.append({"attributes": attrs, "timeUnixNano": now,
                         "asInt": str(errors)})
        hists.append({
            "attributes": attrs, "timeUnixNano": now,
            "count": str(count), "sum": total_ms,
            "max": max_ms,
            "bucketCounts": [str(c) for c in hist],
            "explicitBounds": list(_BUCKETS_MS)})
    scope_metrics = {"scope": {"name": "neumann_tpu"}, "metrics": [
        {"name": "neumann.queries", "unit": "1",
         "sum": {"aggregationTemporality": 2, "isMonotonic": True,
                 "dataPoints": sums_count}},
        {"name": "neumann.query.errors", "unit": "1",
         "sum": {"aggregationTemporality": 2, "isMonotonic": True,
                 "dataPoints": sums_err}},
        {"name": "neumann.query.duration", "unit": "ms",
         "histogram": {"aggregationTemporality": 2,
                       "dataPoints": hists}},
    ]}
    return {"resourceMetrics": [{"resource": _resource(service_name),
                                 "scopeMetrics": [scope_metrics]}]}


class SpanRecorder:
    """Bounded in-memory span sink; installed via ``set_span_recorder``
    the observability ``span()`` context manager records into it."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._spans: List[dict] = []
        self._lock = threading.Lock()

    def record(self, name: str, start_ns: int, end_ns: int,
               fields: Optional[dict] = None) -> None:
        with self._lock:
            self._spans.append({"name": name, "start": start_ns,
                                "end": end_ns,
                                "fields": dict(fields or {})})
            if len(self._spans) > self.capacity:
                self._spans = self._spans[-self.capacity:]

    def drain(self) -> List[dict]:
        with self._lock:
            out, self._spans = self._spans, []
            return out


def spans_to_otlp(spans: List[dict], service_name: str = "neumann-tpu"
                  ) -> dict:
    import os

    otlp = []
    for i, s in enumerate(spans):
        otlp.append({
            "traceId": os.urandom(16).hex(),
            "spanId": os.urandom(8).hex(),
            "name": s["name"],
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(s["start"]),
            "endTimeUnixNano": str(s["end"]),
            "attributes": [_attr(k, v) for k, v in s["fields"].items()],
            "status": {}})
    return {"resourceSpans": [{"resource": _resource(service_name),
                               "scopeSpans": [{
                                   "scope": {"name": "neumann_tpu"},
                                   "spans": otlp}]}]}


class OtlpExporter:
    """Pushes metrics/spans to an OTLP/HTTP collector (or a file).

    endpoint: ``http(s)://host:4318`` (standard OTLP/HTTP port) or
    ``file:///path/to/export.jsonl``.
    """

    def __init__(self, endpoint: str, service_name: str = "neumann-tpu",
                 timeout: float = 5.0,
                 headers: Optional[Dict[str, str]] = None):
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self.timeout = timeout
        self.headers = dict(headers or {})
        self._file_path = (self.endpoint[len("file://"):]
                           if self.endpoint.startswith("file://") else None)

    def _emit(self, path: str, body: dict) -> bool:
        payload = json.dumps(body)
        if self._file_path is not None:
            with open(self._file_path, "a", encoding="utf-8") as f:
                f.write(json.dumps({"path": path, "body": body}) + "\n")
            return True
        req = urllib.request.Request(
            f"{self.endpoint}{path}", data=payload.encode("utf-8"),
            headers={"Content-Type": "application/json", **self.headers},
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return 200 <= r.status < 300
        except Exception as e:  # collector down must never break serving
            log.debug("OTLP export to %s failed: %s", path, e)
            return False

    def export_metrics(self, metrics: QueryMetrics) -> bool:
        return self._emit("/v1/metrics",
                          metrics_to_otlp(metrics, self.service_name))

    def export_spans(self, recorder: SpanRecorder) -> bool:
        spans = recorder.drain()
        if not spans:
            return True
        return self._emit("/v1/traces",
                          spans_to_otlp(spans, self.service_name))


class PeriodicOtlpExporter:
    """Background thread exporting metrics (+ spans) every interval."""

    def __init__(self, exporter: OtlpExporter, metrics: QueryMetrics,
                 recorder: Optional[SpanRecorder] = None,
                 interval_s: float = 15.0):
        self.exporter = exporter
        self.metrics = metrics
        self.recorder = recorder
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.exporter.export_metrics(self.metrics)
            if self.recorder is not None:
                self.exporter.export_spans(self.recorder)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        # final flush so shutdown loses nothing
        self.exporter.export_metrics(self.metrics)
        if self.recorder is not None:
            self.exporter.export_spans(self.recorder)

"""gRPC server over the query router.

The port's copy of ``neumann_tpu/server/server.py``: QueryService
(Execute / ExecuteBatch / ExecutePaginated / CloseCursor /
ExecuteStream), Health, PointsService + CollectionsService
(Qdrant-style), BlobService streaming upload/download, server
reflection, API-key auth with per-key rate limiting, audit log, and
x-request-id correlation, hand-registered through grpc's generic handler
API over the protoc-generated message classes (``neumann_pb2.py``, the
reference's file byte for byte, so a process holding both packages has
one descriptor pool and one set of message classes). The Points data
plane decodes and encodes raw bytes with the native codec
(``native/pypoints.py``), the protobuf shim ``_PbPointsCodec`` standing
in when no compiler is present.

Departures from the reference, besides the import lines:

* ``NeumannServer(..., device="cuda")`` builds ``QueryRouter(device=
  device)`` when it is given no router, so the server runs on the card
  unless the caller asks for the CPU;
* ``Health`` reports the router's torch device type (``"cuda"`` on the
  card) where the reference asks JAX for its devices;
* ``serve()`` has no persistent compile cache to enable (the kernels
  are built once per checkout under ``build/neumann_tpu_torch/``), and
  it does not swallow a warm-up failure: on the card that is a kernel
  that failed to build or launch, and serving on without it would fail
  every query;
* ``main`` takes ``--device`` (default ``cuda``);
* ``dumps`` also encodes tensors, dtypes and devices, and
  ``_filter_from_json`` builds an ``in`` filter with a tuple value, so
  the batcher can key its cohort by it.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
from concurrent import futures
from typing import Dict, Iterable, List, Optional

import grpc
import numpy as np
import torch

from neumann_tpu_torch.router import QueryResult, QueryRouter
from neumann_tpu_torch.server import neumann_pb2 as pb
from neumann_tpu_torch.utils.errors import NeumannError

VERSION = "0.1.0"


def _json_default(v):
    if isinstance(v, bytes):
        return {"__b64__": base64.b64encode(v).decode()}
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return v.tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (torch.dtype, torch.device)):
        return str(v)
    raise TypeError(f"unserializable {type(v)}")


def dumps(obj) -> str:
    return json.dumps(obj, default=_json_default)


def _filter_from_json(obj) -> "FilterCondition":
    from neumann_tpu_torch.engines.vector import FilterCondition as F

    op = obj["op"]
    if op in ("and", "or"):
        left = _filter_from_json(obj["left"])
        right = _filter_from_json(obj["right"])
        return left.and_(right) if op == "and" else left.or_(right)
    if op == "true":
        return F.true()
    if op == "exists":
        return F.exists(obj["field"])
    if op == "in":
        # values as a tuple (FilterCondition.in_), so the filter hashes
        values = obj.get("value")
        if not isinstance(values, (list, tuple)):
            raise NeumannError("an 'in' filter needs a list 'value'")
        return F.in_(obj["field"], values)
    return F(op, obj["field"], obj.get("value"))


def result_to_proto(res: QueryResult) -> pb.QueryResponse:
    out = pb.QueryResponse(kind=res.kind, message=res.message or "")
    if res.rows:
        out.rows.extend(pb.Row(json=dumps(r)) for r in res.rows)
    if res.results:
        out.hits.extend(pb.Hit(key=h["key"], score=h["score"])
                        for h in res.results)
    if res.count is not None:
        out.count = res.count
    if res.value is not None:
        out.value_json = dumps(res.value)
    return out


def _identity(b):
    return b


_POINTS_CODEC = None


def _points_codec():
    """Native raw-bytes codec for the Points Query hot path, or a
    protobuf shim with identical call signatures when no toolchain is
    available. Both produce the same wire bytes
    (tests/test_points_codec.py)."""
    global _POINTS_CODEC
    if _POINTS_CODEC is None:
        from neumann_tpu_torch.native import pypoints

        _POINTS_CODEC = pypoints.load() or _PbPointsCodec
    return _POINTS_CODEC


class _PbPointsCodec:
    """Fallback points codec over the generated protobuf classes."""

    @staticmethod
    def parse_query(raw):
        req = pb.QueryPointsRequest.FromString(bytes(raw))
        vec = np.asarray(req.vector, "<f4").tobytes()
        return (req.collection, vec, req.limit,
                req.filter_json or None, req.with_payload,
                req.metric or None, req.req_id)

    @staticmethod
    def encode_query(collection, vec, limit, filter_json, with_payload,
                     metric, req_id):
        return pb.QueryPointsRequest(
            collection=collection,
            vector=np.frombuffer(vec, "<f4").tolist(), limit=limit,
            filter_json=filter_json or "",
            with_payload=bool(with_payload), metric=metric or "",
            req_id=req_id).SerializeToString()

    @staticmethod
    def encode_response(req_id, ids, scores, payloads, error):
        sc = np.frombuffer(scores, "<f4")
        out = pb.QueryPointsResponse(req_id=req_id, error=error or "")
        for i, pid in enumerate(ids):
            out.result.append(pb.ScoredPoint(
                id=pid, score=float(sc[i]),
                payload_json=(payloads[i] or "") if payloads else ""))
        return out.SerializeToString()

    # batch framing is `repeated <msg> = 1` for requests AND responses,
    # so split/join work on raw tags (message-type-agnostic, matching
    # the native codec's split_messages/join_messages)
    @staticmethod
    def split_messages(raw):
        raw = bytes(raw)
        out, i, n = [], 0, len(raw)
        while i < n:
            tag, i = _PbPointsCodec._uvarint(raw, i)
            if tag >> 3 == 1 and tag & 7 == 2:
                ln, i = _PbPointsCodec._uvarint(raw, i)
                out.append(raw[i: i + ln])
                i += ln
            elif tag & 7 == 0:
                _, i = _PbPointsCodec._uvarint(raw, i)
            elif tag & 7 == 2:
                ln, i = _PbPointsCodec._uvarint(raw, i)
                i += ln
            elif tag & 7 == 5:
                i += 4
            elif tag & 7 == 1:
                i += 8
            else:
                raise ValueError("malformed batch message")
        return out

    @staticmethod
    def _uvarint(raw, i):
        v = s = 0
        while True:
            b = raw[i]
            i += 1
            v |= (b & 0x7F) << s
            if not b & 0x80:
                return v, i
            s += 7

    @staticmethod
    def join_messages(subs):
        out = bytearray()
        for s in subs:
            out.append(0x0A)
            ln = len(s)
            while ln >= 0x80:
                out.append((ln & 0x7F) | 0x80)
                ln >>= 7
            out.append(ln)
            out.extend(s)
        return bytes(out)

    @staticmethod
    def parse_response(raw):
        resp = pb.QueryPointsResponse.FromString(bytes(raw))
        ids = [r.id for r in resp.result]
        scores = np.asarray([r.score for r in resp.result],
                            "<f4").tobytes()
        payloads = [r.payload_json or None for r in resp.result]
        if not any(p for p in payloads):
            payloads = None
        return (resp.req_id, ids, scores, payloads,
                resp.error or None)


class _Auth:
    def __init__(self, api_keys: Optional[Iterable[str]],
                 rate_limit_per_min: int):
        self.keys = set(api_keys) if api_keys else None
        self.rate = rate_limit_per_min
        self._windows: Dict[str, List[float]] = {}
        self._lock = threading.Lock()
        self.audit: List[dict] = []

    def check(self, context) -> str:
        md = dict(context.invocation_metadata())
        key = md.get("x-api-key", "")
        rid = md.get("x-request-id", "")
        if rid:
            context.set_trailing_metadata((("x-request-id", rid),))
        if self.keys is not None and key not in self.keys:
            self.log(key, "auth_failure", ok=False)
            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          "invalid API key")
        if self.rate:
            now = time.time()
            with self._lock:
                w = self._windows.setdefault(key, [])
                w[:] = [t for t in w if now - t < 60.0]
                limited = len(w) >= self.rate
                if not limited:
                    w.append(now)
            if limited:
                self.log(key, "rate_limited", ok=False)
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                              "rate limit exceeded")
        return key

    def log(self, key: str, action: str, ok: bool = True,
            detail: str = "") -> None:
        with self._lock:
            self.audit.append({"ts": time.time(), "key": key,
                               "action": action, "ok": ok,
                               "detail": detail})
            if len(self.audit) > 10_000:
                self.audit = self.audit[-5_000:]


class NeumannServer:
    def __init__(self, router: Optional[QueryRouter] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 api_keys: Optional[Iterable[str]] = None,
                 rate_limit_per_min: int = 0,
                 max_workers: int = 16,
                 tls: bool = False,
                 tls_cert: Optional[bytes] = None,
                 tls_key: Optional[bytes] = None,
                 memory_budget_bytes: Optional[int] = None,
                 device="cuda"):
        from neumann_tpu_torch.server.memory import (
            MemoryBudgetConfig,
            MemoryTracker,
        )

        self.router = router or QueryRouter(device=device)
        self.host = host
        self._auth = _Auth(api_keys, rate_limit_per_min)
        if memory_budget_bytes is None:
            env = os.environ.get("NEUMANN_MEMORY_BUDGET")
            memory_budget_bytes = int(env) if env else None
        self.memory = MemoryTracker(MemoryBudgetConfig(
            max_bytes=memory_budget_bytes)) if memory_budget_bytes \
            else None
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self._generic_handlers = self._handlers()
        self._server.add_generic_rpc_handlers(self._generic_handlers)
        self.tls_cert = None
        if tls:
            if tls_cert is None or tls_key is None:
                tls_cert, tls_key = generate_self_signed(host)
            self.tls_cert = tls_cert
            creds = grpc.ssl_server_credentials(((tls_key, tls_cert),))
            self.port = self._server.add_secure_port(
                f"{host}:{port}", creds)
        else:
            self.port = self._server.add_insecure_port(
                f"{host}:{port}")
        self.metrics = {"requests": 0, "errors": 0,
                        "latency_ms_sum": 0.0}
        self._mlock = threading.Lock()
        # optional OTLP push (NEUMANN_OTLP_ENDPOINT or enable_otlp())
        self._otlp = None
        endpoint = os.environ.get("NEUMANN_OTLP_ENDPOINT")
        if endpoint:
            self.enable_otlp(endpoint, float(
                os.environ.get("NEUMANN_OTLP_INTERVAL", "15")))

    def web_gateway(self):
        """gRPC-web gateway over this server's handlers (auth/metrics
        included); mount it on a RestServer for browser clients."""
        from neumann_tpu_torch.server.grpc_web import GrpcWebGateway

        return GrpcWebGateway(self._generic_handlers)

    def enable_otlp(self, endpoint: str, interval_s: float = 15.0) -> None:
        """Periodic OTLP/HTTP push of router QueryMetrics + spans."""
        from neumann_tpu_torch.utils.observability import set_span_recorder
        from neumann_tpu_torch.utils.otlp import (
            OtlpExporter,
            PeriodicOtlpExporter,
            SpanRecorder,
        )

        recorder = SpanRecorder()
        set_span_recorder(recorder)
        self._otlp = PeriodicOtlpExporter(
            OtlpExporter(endpoint), self.router.metrics, recorder,
            interval_s=interval_s)
        self._otlp.start()

    # ------------------------------------------------------------------
    def serve(self, block: bool = False, warmup: Optional[bool] = None
              ) -> int:
        """Start serving. ``warmup`` builds the kernels and runs every
        loaded corpus's search paths once BEFORE the port accepts
        traffic (``QueryRouter.warmup``), so no client pays a kernel
        build. Defaults from NEUMANN_WARMUP (set NEUMANN_WARMUP=0 to skip
        for fast test startup)."""
        if warmup is None:
            warmup = os.environ.get("NEUMANN_WARMUP", "1") != "0"
        if os.environ.get("NEUMANN_BATCHING", "1") != "0":
            # coalesce concurrent SIMILAR RPCs into bucketed device
            # calls (server/batcher.py); embedded routers stay unbatched
            self.router.enable_batched_serving()
        if warmup:
            # on the card a failed warm-up is a kernel that failed to
            # build or launch: it raises, before the port accepts traffic
            self.router.warmup()
        self._server.start()
        if block:
            self._server.wait_for_termination()
        return self.port

    def stop(self, grace: float = 1.0) -> None:
        if self._otlp is not None:
            self._otlp.stop()  # final flush
            self._otlp = None
        # stop accepting traffic FIRST: in-flight RPCs finish inside the
        # grace window while their batchers are still live; disabling
        # batchers first would strand queued requests until their
        # 30 s client timeout (advisor r4)
        ev = self._server.stop(grace)
        ev.wait(grace + 1.0)
        self.router.disable_batched_serving()

    def audit_log(self) -> List[dict]:
        return list(self._auth.audit)

    # ------------------------------------------------------------------
    def _reflection_info(self, request_iterator, context):
        """grpc.reflection.v1alpha bidi stream (generic handler)."""
        pb2 = _refl_pb()
        services, by_file, by_symbol = _reflection_state()
        for req in request_iterator:
            resp = pb2.ServerReflectionResponse(valid_host=req.host,
                                                original_request=req)
            which = req.WhichOneof("message_request")
            if which == "list_services":
                resp.list_services_response.service.extend(
                    pb2.ServiceResponse(name=s) for s in services)
            elif which == "file_containing_symbol":
                blob = by_symbol.get(req.file_containing_symbol)
                if blob is None:
                    resp.error_response.error_code = 5  # NOT_FOUND
                    resp.error_response.error_message = (
                        f"symbol not found: "
                        f"{req.file_containing_symbol}")
                else:
                    resp.file_descriptor_response\
                        .file_descriptor_proto.append(blob)
            elif which == "file_by_filename":
                blob = by_file.get(req.file_by_filename)
                if blob is None:
                    resp.error_response.error_code = 5
                    resp.error_response.error_message = (
                        f"file not found: {req.file_by_filename}")
                else:
                    resp.file_descriptor_response\
                        .file_descriptor_proto.append(blob)
            else:
                resp.error_response.error_code = 12  # UNIMPLEMENTED
                resp.error_response.error_message = \
                    f"unsupported reflection request: {which}"
            yield resp

    # ------------------------------------------------------------------
    def _record(self, t0: float, error: bool) -> None:
        with self._mlock:
            self.metrics["requests"] += 1
            if error:
                self.metrics["errors"] += 1
            self.metrics["latency_ms_sum"] += (time.time() - t0) * 1e3

    def _wrap(self, fn, req_cls, resp_cls, streaming_out=False,
              streaming_in=False):
        def handler(request, context):
            t0 = time.time()
            key = self._auth.check(context)
            reserved = 0
            if self.memory is not None and hasattr(request, "ByteSize"):
                # request + working set estimate (memory.rs load shedding)
                reserved = request.ByteSize() * 4 + 4096
                if not self.memory.try_allocate(reserved):
                    self._record(t0, True)
                    context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED,
                                  "server over memory budget")
            try:
                out = fn(request, context)
                self._record(t0, False)
                self._auth.log(key, fn.__name__)
                return out
            except NeumannError as e:
                self._record(t0, True)
                self._auth.log(key, fn.__name__, ok=False, detail=str(e))
                if streaming_out:
                    context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
                return resp_cls(error=str(e))
            except Exception as e:  # noqa: BLE001 — surface faithfully
                self._record(t0, True)
                self._auth.log(key, fn.__name__, ok=False, detail=str(e))
                context.abort(grpc.StatusCode.INTERNAL,
                              f"{type(e).__name__}: {e}")
            finally:
                if reserved:
                    self.memory.release(reserved)
        des = req_cls.FromString
        ser = resp_cls.SerializeToString
        if streaming_out and streaming_in:
            return grpc.stream_stream_rpc_method_handler(
                handler, request_deserializer=des,
                response_serializer=ser)
        if streaming_out:
            return grpc.unary_stream_rpc_method_handler(
                handler, request_deserializer=des,
                response_serializer=ser)
        if streaming_in:
            return grpc.stream_unary_rpc_method_handler(
                handler, request_deserializer=des,
                response_serializer=ser)
        return grpc.unary_unary_rpc_method_handler(
            handler, request_deserializer=des, response_serializer=ser)

    def _handlers(self):
        q = {
            "Execute": self._wrap(self._execute, pb.QueryRequest,
                                  pb.QueryResponse),
            "ExecuteBatch": self._wrap(self._execute_batch,
                                       pb.BatchRequest, pb.BatchResponse),
            "ExecutePaginated": self._wrap(
                self._execute_paginated, pb.PaginatedRequest,
                pb.PaginatedResponse),
            "CloseCursor": self._wrap(self._close_cursor,
                                      pb.CloseCursorRequest,
                                      pb.CloseCursorResponse),
            "ExecuteStream": self._wrap(self._execute_stream,
                                        pb.QueryRequest, pb.QueryResponse,
                                        streaming_out=True),
        }
        h = {"Check": self._wrap(self._health, pb.HealthRequest,
                                 pb.HealthResponse)}
        p = {
            "Upsert": self._wrap(self._points_upsert,
                                 pb.UpsertPointsRequest,
                                 pb.UpsertPointsResponse),
            "Get": self._wrap(self._points_get, pb.GetPointsRequest,
                              pb.GetPointsResponse),
            "Delete": self._wrap(self._points_delete,
                                 pb.DeletePointsRequest,
                                 pb.DeletePointsResponse),
            # raw-bytes fast path: no Python protobuf on the hot path
            # (native codec; see _points_query_fast). Identity
            # serializers instead of None: the grpc-web gateway calls
            # them explicitly (grpc_web.py:163,184)
            "Query": grpc.unary_unary_rpc_method_handler(
                self._points_query_unary,
                request_deserializer=_identity,
                response_serializer=_identity),
            "QueryStream": grpc.stream_stream_rpc_method_handler(
                self._points_stream_entry,
                request_deserializer=_identity,
                response_serializer=_identity),
            "QueryBatch": grpc.unary_unary_rpc_method_handler(
                self._points_query_batch_unary,
                request_deserializer=_identity,
                response_serializer=_identity),
            "Scroll": self._wrap(self._points_scroll,
                                 pb.ScrollPointsRequest,
                                 pb.ScrollPointsResponse),
        }
        c = {
            "Create": self._wrap(self._col_create,
                                 pb.CreateCollectionRequest,
                                 pb.CreateCollectionResponse),
            "Drop": self._wrap(self._col_drop, pb.DropCollectionRequest,
                               pb.DropCollectionResponse),
            "List": self._wrap(self._col_list, pb.ListCollectionsRequest,
                               pb.ListCollectionsResponse),
        }
        c["Get"] = self._wrap(self._col_get, pb.GetCollectionRequest,
                              pb.GetCollectionResponse)
        c["Delete"] = c["Drop"]     # reference proto names it Delete
        b = {
            "Upload": self._wrap(self._blob_upload, pb.BlobChunk,
                                 pb.BlobUploadResponse, streaming_in=True),
            "Download": self._wrap(self._blob_download,
                                   pb.BlobDownloadRequest, pb.BlobChunk,
                                   streaming_out=True),
            "Delete": self._wrap(self._blob_delete, pb.BlobDeleteRequest,
                                 pb.BlobDeleteResponse),
            "GetMetadata": self._wrap(self._blob_metadata,
                                      pb.BlobMetadataRequest,
                                      pb.ArtifactInfo),
        }
        r = {"ServerReflectionInfo": grpc.stream_stream_rpc_method_handler(
            self._reflection_info,
            request_deserializer=_refl_pb().ServerReflectionRequest
            .FromString,
            response_serializer=_refl_pb().ServerReflectionResponse
            .SerializeToString)}
        return [
            grpc.method_handlers_generic_handler("neumann.QueryService", q),
            grpc.method_handlers_generic_handler("neumann.Health", h),
            # v1 is wire-identical to v1alpha (same message fields; only
            # the service name changed), so one handler serves both —
            # modern grpcurl probes v1 first (tonic serves both too)
            grpc.method_handlers_generic_handler(
                "grpc.reflection.v1.ServerReflection", r),
            grpc.method_handlers_generic_handler(
                "grpc.reflection.v1alpha.ServerReflection", r),
            grpc.method_handlers_generic_handler("neumann.PointsService", p),
            grpc.method_handlers_generic_handler(
                "neumann.CollectionsService", c),
            grpc.method_handlers_generic_handler("neumann.BlobService", b),
        ]

    # -- query service ------------------------------------------------------
    def _execute(self, request, context):
        return result_to_proto(self.router.execute(request.query))

    def _execute_batch(self, request, context):
        out = pb.BatchResponse()
        for qr in request.queries:
            try:
                out.results.append(
                    result_to_proto(self.router.execute(qr.query)))
            except NeumannError as e:
                out.results.append(pb.QueryResponse(error=str(e)))
        return out

    def _execute_paginated(self, request, context):
        rows, cursor = self.router.execute_paginated(
            request.query, request.page_size,
            request.cursor or None)
        return pb.PaginatedResponse(
            rows=[pb.Row(json=dumps(r)) for r in rows],
            next_cursor=cursor or "")

    def _close_cursor(self, request, context):
        return pb.CloseCursorResponse(
            closed=self.router.close_cursor(request.cursor))

    def _execute_stream(self, request, context):
        res = self.router.execute(request.query)
        chunk = 64
        rows = res.rows or [
            {"key": h["key"], "score": h["score"]} for h in res.results]
        if not rows:
            yield result_to_proto(res)
            return
        for i in range(0, len(rows), chunk):
            part = QueryResult("rows", rows=rows[i: i + chunk])
            yield result_to_proto(part)

    # -- health -----------------------------------------------------------
    def _health(self, request, context):
        return pb.HealthResponse(ok=True, version=VERSION,
                                 entries=len(self.router.store),
                                 device=self.router.vector.device.type)

    # -- points / collections ----------------------------------------------
    def _ensure_collection(self, name: str):
        if name not in self.router.vector.list_collections():
            self.router.vector.create_collection(name)

    def _points_upsert(self, request, context):
        self._ensure_collection(request.collection)
        n = 0
        for pt in request.points:
            payload = json.loads(pt.payload_json) if pt.payload_json \
                else None
            self.router.vector.store_in_collection(
                request.collection, pt.id, list(pt.vector), payload)
            n += 1
        return pb.UpsertPointsResponse(upserted=n)

    def _points_get(self, request, context):
        out = pb.GetPointsResponse()
        for pid in request.ids:
            data = self.router.store.get(
                f"col:{request.collection}:{pid}")
            if data is None:
                continue
            emb = data.get("embedding")
            payload = {n: v.value for n, v in data.fields.items()
                       if n != "embedding" and v.kind == "scalar"}
            out.points.append(pb.Point(
                id=pid,
                vector=emb.to_dense().tolist() if emb is not None else [],
                payload_json=dumps(payload) if payload else ""))
        return out

    def _points_delete(self, request, context):
        n = 0
        for pid in request.ids:
            if self.router.vector.delete_from_collection(
                    request.collection, pid):
                n += 1
        return pb.DeletePointsResponse(deleted=n)

    # -- points query fast path --------------------------------------------
    # The serving data plane: raw request bytes in, raw response bytes
    # out, decoded/encoded by the native codec (points_ext.cpp) and
    # dispatched through the router's coalescing batchers — no Python
    # protobuf objects on the hot path. Mirrors the reference's
    # compiled tonic handlers (neumann_server/src/service/query.rs:
    # 207-278 + proto/vector.proto).
    def _resolve_metric(self, ns: str, metric: Optional[str]) -> str:
        if metric:
            return metric
        if ns.startswith("col/"):
            return self.router.vector.collection_config(ns[4:]).metric
        return "cosine"

    def _search_points_ns(self, ns: str, q: np.ndarray, limit: int,
                          filt, metric: Optional[str]):
        mt = self._resolve_metric(ns, metric)
        batcher = self.router._batcher_for(q.size, mt, ns)
        if batcher is not None:
            return batcher.search(q, limit, filter_cond=filt)
        return self.router.vector.batch_search_ns(
            q[None, :], limit, mt, ns, filter_cond=filt)[0]

    def _payloads_for(self, collection: str, keys):
        prefix = f"col:{collection}:" if collection else "emb:"
        out = []
        for k in keys:
            data = self.router.store.get(prefix + k)
            payload = None
            if data is not None:
                payload = {n: v.value for n, v in data.fields.items()
                           if n != "embedding" and v.kind == "scalar"}
            out.append(dumps(payload) if payload else None)
        return out

    def _points_query_fast(self, raw: bytes, codec) -> bytes:
        return self._points_query_parsed(codec.parse_query(raw), codec)

    def _points_query_parsed(self, parsed, codec) -> bytes:
        col, vecb, limit, fjson, with_payload, metric, rid = parsed
        try:
            q = np.frombuffer(vecb, "<f4")
            filt = (_filter_from_json(json.loads(fjson))
                    if fjson else None)
            ns = f"col/{col}" if col else ""
            hits = self._search_points_ns(ns, q, limit or 10, filt,
                                          metric or None)
        except (NeumannError, ValueError, KeyError) as e:
            return codec.encode_response(rid, [], b"", None, str(e))
        ids = [h.key for h in hits]
        scores = np.fromiter((h.score for h in hits), "<f4",
                             count=len(ids))
        payloads = self._payloads_for(col, ids) if with_payload \
            else None
        return codec.encode_response(rid, ids, scores.tobytes(),
                                     payloads, None)

    def _points_query_batch_fast(self, raw: bytes, codec) -> bytes:
        """QueryBatch: a HOMOGENEOUS batch (one collection/metric, no
        filters, no payloads, one dim) becomes a single [B, d] matrix
        and ONE batched device call — the amortized-wire serving path
        (Qdrant query_batch parity). Mixed batches fall back to the
        per-item fast path, answered in order either way."""
        parsed = [codec.parse_query(s)
                  for s in codec.split_messages(raw)]
        if not parsed:
            return b""
        p0 = parsed[0]
        homogeneous = all(
            p[0] == p0[0] and p[3] is None and not p[4]
            and (p[5] or "") == (p0[5] or "")
            and len(p[1]) == len(p0[1]) and len(p[1]) > 0
            for p in parsed)
        if not homogeneous:
            return codec.join_messages(
                [self._points_query_parsed(p, codec) for p in parsed])
        col = p0[0]
        ns = f"col/{col}" if col else ""
        d = len(p0[1]) // 4
        mat = np.frombuffer(b"".join(p[1] for p in parsed),
                            "<f4").reshape(len(parsed), d)
        k = max((p[2] or 10) for p in parsed)
        try:
            results = self.router.vector.batch_search_ns(
                mat, k, p0[5] or None, ns)
        except (NeumannError, ValueError, KeyError) as e:
            msg = str(e)
            return codec.join_messages([
                codec.encode_response(p[6], [], b"", None, msg)
                for p in parsed])
        resps = []
        for p, hits in zip(parsed, results):
            hits = hits[: (p[2] or 10)]
            ids = [h.key for h in hits]
            scores = np.fromiter((h.score for h in hits), "<f4",
                                 count=len(ids))
            resps.append(codec.encode_response(
                p[6], ids, scores.tobytes(), None, None))
        return codec.join_messages(resps)

    def _points_query_batch_unary(self, request: bytes,
                                  context) -> bytes:
        t0 = time.time()
        key = self._auth.check(context)
        try:
            out = self._points_query_batch_fast(request,
                                                _points_codec())
            self._record(t0, False)
            return out
        except Exception as e:  # noqa: BLE001 — surface faithfully
            self._record(t0, True)
            self._auth.log(key, "points_query_batch", ok=False,
                           detail=str(e))
            context.abort(grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")

    def _points_query_unary(self, request: bytes, context) -> bytes:
        t0 = time.time()
        key = self._auth.check(context)
        try:
            out = self._points_query_fast(request, _points_codec())
            self._record(t0, False)
            return out
        except Exception as e:  # noqa: BLE001 — surface faithfully
            self._record(t0, True)
            self._auth.log(key, "points_query", ok=False, detail=str(e))
            context.abort(grpc.StatusCode.INTERNAL,
                          f"{type(e).__name__}: {e}")

    def _points_stream_entry(self, request_iterator, context):
        """Bidi QueryStream: pipelined binary queries, coalesced into
        batched device calls; responses stream back as their batch
        completes (correlated by req_id, possibly out of order)."""
        import queue as _queue

        self._auth.check(context)
        codec = _points_codec()
        out: "_queue.Queue" = _queue.Queue()
        _DONE = object()
        lock = threading.Lock()
        pending = [1]                      # reader's own ref

        def dec():
            with lock:
                pending[0] -= 1
                if pending[0] == 0:
                    out.put(_DONE)

        def completion(rid, col, with_payload, t0):
            def cb(results, error):
                try:
                    if error is not None:
                        out.put(codec.encode_response(
                            rid, [], b"", None, str(error)))
                        self._record(t0, True)
                        return
                    ids = [h.key for h in results]
                    scores = np.fromiter(
                        (h.score for h in results), "<f4",
                        count=len(ids))
                    payloads = (self._payloads_for(col, ids)
                                if with_payload else None)
                    out.put(codec.encode_response(
                        rid, ids, scores.tobytes(), payloads, None))
                    self._record(t0, False)
                finally:
                    dec()
            return cb

        def reader():
            try:
                for raw in request_iterator:
                    t0 = time.time()
                    rid = 0
                    try:
                        col, vecb, limit, fjson, with_payload, metric, \
                            rid = codec.parse_query(raw)
                        q = np.frombuffer(vecb, "<f4")
                        filt = (_filter_from_json(json.loads(fjson))
                                if fjson else None)
                        ns = f"col/{col}" if col else ""
                        mt = self._resolve_metric(ns, metric or None)
                        with lock:
                            pending[0] += 1
                        cb = completion(rid, col, with_payload, t0)
                        batcher = self.router._batcher_for(
                            q.size, mt, ns)
                        if batcher is not None:
                            try:
                                batcher.submit(q, limit or 10, filt,
                                               callback=cb)
                            except Exception as e:  # noqa: BLE001
                                cb(None, e)
                        else:
                            try:
                                cb(self.router.vector.batch_search_ns(
                                    q[None, :], limit or 10, mt, ns,
                                    filter_cond=filt)[0], None)
                            except Exception as e:  # noqa: BLE001
                                cb(None, e)
                    except Exception as e:  # noqa: BLE001 — one bad
                        # message answers with an error (correlated if
                        # the req_id parsed), stream lives
                        out.put(codec.encode_response(
                            rid, [], b"", None,
                            f"{type(e).__name__}: {e}"))
                        self._record(t0, True)
            finally:
                dec()

        threading.Thread(target=reader, daemon=True,
                         name="points-stream-reader").start()
        while True:
            item = out.get()
            if item is _DONE:
                return
            yield item


    def _points_scroll(self, request, context):
        prefix = f"col:{request.collection}:"
        keys = [k[len(prefix):] for k in self.router.store.scan(prefix)]
        if request.offset_id:
            keys = [k for k in keys if k > request.offset_id]
        limit = request.limit or 100
        page = keys[:limit]
        out = pb.ScrollPointsResponse(
            next_offset_id=page[-1] if len(keys) > limit else "")
        for pid in page:
            data = self.router.store.get(prefix + pid)
            emb = data.get("embedding") if data else None
            out.points.append(pb.Point(
                id=pid,
                vector=emb.to_dense().tolist() if emb is not None else []))
        return out

    def _col_create(self, request, context):
        from neumann_tpu_torch.engines.vector import VectorCollectionConfig

        self.router.vector.create_collection(
            request.name, VectorCollectionConfig(
                dimension=request.dimension or None,
                metric=request.metric or "cosine",
                quantization=request.quantization or "none"))
        return pb.CreateCollectionResponse(ok=True)

    def _col_drop(self, request, context):
        return pb.DropCollectionResponse(
            ok=self.router.vector.drop_collection(request.name))

    def _col_get(self, request, context):
        if request.name not in self.router.vector.list_collections():
            return pb.GetCollectionResponse(
                error=f"no collection '{request.name}'")
        st = self.router.vector.collection_stats(request.name)
        return pb.GetCollectionResponse(collection=pb.CollectionInfo(
            name=request.name, count=st["count"],
            dimension=st["dimension"] or 0, metric=st["metric"],
            quantization=st["quantization"]))

    def _col_list(self, request, context):
        out = pb.ListCollectionsResponse()
        for name in self.router.vector.list_collections():
            st = self.router.vector.collection_stats(name)
            out.collections.append(pb.CollectionInfo(
                name=name, count=st["count"],
                dimension=st["dimension"] or 0, metric=st["metric"],
                quantization=st["quantization"]))
        return out

    # -- blobs -------------------------------------------------------------
    def _blob_upload(self, request_iterator, context):
        if self.router.blob is None:
            self.router.init_blob()
        writer = None
        for chunk in request_iterator:
            if writer is None:
                writer = self.router.blob.writer(
                    chunk.name or "unnamed",
                    chunk.content_type or None)
            if chunk.data:
                writer.write(chunk.data)
        if writer is None:
            return pb.BlobUploadResponse(error="empty upload")
        return pb.BlobUploadResponse(artifact_id=writer.finish())

    def _blob_delete(self, request, context):
        if self.router.blob is None:
            self.router.init_blob()
        return pb.BlobDeleteResponse(
            ok=self.router.blob.delete(request.artifact_id))

    def _blob_metadata(self, request, context):
        if self.router.blob is None:
            self.router.init_blob()
        info = self.router.blob.info(request.artifact_id)
        return pb.ArtifactInfo(
            id=info["id"], name=info["name"], size=int(info["size"]),
            checksum=info["checksum"],
            content_type=info["content_type"] or "",
            creator=info["creator"] or "",
            created=float(info["created"]), tags=info["tags"],
            links=info["links"], chunks=int(info["chunks"]))

    def _blob_download(self, request, context):
        if self.router.blob is None:
            self.router.init_blob()
        info = self.router.blob.info(request.artifact_id)
        first = True
        for data in self.router.blob.read_stream(request.artifact_id):
            yield pb.BlobChunk(
                name=info["name"] if first else "",
                content_type=(info["content_type"] or "") if first else "",
                data=data)
            first = False


_REFLECTION = None


def _refl_pb():
    from neumann_tpu_torch.server import reflection_pb2

    return reflection_pb2


def _reflection_state():
    """(services, files-by-name, file-bytes-by-symbol) lazily parsed from
    the vendored FileDescriptorSet (server reflection v1alpha — lets
    grpcurl/Postman discover the API without local protos)."""
    global _REFLECTION
    if _REFLECTION is None:
        import os as _os

        from google.protobuf import descriptor_pb2

        desc_path = _os.path.join(_os.path.dirname(__file__),
                                  "neumann.desc")
        fds = descriptor_pb2.FileDescriptorSet()
        with open(desc_path, "rb") as f:
            fds.ParseFromString(f.read())
        services, by_file, by_symbol = [], {}, {}
        for fd in fds.file:
            blob = fd.SerializeToString()
            by_file[fd.name] = blob
            pkg = fd.package
            for svc in fd.service:
                full = f"{pkg}.{svc.name}" if pkg else svc.name
                services.append(full)
                by_symbol[full] = blob
                for m in svc.method:
                    by_symbol[f"{full}.{m.name}"] = blob
            for msg in fd.message_type:
                by_symbol[f"{pkg}.{msg.name}" if pkg
                          else msg.name] = blob
        # the reflection service itself is also discoverable
        services.append("grpc.reflection.v1alpha.ServerReflection")
        _REFLECTION = (services, by_file, by_symbol)
    return _REFLECTION


def generate_self_signed(host: str = "127.0.0.1"):
    """(cert_pem, key_pem) — parity with the reference's rcgen TLS."""
    import datetime
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         "neumann-tpu")])
    try:
        san = x509.SubjectAlternativeName(
            [x509.IPAddress(ipaddress.ip_address(host))])
    except ValueError:
        san = x509.SubjectAlternativeName([x509.DNSName(host)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now)
            .not_valid_after(now + datetime.timedelta(days=365))
            .add_extension(san, critical=False)
            .sign(key, hashes.SHA256()))
    return (cert.public_bytes(serialization.Encoding.PEM),
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption()))


def main(argv=None) -> int:
    """CLI entry point. Flags override NEUMANN_* env vars (the
    reference's ServerConfig env-var pattern, config.rs:195-242):
    NEUMANN_HOST, NEUMANN_PORT, NEUMANN_API_KEYS (comma-separated),
    NEUMANN_WAL_DIR, NEUMANN_TLS=1, NEUMANN_RATE_LIMIT; ``--device``
    (default cuda) places the router."""
    import argparse
    import signal

    env = os.environ
    ap = argparse.ArgumentParser(prog="neumann-tpu-server")
    ap.add_argument("--host", default=env.get("NEUMANN_HOST",
                                              "127.0.0.1"))
    ap.add_argument("--port", type=int,
                    default=int(env.get("NEUMANN_PORT", "50051")))
    ap.add_argument("--api-key", action="append",
                    default=(env["NEUMANN_API_KEYS"].split(",")
                             if env.get("NEUMANN_API_KEYS") else None))
    ap.add_argument("--wal-dir", default=env.get("NEUMANN_WAL_DIR"))
    ap.add_argument("--tls", action="store_true",
                    default=env.get("NEUMANN_TLS") == "1")
    ap.add_argument("--rate-limit", type=int,
                    default=int(env.get("NEUMANN_RATE_LIMIT", "0")))
    ap.add_argument("--device", default="cuda",
                    help="device of the query router")
    args = ap.parse_args(argv)
    router = QueryRouter(device=args.device)
    if args.wal_dir:
        os.makedirs(args.wal_dir, exist_ok=True)
        router.store.recover(os.path.join(args.wal_dir, "wal.log"))
        router.store.open_durable(os.path.join(args.wal_dir, "wal.log"))
    srv = NeumannServer(router, args.host, args.port,
                        api_keys=args.api_key,
                        rate_limit_per_min=args.rate_limit,
                        tls=args.tls)
    port = srv.serve(block=False)
    print(f"neumann-tpu server listening on {args.host}:{port}"
          + (" (TLS)" if args.tls else ""), flush=True)

    def shutdown(signum, frame):
        print("shutting down gracefully...", flush=True)
        srv.stop(grace=5.0)
        router.store.wal_flush()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    srv._server.wait_for_termination()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Python SDK: remote gRPC client + in-process embedded mode.

Capability parity with neumann-py / neumann_client (connect / embedded,
execute, batch, streaming, pagination, points/collections/blob APIs,
retry with backoff). The embedded mode wraps a QueryRouter directly, like
the reference's PyO3 embedded mode (neumann-py/neumann-native).

The port's copy of ``neumann_tpu/server/client.py``. Two departures
besides the import lines: ``NeumannClient.embedded(router=None,
device="cuda")`` builds its router on ``device`` (the card unless the
caller asks for the CPU); and a ``PointsPipeline`` whose response stream
ends cleanly fails the futures still pending, as it does when the stream
fails, where the reference left them unresolved for ever.
"""

from __future__ import annotations

import base64
import json
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

from neumann_tpu_torch.utils.errors import NeumannError


def _json_obj(s: str):
    if not s:
        return None

    def hook(d):
        if "__b64__" in d and len(d) == 1:
            return base64.b64decode(d["__b64__"])
        return d

    return json.loads(s, object_hook=hook)


@dataclass
class ClientResult:
    kind: str
    message: str = ""
    rows: List[dict] = field(default_factory=list)
    hits: List[dict] = field(default_factory=list)
    count: Optional[int] = None
    value: object = None
    error: str = ""

    @property
    def ok(self) -> bool:
        return not self.error


def _from_proto(resp) -> ClientResult:
    return ClientResult(
        kind=resp.kind,
        message=resp.message,
        rows=[_json_obj(r.json) for r in resp.rows],
        hits=[{"key": h.key, "score": h.score} for h in resp.hits],
        count=resp.count if resp.kind == "count" or resp.count else None,
        value=_json_obj(resp.value_json),
        error=resp.error,
    )


class NeumannClient:
    """Use NeumannClient.connect(addr) or NeumannClient.embedded()."""

    def __init__(self, channel=None, router=None, api_key=None,
                 retries: int = 2, retry_backoff_s: float = 0.2):
        self._channel = channel
        self._router = router
        self._api_key = api_key
        self._retries = retries
        self._backoff = retry_backoff_s
        if channel is not None:
            from neumann_tpu_torch.server import neumann_pb2 as pb

            self._pb = pb

    # -- constructors -----------------------------------------------------
    @staticmethod
    def connect(address: str, api_key: Optional[str] = None,
                tls_root_cert: Optional[bytes] = None,
                **kw) -> "NeumannClient":
        import grpc

        if tls_root_cert is not None:
            creds = grpc.ssl_channel_credentials(tls_root_cert)
            channel = grpc.secure_channel(address, creds)
        else:
            channel = grpc.insecure_channel(address)
        return NeumannClient(channel=channel, api_key=api_key, **kw)

    @staticmethod
    def embedded(router=None, device="cuda") -> "NeumannClient":
        from neumann_tpu_torch.router import QueryRouter

        return NeumannClient(router=router or QueryRouter(device=device))

    def close(self) -> None:
        if self._channel is not None:
            self._channel.close()

    def transaction(self):
        """Chain-transaction context manager (server/transaction.py)."""
        from neumann_tpu_torch.server.transaction import Transaction

        return Transaction(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- rpc plumbing -------------------------------------------------------
    def _metadata(self, request_id: Optional[str] = None):
        md = []
        if self._api_key:
            md.append(("x-api-key", self._api_key))
        if request_id:
            md.append(("x-request-id", request_id))
        return md

    def _call(self, service: str, method: str, request, resp_cls,
              streaming=False):
        import grpc

        path = f"/{service}/{method}"
        attempt = 0
        while True:
            try:
                if streaming:
                    rpc = self._channel.unary_stream(
                        path,
                        request_serializer=type(request).SerializeToString,
                        response_deserializer=resp_cls.FromString)
                    return rpc(request, metadata=self._metadata())
                rpc = self._channel.unary_unary(
                    path,
                    request_serializer=type(request).SerializeToString,
                    response_deserializer=resp_cls.FromString)
                return rpc(request, metadata=self._metadata())
            except grpc.RpcError as e:
                code = e.code()
                retriable = code in (grpc.StatusCode.UNAVAILABLE,
                                     grpc.StatusCode.DEADLINE_EXCEEDED)
                if retriable and attempt < self._retries:
                    attempt += 1
                    time.sleep(self._backoff * (2 ** (attempt - 1)))
                    continue
                raise NeumannError(
                    f"rpc {path} failed: {code.name}: {e.details()}") \
                    from e

    def query(self, query: str, **kw) -> "ClientResult":
        """Alias for execute() (the reference SDK documents both)."""
        return self.execute(query, **kw)

    # -- query API ---------------------------------------------------------
    def execute(self, query: str,
                request_id: Optional[str] = None) -> ClientResult:
        if self._router is not None:
            res = self._router.execute(query)
            return ClientResult(kind=res.kind, message=res.message,
                                rows=res.rows, hits=res.results,
                                count=res.count, value=res.value)
        pb = self._pb
        resp = self._call("neumann.QueryService", "Execute",
                          pb.QueryRequest(query=query,
                                          request_id=request_id or ""),
                          pb.QueryResponse)
        out = _from_proto(resp)
        if out.error:
            raise NeumannError(out.error)
        return out

    def execute_batch(self, queries: List[str]) -> List[ClientResult]:
        if self._router is not None:
            out = []
            for q in queries:
                try:
                    out.append(self.execute(q))
                except NeumannError as e:
                    out.append(ClientResult(kind="error", error=str(e)))
            return out
        pb = self._pb
        resp = self._call(
            "neumann.QueryService", "ExecuteBatch",
            pb.BatchRequest(queries=[pb.QueryRequest(query=q)
                                     for q in queries]),
            pb.BatchResponse)
        return [_from_proto(r) for r in resp.results]

    def execute_paginated(self, query: str, page_size: int = 100
                          ) -> Iterator[List[dict]]:
        if self._router is not None:
            cursor = None
            first = True
            while True:
                rows, cursor = self._router.execute_paginated(
                    query, page_size, cursor)
                if rows or first:
                    yield rows
                first = False
                if cursor is None:
                    return
        else:
            pb = self._pb
            cursor = ""
            first = True
            while True:
                resp = self._call(
                    "neumann.QueryService", "ExecutePaginated",
                    pb.PaginatedRequest(query=query, page_size=page_size,
                                        cursor=cursor),
                    pb.PaginatedResponse)
                if resp.error:
                    raise NeumannError(resp.error)
                rows = [_json_obj(r.json) for r in resp.rows]
                if rows or first:
                    yield rows
                first = False
                if not resp.next_cursor:
                    return
                cursor = resp.next_cursor

    def execute_stream(self, query: str) -> Iterator[ClientResult]:
        if self._router is not None:
            yield self.execute(query)
            return
        pb = self._pb
        for resp in self._call("neumann.QueryService", "ExecuteStream",
                               pb.QueryRequest(query=query),
                               pb.QueryResponse, streaming=True):
            yield _from_proto(resp)

    def health(self) -> Dict[str, object]:
        if self._router is not None:
            return {"ok": True, "entries": len(self._router.store)}
        pb = self._pb
        resp = self._call("neumann.Health", "Check", pb.HealthRequest(),
                          pb.HealthResponse)
        return {"ok": resp.ok, "version": resp.version,
                "entries": resp.entries, "device": resp.device}

    # -- points / collections ----------------------------------------------
    def upsert_points(self, collection: str, points: List[dict]) -> int:
        if self._router is not None:
            if collection not in self._router.vector.list_collections():
                self._router.vector.create_collection(collection)
            for p in points:
                self._router.vector.store_in_collection(
                    collection, p["id"], p["vector"], p.get("payload"))
            return len(points)
        pb = self._pb
        req = pb.UpsertPointsRequest(collection=collection)
        for p in points:
            req.points.append(pb.Point(
                id=p["id"], vector=p["vector"],
                payload_json=json.dumps(p["payload"])
                if p.get("payload") else ""))
        resp = self._call("neumann.PointsService", "Upsert", req,
                          pb.UpsertPointsResponse)
        if resp.error:
            raise NeumannError(resp.error)
        return resp.upserted

    def _points_codec(self):
        from neumann_tpu_torch.server.server import _points_codec

        return _points_codec()

    def query_points(self, collection: str, vector, limit: int = 10,
                     filter_json: Optional[dict] = None,
                     with_payload: bool = True,
                     metric: Optional[str] = None) -> List[dict]:
        """Binary vector query (PointsService.Query). Travels as raw
        packed-float bytes through the native codec — never as a text
        SIMILAR statement. Empty ``collection`` searches the default
        embedding namespace."""
        if self._router is not None:
            if collection:
                hits = self._router.vector.search_in_collection(
                    collection, vector, limit, metric)
            else:
                hits = self._router.vector.search_similar_with_metric(
                    vector, limit, metric or "cosine")
            return [{"id": h.key, "score": h.score} for h in hits]
        import grpc
        import numpy as np

        codec = self._points_codec()
        raw = codec.encode_query(
            collection, np.asarray(vector, "<f4").tobytes(), limit,
            json.dumps(filter_json) if filter_json else None,
            with_payload, metric, 0)
        rpc = getattr(self, "_raw_query_stub", None)
        if rpc is None:
            rpc = self._raw_query_stub = self._channel.unary_unary(
                "/neumann.PointsService/Query")
        try:
            resp = rpc(raw, metadata=self._metadata())
        except grpc.RpcError as e:
            raise NeumannError(
                f"rpc Query failed: {e.code().name}: "
                f"{e.details()}") from e
        _, ids, scores, payloads, error = codec.parse_response(resp)
        if error:
            raise NeumannError(error)
        sc = np.frombuffer(scores, "<f4")
        return [{"id": ids[i], "score": float(sc[i]),
                 "payload": _json_obj(payloads[i])
                 if payloads and payloads[i] else None}
                for i in range(len(ids))]

    def query_points_batch(self, vectors, limit: int = 10,
                           collection: str = "",
                           metric: Optional[str] = None
                           ) -> List[List[dict]]:
        """Many binary queries in one RPC, answered in order (Qdrant
        query_batch parity). A homogeneous batch runs as ONE batched
        device call server-side — the amortized-wire path for bulk
        search from a single caller."""
        import numpy as np

        vecs = np.ascontiguousarray(vectors, dtype="<f4")
        if vecs.ndim != 2:
            raise NeumannError("query_points_batch expects [Q, d]")
        if self._router is not None:
            res = self._router.vector.batch_search_ns(
                vecs, limit, metric,
                f"col/{collection}" if collection else "")
            return [[{"id": h.key, "score": h.score} for h in hits]
                    for hits in res]
        import grpc

        codec = self._points_codec()
        reqs = [codec.encode_query(collection, vecs[i].tobytes(),
                                   limit, None, False, metric, i + 1)
                for i in range(vecs.shape[0])]
        raw = codec.join_messages(reqs)
        rpc = getattr(self, "_raw_batch_stub", None)
        if rpc is None:
            rpc = self._raw_batch_stub = self._channel.unary_unary(
                "/neumann.PointsService/QueryBatch")
        try:
            resp = rpc(raw, metadata=self._metadata())
        except grpc.RpcError as e:
            raise NeumannError(
                f"rpc QueryBatch failed: {e.code().name}: "
                f"{e.details()}") from e
        out = []
        for sub in codec.split_messages(resp):
            _, ids, scores, payloads, error = codec.parse_response(sub)
            if error:
                raise NeumannError(error)
            sc = np.frombuffer(scores, "<f4")
            out.append([{"id": ids[i], "score": float(sc[i])}
                        for i in range(len(ids))])
        return out

    def points_pipeline(self) -> "PointsPipeline":
        """Open a PointsService.QueryStream pipeline: submit many
        binary queries without waiting for responses; each submit
        returns a Future. The server coalesces concurrent stream
        queries into batched device calls — the high-throughput
        serving path for a fleet of queries from one process."""
        if self._channel is None:
            raise NeumannError("points_pipeline needs a remote client")
        return PointsPipeline(self._channel, self._metadata(),
                              self._points_codec())

    def delete_points(self, collection: str, ids: List[str]) -> int:
        pb = self._pb
        resp = self._call("neumann.PointsService", "Delete",
                          pb.DeletePointsRequest(collection=collection,
                                                 ids=ids),
                          pb.DeletePointsResponse)
        return resp.deleted

    def scroll_points(self, collection: str, limit: int = 100
                      ) -> Iterator[dict]:
        pb = self._pb
        offset = ""
        while True:
            resp = self._call("neumann.PointsService", "Scroll",
                              pb.ScrollPointsRequest(
                                  collection=collection, limit=limit,
                                  offset_id=offset),
                              pb.ScrollPointsResponse)
            for p in resp.points:
                yield {"id": p.id, "vector": list(p.vector)}
            if not resp.next_offset_id:
                return
            offset = resp.next_offset_id

    def create_collection(self, name: str, dimension: int = 0,
                          metric: str = "cosine",
                          quantization: str = "none") -> None:
        pb = self._pb
        resp = self._call("neumann.CollectionsService", "Create",
                          pb.CreateCollectionRequest(
                              name=name, dimension=dimension,
                              metric=metric, quantization=quantization),
                          pb.CreateCollectionResponse)
        if resp.error:
            raise NeumannError(resp.error)

    def list_collections(self) -> List[dict]:
        pb = self._pb
        resp = self._call("neumann.CollectionsService", "List",
                          pb.ListCollectionsRequest(),
                          pb.ListCollectionsResponse)
        return [{"name": c.name, "count": c.count,
                 "dimension": c.dimension, "metric": c.metric,
                 "quantization": c.quantization}
                for c in resp.collections]

    def get_collection(self, name: str) -> dict:
        pb = self._pb
        resp = self._call("neumann.CollectionsService", "Get",
                          pb.GetCollectionRequest(name=name),
                          pb.GetCollectionResponse)
        if resp.error:
            raise NeumannError(resp.error)
        c = resp.collection
        return {"name": c.name, "count": c.count,
                "dimension": c.dimension, "metric": c.metric,
                "quantization": c.quantization}

    def delete_collection(self, name: str) -> bool:
        pb = self._pb
        resp = self._call("neumann.CollectionsService", "Delete",
                          pb.DropCollectionRequest(name=name),
                          pb.DropCollectionResponse)
        return resp.ok

    # -- blobs ---------------------------------------------------------------
    def upload_blob(self, name: str, data: bytes,
                    content_type: Optional[str] = None,
                    chunk_size: int = 1 << 20) -> str:
        pb = self._pb

        def gen():
            first = True
            for i in range(0, max(len(data), 1), chunk_size):
                yield pb.BlobChunk(
                    name=name if first else "",
                    content_type=(content_type or "") if first else "",
                    data=data[i: i + chunk_size])
                first = False

        rpc = self._channel.stream_unary(
            "/neumann.BlobService/Upload",
            request_serializer=pb.BlobChunk.SerializeToString,
            response_deserializer=pb.BlobUploadResponse.FromString)
        resp = rpc(gen(), metadata=self._metadata())
        if resp.error:
            raise NeumannError(resp.error)
        return resp.artifact_id

    def download_blob(self, artifact_id: str) -> bytes:
        pb = self._pb
        chunks = self._call("neumann.BlobService", "Download",
                            pb.BlobDownloadRequest(
                                artifact_id=artifact_id),
                            pb.BlobChunk, streaming=True)
        return b"".join(c.data for c in chunks)

    def delete_blob(self, artifact_id: str) -> bool:
        pb = self._pb
        resp = self._call("neumann.BlobService", "Delete",
                          pb.BlobDeleteRequest(artifact_id=artifact_id),
                          pb.BlobDeleteResponse)
        return resp.ok

    def blob_metadata(self, artifact_id: str) -> dict:
        pb = self._pb
        info = self._call("neumann.BlobService", "GetMetadata",
                          pb.BlobMetadataRequest(
                              artifact_id=artifact_id),
                          pb.ArtifactInfo)
        if info.error:
            raise NeumannError(info.error)
        return {"id": info.id, "name": info.name, "size": info.size,
                "checksum": info.checksum,
                "content_type": info.content_type,
                "creator": info.creator, "created": info.created,
                "tags": list(info.tags), "links": list(info.links),
                "chunks": info.chunks}


class PointsPipeline:
    """Pipelined binary vector queries over one QueryStream bidi RPC.

    ``search()`` enqueues a query and returns a
    concurrent.futures.Future immediately; a background reader resolves
    futures as responses arrive (the server may answer out of order —
    correlation is by req_id). One pipeline saturates the server's
    batched device path without one-thread-per-query clients; mirrors
    the throughput role of the reference's multiplexed HTTP/2 tonic
    clients (neumann_client/src/lib.rs execute_stream)."""

    _CLOSE = object()

    def __init__(self, channel, metadata, codec):
        import queue as _queue
        import threading

        self._codec = codec
        self._q: "_queue.Queue" = _queue.Queue()
        self._futures: Dict[int, object] = {}
        self._flock = threading.Lock()
        self._next_id = 1
        self._closed = False
        self._ended = None      # why the response stream ended, once it has
        stub = channel.stream_stream(
            "/neumann.PointsService/QueryStream")
        self._responses = stub(iter(self._q.get, self._CLOSE),
                               metadata=metadata)
        self._reader = threading.Thread(target=self._drain,
                                        daemon=True,
                                        name="points-pipeline-reader")
        self._reader.start()

    def _drain(self) -> None:
        import numpy as np

        err: object = "the server ended the stream"
        try:
            for raw in self._responses:
                rid, ids, scores, payloads, error = \
                    self._codec.parse_response(raw)
                with self._flock:
                    fut = self._futures.pop(rid, None)
                if fut is None:
                    continue
                if error:
                    fut.set_exception(NeumannError(error))
                    continue
                sc = np.frombuffer(scores, "<f4")
                fut.set_result(
                    [{"id": ids[i], "score": float(sc[i]),
                      "payload": _json_obj(payloads[i])
                      if payloads and payloads[i] else None}
                     for i in range(len(ids))])
        except Exception as e:  # noqa: BLE001 — stream died
            err = e
        # ended, cleanly or not: no response will come for what is left
        with self._flock:
            self._ended = err
            pending = list(self._futures.values())
            self._futures.clear()
        for fut in pending:
            if not fut.done():
                fut.set_exception(NeumannError(
                    f"query stream failed: {err}"))

    def search(self, vector, limit: int = 10, collection: str = "",
               filter_json: Optional[dict] = None,
               with_payload: bool = False,
               metric: Optional[str] = None):
        """Enqueue one query; returns a Future of List[dict]."""
        import concurrent.futures as _fut

        import numpy as np

        if self._closed:
            raise NeumannError("pipeline is closed")
        fut = _fut.Future()
        with self._flock:
            if self._ended is not None:
                fut.set_exception(NeumannError(
                    f"query stream failed: {self._ended}"))
                return fut
            rid = self._next_id
            self._next_id += 1
            self._futures[rid] = fut
        self._q.put(self._codec.encode_query(
            collection, np.asarray(vector, "<f4").tobytes(), limit,
            json.dumps(filter_json) if filter_json else None,
            with_payload, metric, rid))
        return fut

    def close(self, timeout_s: float = 10.0) -> None:
        """Half-close the request stream, wait for in-flight
        responses, then stop the reader."""
        if self._closed:
            return
        self._closed = True
        self._q.put(self._CLOSE)
        self._reader.join(timeout=timeout_s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

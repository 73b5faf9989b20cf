"""Asyncio SDK client over grpc.aio.

Parity with neumann-py/src/neumann/aio/{client,transaction}.py: the
same surface as NeumannClient (execute / execute_batch /
execute_stream / health / transaction) with coroutines, plus
transient-error retry with backoff.

The port's copy of ``neumann_tpu/server/aio.py``: only its import
lines differ.
"""

from __future__ import annotations

from typing import AsyncIterator, Dict, List, Optional

from neumann_tpu_torch.server.client import ClientResult, _from_proto
from neumann_tpu_torch.server.retry import RetryConfig, retry_call_async
from neumann_tpu_torch.utils.errors import NeumannError


class AsyncTransaction:
    """async with client.transaction() as tx: ... (commit on clean
    exit, rollback on exception)."""

    def __init__(self, client: "AsyncNeumannClient"):
        self._client = client
        self._started = False
        self._done = False

    @property
    def is_active(self) -> bool:
        return self._started and not self._done

    async def begin(self) -> "AsyncTransaction":
        if self._started:
            raise NeumannError("transaction already started")
        await self._client.execute("BEGIN CHAIN TRANSACTION")
        self._started = True
        return self

    async def execute(self, query: str) -> ClientResult:
        if not self.is_active:
            raise NeumannError("transaction is not active")
        return await self._client.execute(query)

    async def commit(self) -> None:
        if not self.is_active:
            raise NeumannError("transaction is not active")
        await self._client.execute("COMMIT CHAIN")
        self._done = True

    async def rollback(self) -> None:
        if not self.is_active:
            raise NeumannError("transaction is not active")
        await self._client.execute("ROLLBACK CHAIN")
        self._done = True

    async def __aenter__(self) -> "AsyncTransaction":
        return await self.begin()

    async def __aexit__(self, exc_type, exc, tb) -> bool:
        if self.is_active:
            if exc_type is None:
                await self.commit()
            else:
                await self.rollback()
        return False


class AsyncNeumannClient:
    def __init__(self, channel, api_key: Optional[str] = None,
                 retry: Optional[RetryConfig] = None):
        from neumann_tpu_torch.server import neumann_pb2 as pb

        self._channel = channel
        self._api_key = api_key
        self._retry = retry or RetryConfig()
        self._pb = pb

    @staticmethod
    def connect(address: str, api_key: Optional[str] = None,
                tls_root_cert: Optional[bytes] = None,
                retry: Optional[RetryConfig] = None
                ) -> "AsyncNeumannClient":
        import grpc

        if tls_root_cert is not None:
            creds = grpc.ssl_channel_credentials(tls_root_cert)
            channel = grpc.aio.secure_channel(address, creds)
        else:
            channel = grpc.aio.insecure_channel(address)
        return AsyncNeumannClient(channel, api_key=api_key, retry=retry)

    async def close(self) -> None:
        await self._channel.close()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    def _metadata(self):
        return [("x-api-key", self._api_key)] if self._api_key else []

    def _rpc(self, service: str, method: str, resp_cls,
             streaming: bool = False):
        path = f"/{service}/{method}"
        pb = self._pb
        if streaming:
            return self._channel.unary_stream(
                path,
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_cls.FromString)
        return self._channel.unary_unary(
            path,
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=resp_cls.FromString)

    async def _call(self, service, method, request, resp_cls):
        rpc = self._rpc(service, method, resp_cls)

        async def attempt():
            import grpc

            try:
                return await rpc(request, metadata=self._metadata())
            except grpc.aio.AioRpcError as e:
                if _is_transient(e, self._retry):
                    raise                    # retried by retry_call_async
                raise NeumannError(
                    f"rpc /{service}/{method} failed: "
                    f"{e.code().name}: {e.details()}") from e

        try:
            return await retry_call_async(attempt, self._retry)
        except Exception as e:
            if isinstance(e, NeumannError):
                raise
            raise NeumannError(f"rpc /{service}/{method} failed: {e}"
                               ) from e

    # -- query API ----------------------------------------------------------
    async def execute(self, query: str,
                      request_id: Optional[str] = None) -> ClientResult:
        pb = self._pb
        resp = await self._call(
            "neumann.QueryService", "Execute",
            pb.QueryRequest(query=query, request_id=request_id or ""),
            pb.QueryResponse)
        out = _from_proto(resp)
        if not out.ok:
            raise NeumannError(out.error)
        return out

    async def execute_batch(self, queries: List[str]
                            ) -> List[ClientResult]:
        pb = self._pb
        resp = await self._call(
            "neumann.QueryService", "ExecuteBatch",
            pb.BatchRequest(queries=[pb.QueryRequest(query=q)
                                     for q in queries]),
            pb.BatchResponse)
        return [_from_proto(x) for x in resp.results]

    async def execute_stream(self, query: str
                             ) -> AsyncIterator[ClientResult]:
        pb = self._pb
        rpc = self._rpc("neumann.QueryService", "ExecuteStream",
                        pb.QueryResponse, streaming=True)
        async for chunk in rpc(pb.QueryRequest(query=query),
                               metadata=self._metadata()):
            yield _from_proto(chunk)

    async def health(self) -> Dict[str, object]:
        pb = self._pb
        resp = await self._call("neumann.Health", "Check",
                                pb.HealthRequest(), pb.HealthResponse)
        return {"ok": resp.ok, "version": resp.version,
                "entries": resp.entries, "device": resp.device}

    def transaction(self) -> AsyncTransaction:
        return AsyncTransaction(self)


def _is_transient(exc, config: RetryConfig) -> bool:
    try:
        return exc.code().name in config.retryable_codes
    except Exception:
        return False

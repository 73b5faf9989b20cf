"""gRPC-web gateway: browser-compatible framing over the HTTP facade.

The reference serves browsers through tonic-web (neumann_server/src/
lib.rs:271-420 grpc-web layer). grpcio has no built-in equivalent, so
this module implements the grpc-web protocol directly and replays
requests through the SAME generic RPC handlers the native gRPC server
registered — auth, rate limiting, audit, and metrics apply unchanged.

Wire format (protocol spec: grpc/grpc-web PROTOCOL.md):

* request:  POST /<package.Service>/<Method>, content-type
  ``application/grpc-web+proto`` (binary) or
  ``application/grpc-web-text`` (base64 of the binary body);
  body = frames of [1-byte flag][u32 big-endian length][payload],
  flag 0x00 = message.
* response: same framing; data frame(s) followed by one trailer frame
  (flag 0x80) whose payload is ``grpc-status:<n>\\r\\ngrpc-message:...``.
  The HTTP status is always 200; errors live in the trailers.

Unary-unary, unary-stream (e.g. ExecuteStream), and stream-unary
(e.g. Blob Upload) are supported in buffered mode. The bidi reflection
stream is not exposed over web (browsers use unary reflection probes).

The port's copy of ``neumann_tpu/server/grpc_web.py``, unchanged.
"""

from __future__ import annotations

import base64
from collections import namedtuple
from typing import Iterable, List, Optional, Tuple
from urllib.parse import unquote

import grpc

DATA_FLAG = 0x00
TRAILER_FLAG = 0x80

CONTENT_TYPES = ("application/grpc-web", "application/grpc-web+proto",
                 "application/grpc-web-text",
                 "application/grpc-web-text+proto")

_CallDetails = namedtuple("_CallDetails", ["method", "invocation_metadata"])


class _WebAbort(Exception):
    def __init__(self, code: grpc.StatusCode, details: str):
        super().__init__(details)
        self.code = code
        self.details = details


class WebContext:
    """Minimal ServicerContext stand-in for handlers replayed over web."""

    def __init__(self, metadata: Iterable[Tuple[str, str]]):
        self._metadata = tuple(metadata)
        self.trailing: List[Tuple[str, str]] = []

    def invocation_metadata(self):
        return self._metadata

    def set_trailing_metadata(self, md) -> None:
        self.trailing.extend(md)

    def send_initial_metadata(self, md) -> None:  # pragma: no cover
        pass

    def set_code(self, code) -> None:  # pragma: no cover
        pass

    def set_details(self, details) -> None:  # pragma: no cover
        pass

    def abort(self, code: grpc.StatusCode, details: str):
        raise _WebAbort(code, details)


def encode_frame(flag: int, payload: bytes) -> bytes:
    return bytes([flag]) + len(payload).to_bytes(4, "big") + payload


def decode_frames(body: bytes) -> List[Tuple[int, bytes]]:
    frames = []
    pos = 0
    while pos + 5 <= len(body):
        flag = body[pos]
        ln = int.from_bytes(body[pos + 1:pos + 5], "big")
        if pos + 5 + ln > len(body):
            raise ValueError("truncated grpc-web frame")
        frames.append((flag, body[pos + 5:pos + 5 + ln]))
        pos += 5 + ln
    if pos != len(body):
        raise ValueError("trailing bytes after grpc-web frames")
    return frames


def _trailer_payload(code: grpc.StatusCode, message: str,
                     extra: Iterable[Tuple[str, str]] = ()) -> bytes:
    lines = [f"grpc-status:{code.value[0]}"]
    if message:
        lines.append("grpc-message:" + _percent_encode(message))
    for k, v in extra:
        lines.append(f"{k}:{v}")
    return ("\r\n".join(lines) + "\r\n").encode("utf-8")


def _percent_encode(s: str) -> str:
    out = []
    for ch in s:
        o = ord(ch)
        if o < 0x20 or o > 0x7E or ch == "%":
            out.append("".join(f"%{b:02X}"
                               for b in ch.encode("utf-8")))
        else:
            out.append(ch)
    return "".join(out)


class GrpcWebGateway:
    """Translates grpc-web HTTP requests onto a NeumannServer's handlers."""

    def __init__(self, generic_handlers):
        self._generic = list(generic_handlers)

    @staticmethod
    def is_grpc_web(content_type: Optional[str]) -> bool:
        return bool(content_type) and \
            content_type.split(";")[0].strip() in CONTENT_TYPES

    def _find(self, path: str, metadata):
        details = _CallDetails(method=path, invocation_metadata=metadata)
        for gh in self._generic:
            h = gh.service(details)
            if h is not None:
                return h
        return None

    def handle(self, path: str, headers, body: bytes
               ) -> Tuple[bytes, str]:
        """Process one grpc-web request. Returns (body, content_type);
        the HTTP status is always 200 per the protocol."""
        ctype = (headers.get("Content-Type") or "").split(";")[0].strip()
        text_mode = ctype.startswith("application/grpc-web-text")
        if text_mode:
            body = base64.b64decode(body)
        metadata = tuple(
            (k.lower(), v) for k, v in headers.items()
            if k.lower() not in ("content-type", "content-length",
                                 "host", "connection", "accept",
                                 "origin", "user-agent"))
        path = unquote(path.split("?")[0])
        out_type = ctype if ctype in CONTENT_TYPES \
            else "application/grpc-web+proto"

        handler = self._find(path, metadata)
        if handler is None:
            resp = encode_frame(TRAILER_FLAG, _trailer_payload(
                grpc.StatusCode.UNIMPLEMENTED, f"unknown method {path}"))
            return (base64.b64encode(resp) if text_mode else resp,
                    out_type)

        ctx = WebContext(metadata)
        try:
            msgs = [handler.request_deserializer(payload)
                    for flag, payload in decode_frames(body)
                    if flag == DATA_FLAG]
            if handler.unary_unary is not None:
                if len(msgs) != 1:
                    raise _WebAbort(grpc.StatusCode.INVALID_ARGUMENT,
                                    "expected exactly one message")
                responses = [handler.unary_unary(msgs[0], ctx)]
            elif handler.unary_stream is not None:
                if len(msgs) != 1:
                    raise _WebAbort(grpc.StatusCode.INVALID_ARGUMENT,
                                    "expected exactly one message")
                responses = list(handler.unary_stream(msgs[0], ctx))
            elif handler.stream_unary is not None:
                responses = [handler.stream_unary(iter(msgs), ctx)]
            else:
                raise _WebAbort(
                    grpc.StatusCode.UNIMPLEMENTED,
                    "bidi streaming is not supported over grpc-web")
            frames = b"".join(
                encode_frame(DATA_FLAG,
                             handler.response_serializer(r))
                for r in responses)
            frames += encode_frame(TRAILER_FLAG, _trailer_payload(
                grpc.StatusCode.OK, "", ctx.trailing))
        except _WebAbort as e:
            frames = encode_frame(TRAILER_FLAG, _trailer_payload(
                e.code, e.details, ctx.trailing))
        except ValueError as e:
            frames = encode_frame(TRAILER_FLAG, _trailer_payload(
                grpc.StatusCode.INVALID_ARGUMENT, str(e), ctx.trailing))
        except Exception as e:  # noqa: BLE001 — surface faithfully
            frames = encode_frame(TRAILER_FLAG, _trailer_payload(
                grpc.StatusCode.INTERNAL,
                f"{type(e).__name__}: {e}", ctx.trailing))

        return (base64.b64encode(frames) if text_mode else frames,
                out_type)

"""Cluster transports: in-process fake with fault injection + TCP.

Parity with tensor_chain's Transport trait (network.rs:929-943) and
MemoryTransport (network.rs:981-1283): send/broadcast/recv between named
peers, with partition sets, asymmetric inbound/outbound blocking,
probabilistic drops, and message corruption — the hooks the reference's
chaos/DST tests rely on. TcpTransport adds length-delimited framing over
sockets for real multi-process clusters.

The port's copy of ``neumann_tpu/chain/transport.py``: only its import
lines differ, and a remark on the TPU's own interconnect is gone.
"""

from __future__ import annotations

import base64
import json
import os
import queue
import socket
import struct
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from neumann_tpu_torch.utils.errors import ChainError


def _json_default(o):
    """bytes in JSON frames ride as a tagged base64 dict (the binary
    codec carries them raw; JSON emission must not crash on them)."""
    if isinstance(o, (bytes, bytearray, memoryview)):
        return {"__b64__": base64.b64encode(bytes(o)).decode("ascii")}
    raise TypeError(f"not JSON-wirable: {type(o).__name__}")


def _json_hook(d):
    if len(d) == 1 and "__b64__" in d:
        try:
            return base64.b64decode(d["__b64__"])
        except Exception:
            return d
    return d


@dataclass
class Message:
    """Cluster message envelope; `kind` plays the role of the reference's
    Message enum variants (RequestVote/AppendEntries/TxPrepare/...)."""

    kind: str
    src: str
    dst: str
    payload: dict = field(default_factory=dict)

    def encode(self) -> bytes:
        """Wire encoding, JSON by default; NEUMANN_WIRE_BINARY=1 opts
        into the binary format (chain/wire.py: packed arrays for
        embedding/id payloads — the reference's bincode+sparse-encoding
        analog, network.rs / tcp/framing.rs).

        Upgrade story (two-phase, like any wire change): binary is
        DECODE-ONLY by default because nodes built before the binary
        codec only json.loads frames — a mixed-version cluster must
        first get every node onto a decode-capable version, and only
        THEN enable binary sends (set NEUMANN_WIRE_BINARY=1 fleet-wide
        once the rollout completes). New nodes understand either
        format on receive regardless of this setting."""
        if os.environ.get("NEUMANN_WIRE_BINARY") == "1":
            return self.encode_binary()
        return self.encode_json()

    def encode_binary(self) -> bytes:
        from neumann_tpu_torch.chain import wire

        return wire.encode_message(self.kind, self.src, self.dst,
                                   self.payload)

    def encode_json(self) -> bytes:
        return json.dumps({"k": self.kind, "s": self.src, "d": self.dst,
                           "p": self.payload},
                          default=_json_default).encode("utf-8")

    @staticmethod
    def decode(buf: bytes) -> "Message":
        if buf[:2] == b"N1":
            from neumann_tpu_torch.chain import wire

            k, s, d, p = wire.decode_message(buf)
            return Message(k, s, d, p)
        o = json.loads(buf.decode("utf-8"), object_hook=_json_hook)
        return Message(o["k"], o["s"], o["d"], o["p"])


class TransportHub:
    """Shared switchboard for MemoryTransports (one per simulated node)."""

    def __init__(self, seed: int = 0):
        self._nodes: Dict[str, "MemoryTransport"] = {}
        self._lock = threading.RLock()
        # fault injection state
        self.partitions: List[Set[str]] = []
        self.blocked_inbound: Set[str] = set()
        self.blocked_outbound: Set[str] = set()
        # directed per-link faults (network.rs partial partitions /
        # set_link_quality): (src, dst) blocks and drop probabilities —
        # these express NON-transitive topologies (a bridge node that
        # both sides reach while the sides cannot reach each other)
        # that whole-node groups cannot
        self.blocked_links: Set[Tuple[str, str]] = set()
        self.link_drop: Dict[Tuple[str, str], float] = {}
        self.drop_probability = 0.0
        self.corrupt_probability = 0.0
        # seeded reorder/latency fault (message_reordering.rs /
        # network_latency.rs): sampled messages sit in a bounded buffer
        # and are released in random order as later traffic displaces
        # them — delayed AND reordered, deterministically per seed
        self.reorder_probability = 0.0
        self.reorder_buffer_size = 8
        self._reorder_buf: List[Message] = []
        import random

        self._rng = random.Random(seed)

    def register(self, node_id: str) -> "MemoryTransport":
        with self._lock:
            t = MemoryTransport(node_id, self)
            self._nodes[node_id] = t
            return t

    def peers(self) -> List[str]:
        with self._lock:
            return sorted(self._nodes)

    # -- fault injection -------------------------------------------------
    def partition(self, *groups: Set[str]) -> None:
        """Nodes can only talk within their group."""
        self.partitions = [set(g) for g in groups]

    def block_link(self, src: str, dst: str,
                   bidirectional: bool = False) -> None:
        """Drop every message src -> dst (one-way unless requested)."""
        self.blocked_links.add((src, dst))
        if bidirectional:
            self.blocked_links.add((dst, src))

    def unblock_link(self, src: str, dst: str,
                     bidirectional: bool = False) -> None:
        self.blocked_links.discard((src, dst))
        if bidirectional:
            self.blocked_links.discard((dst, src))

    def set_link_quality(self, src: str, dst: str,
                         drop_probability: float) -> None:
        """Per-link loss rate; 1.0 == full drop, 0.0 removes the fault."""
        if drop_probability <= 0.0:
            self.link_drop.pop((src, dst), None)
        else:
            self.link_drop[(src, dst)] = min(1.0, drop_probability)

    def flush_reordered(self) -> int:
        """Release every buffered (delayed) message in seeded-random
        order; returns the count released."""
        with self._lock:
            buf, self._reorder_buf = self._reorder_buf, []
            self._rng.shuffle(buf)
        for m in buf:
            with self._lock:
                target = self._nodes.get(m.dst)
            if target is not None:
                target._enqueue(m)
        return len(buf)

    def heal(self) -> None:
        self.partitions = []
        self.blocked_inbound.clear()
        self.blocked_outbound.clear()
        self.blocked_links.clear()
        self.link_drop.clear()
        self.drop_probability = 0.0
        self.corrupt_probability = 0.0
        self.reorder_probability = 0.0
        self.flush_reordered()

    def _can_deliver(self, src: str, dst: str) -> bool:
        if src in self.blocked_outbound or dst in self.blocked_inbound:
            return False
        if (src, dst) in self.blocked_links:
            return False
        q = self.link_drop.get((src, dst))
        if q is not None and self._rng.random() < q:
            return False
        if self.partitions:
            for group in self.partitions:
                if src in group and dst in group:
                    break
            else:
                return False
        if self.drop_probability and \
                self._rng.random() < self.drop_probability:
            return False
        return True

    def deliver(self, msg: Message) -> bool:
        with self._lock:
            target = self._nodes.get(msg.dst)
        if target is None or not self._can_deliver(msg.src, msg.dst):
            return False
        if self.corrupt_probability and \
                self._rng.random() < self.corrupt_probability:
            msg = Message(msg.kind, msg.src, msg.dst,
                          {"__corrupted__": True})
        if self.reorder_probability and \
                self._rng.random() < self.reorder_probability:
            with self._lock:
                self._reorder_buf.append(msg)
                if len(self._reorder_buf) <= self.reorder_buffer_size:
                    return True          # held: delivered later
                idx = self._rng.randrange(len(self._reorder_buf))
                msg = self._reorder_buf.pop(idx)
            with self._lock:
                target = self._nodes.get(msg.dst)
            if target is None:
                return True              # original was accepted
        target._enqueue(msg)
        return True


class MemoryTransport:
    """In-process transport endpoint (one simulated node)."""

    def __init__(self, node_id: str, hub: TransportHub):
        self.node_id = node_id
        self.hub = hub
        self._queue: "queue.Queue[Message]" = queue.Queue()

    def _enqueue(self, msg: Message) -> None:
        self._queue.put(msg)

    def send(self, dst: str, kind: str, payload: dict) -> bool:
        return self.hub.deliver(Message(kind, self.node_id, dst, payload))

    def broadcast(self, kind: str, payload: dict) -> int:
        n = 0
        for peer in self.hub.peers():
            if peer != self.node_id and self.send(peer, kind, payload):
                n += 1
        return n

    def recv(self, timeout: Optional[float] = 0.0) -> Optional[Message]:
        try:
            if timeout == 0.0:
                return self._queue.get_nowait()
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def drain(self) -> List[Message]:
        out = []
        while True:
            m = self.recv()
            if m is None:
                return out
            out.append(m)


# ---------------------------------------------------------------------------
# TCP transport: length-delimited frames, background reader thread
# ---------------------------------------------------------------------------

# frame = [len u32][flags u8][body]; flags bit0 = deflate-compressed body.
# The reference frames with LZ4 (network.rs TCP backend); zlib is the
# stdlib equivalent here — same shape (flagged per-frame compression),
# different codec.
_FRAME = struct.Struct("<IB")
_MAX_FRAME = 64 * 1024 * 1024
_FLAG_COMPRESSED = 1


def make_tls_contexts(cert_pem: bytes, key_pem: bytes,
                      ca_pem: "Optional[bytes]" = None):
    """(server_ctx, client_ctx) from PEM cert/key — pair with
    ``server.generate_self_signed()`` or ``vault.pki.PkiEngine``. The
    client trusts ``ca_pem`` when given (CA-issued certs), otherwise it
    pins the cert itself (self-signed)."""
    import ssl
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".pem", delete=False) as cf:
        cf.write(cert_pem)
        cert_path = cf.name
    with tempfile.NamedTemporaryFile(suffix=".pem", delete=False) as kf:
        kf.write(key_pem)
        key_path = kf.name
    with tempfile.NamedTemporaryFile(suffix=".pem", delete=False) as af:
        af.write(ca_pem if ca_pem is not None else cert_pem)
        ca_path = af.name
    server_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server_ctx.load_cert_chain(cert_path, key_path)
    client_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    client_ctx.load_verify_locations(ca_path)
    client_ctx.check_hostname = False  # peers verify by trust root
    import os

    os.unlink(cert_path)
    os.unlink(key_path)
    os.unlink(ca_path)
    return server_ctx, client_ctx


class PeerRateLimiter:
    """Per-peer token bucket (tcp/rate_limit.rs parity): each sender id
    gets ``bucket_size`` burst tokens refilled at ``refill_rate``/s;
    ``check`` spends one token or reports the peer as limited."""

    def __init__(self, bucket_size: int = 100, refill_rate: float = 50.0):
        import time as _time

        self.bucket_size = float(bucket_size)
        self.refill_rate = float(refill_rate)
        self._now = _time.monotonic
        self._buckets: Dict[str, Tuple[float, float]] = {}
        self._lock = threading.Lock()
        self.limited = 0        # dropped-message counter

    def check(self, peer: str) -> bool:
        now = self._now()
        with self._lock:
            tokens, last = self._buckets.get(peer,
                                             (self.bucket_size, now))
            tokens = min(self.bucket_size,
                         tokens + (now - last) * self.refill_rate)
            if tokens < 1.0:
                self._buckets[peer] = (tokens, now)
                self.limited += 1
                return False
            self._buckets[peer] = (tokens - 1.0, now)
            return True

    def available_tokens(self, peer: str) -> int:
        now = self._now()
        with self._lock:
            tokens, last = self._buckets.get(peer,
                                             (self.bucket_size, now))
            return int(min(self.bucket_size,
                           tokens + (now - last) * self.refill_rate))

    def reset_peer(self, peer: str) -> None:
        with self._lock:
            self._buckets.pop(peer, None)

    def clear(self) -> None:
        with self._lock:
            self._buckets.clear()


class TcpTransport:
    """Point-to-point TCP control-plane transport.

    listen() accepts peers; connect() dials them; incoming messages go to
    the registered handler (or an internal queue). Framing: [len u32]
    [flags u8][Message json]. Optional per-frame deflate compression
    (bodies >= ``compress_min``), optional TLS (pass the contexts from
    ``make_tls_contexts``), per-peer connection pools with automatic
    one-shot reconnect on send failure, and optional per-peer inbound
    rate limiting — parity with the reference TCP backend's LZ4 framing,
    rustls TLS, connection pooling, and token-bucket rate limiter
    (tensor_chain network backend, tcp/rate_limit.rs).
    """

    def __init__(self, node_id: str, host: str = "127.0.0.1",
                 port: int = 0, compress: bool = False,
                 compress_min: int = 512,
                 tls_server=None, tls_client=None, pool_size: int = 1,
                 rate_limiter: Optional[PeerRateLimiter] = None):
        self.node_id = node_id
        self.compress = compress
        self.compress_min = compress_min
        self._tls_server = tls_server
        self._tls_client = tls_client
        self.rate_limiter = rate_limiter
        self.pool_size = max(1, pool_size)
        self._handler: Optional[Callable[[Message], None]] = None
        self._queue: "queue.Queue[Message]" = queue.Queue()
        self._pools: Dict[str, List[socket.socket]] = {}
        self._addrs: Dict[str, Tuple[str, int]] = {}
        self._rr: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.address = self._sock.getsockname()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def on_message(self, handler: Callable[[Message], None]) -> None:
        self._handler = handler

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if self._tls_server is not None:
                try:
                    conn = self._tls_server.wrap_socket(conn,
                                                        server_side=True)
                except Exception:
                    conn.close()
                    continue
            threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True).start()

    def _read_loop(self, conn: socket.socket) -> None:
        import zlib

        try:
            while not self._stop.is_set():
                hdr = self._read_exact(conn, _FRAME.size)
                if hdr is None:
                    return
                length, flags = _FRAME.unpack(hdr)
                if length > _MAX_FRAME:
                    raise ChainError("oversized frame")
                body = self._read_exact(conn, length)
                if body is None:
                    return
                if flags & _FLAG_COMPRESSED:
                    # decompressobj + max_length caps the OUTPUT size —
                    # zlib.decompress(bufsize=...) is only an initial
                    # buffer hint, so a deflate bomb inside a small
                    # frame could otherwise expand to gigabytes
                    d = zlib.decompressobj()
                    body = d.decompress(body, _MAX_FRAME)
                    if d.unconsumed_tail:
                        raise ChainError(
                            "decompressed frame exceeds limit")
                msg = Message.decode(body)
                if self.rate_limiter is not None and \
                        not self.rate_limiter.check(msg.src):
                    continue        # over budget: drop, keep the conn
                if self._handler is not None:
                    self._handler(msg)
                else:
                    self._queue.put(msg)
        except Exception:  # bad frame / peer gone / TLS or zlib error
            return
        finally:
            conn.close()

    @staticmethod
    def _read_exact(conn, n) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            part = conn.recv(n - len(buf))
            if not part:
                return None
            buf += part
        return buf

    def _dial(self, address: Tuple[str, int]) -> socket.socket:
        s = socket.create_connection(address, timeout=5.0)
        if self._tls_client is not None:
            s = self._tls_client.wrap_socket(s,
                                             server_hostname=address[0])
        return s

    def connect(self, peer_id: str, address: Tuple[str, int]) -> None:
        pool = [self._dial(address) for _ in range(self.pool_size)]
        with self._lock:
            for old in self._pools.get(peer_id, []):
                old.close()
            self._pools[peer_id] = pool
            self._addrs[peer_id] = tuple(address)
            self._rr[peer_id] = 0

    def disconnect(self, peer_id: str) -> None:
        with self._lock:
            pool = self._pools.pop(peer_id, [])
            self._addrs.pop(peer_id, None)
            self._rr.pop(peer_id, None)
        for s in pool:
            s.close()

    def _frame(self, body: bytes) -> bytes:
        flags = 0
        if self.compress and len(body) >= self.compress_min:
            import zlib

            packed = zlib.compress(body, 6)
            if len(packed) < len(body):
                body, flags = packed, _FLAG_COMPRESSED
        return _FRAME.pack(len(body), flags) + body

    def send(self, dst: str, kind: str, payload: dict) -> bool:
        frame = self._frame(
            Message(kind, self.node_id, dst, payload).encode())
        for _attempt in range(2):
            with self._lock:
                pool = self._pools.get(dst, [])
                addr = self._addrs.get(dst)
                if pool:
                    idx = self._rr.get(dst, 0) % len(pool)
                    self._rr[dst] = idx + 1
                    s = pool[idx]
                else:
                    s = None
            if s is None:
                # pool empty; reconnect once if the peer is still known
                if addr is None:
                    return False
                try:
                    s = self._dial(addr)
                except OSError:
                    return False
                with self._lock:
                    if dst not in self._addrs:  # disconnected meanwhile
                        s.close()
                        return False
                    self._pools.setdefault(dst, []).append(s)
            try:
                s.sendall(frame)
                return True
            except OSError:
                with self._lock:
                    p = self._pools.get(dst, [])
                    if s in p:
                        p.remove(s)
                s.close()
        return False

    def broadcast(self, kind: str, payload: dict) -> int:
        with self._lock:
            peers = list(self._pools)
        return sum(1 for p in peers if self.send(p, kind, payload))

    def recv(self, timeout: Optional[float] = 0.0) -> Optional[Message]:
        try:
            if timeout == 0.0:
                return self._queue.get_nowait()
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self._stop.set()
        self._sock.close()
        with self._lock:
            for pool in self._pools.values():
                for s in pool:
                    s.close()
            self._pools.clear()
            self._addrs.clear()


# ---------------------------------------------------------------------------
# geometric transport: embedding-aware routing over any base transport
# ---------------------------------------------------------------------------

class GeometricTransport:
    """Embedding-aware routing layer over any transport (network.rs
    GeometricTransport trait: send_to_nearest + broadcast_to_region).

    Wraps a MemoryTransport or TcpTransport; callers register peer
    embeddings (from gossip or config) and route by cosine similarity
    instead of by name.
    """

    def __init__(self, base):
        self.base = base
        self._embeddings: Dict[str, "object"] = {}
        self._lock = threading.Lock()

    def update_peer_embedding(self, peer_id: str, embedding) -> None:
        import numpy as np

        v = np.asarray(embedding, dtype=np.float32)
        with self._lock:
            self._embeddings[peer_id] = v

    def remove_peer(self, peer_id: str) -> None:
        with self._lock:
            self._embeddings.pop(peer_id, None)

    @staticmethod
    def _cosine(a, b) -> float:
        import numpy as np

        na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
        if na == 0.0 or nb == 0.0:
            return 0.0
        return float(a @ b) / (na * nb)

    def nearest_peers(self, embedding, k: int = 1) -> List[str]:
        import numpy as np

        q = np.asarray(embedding, dtype=np.float32)
        with self._lock:
            scored = [(self._cosine(q, v), p)
                      for p, v in self._embeddings.items()]
        scored.sort(key=lambda sv: (-sv[0], sv[1]))
        return [p for _, p in scored[:k]]

    def send_to_nearest(self, embedding, kind: str,
                        payload: dict) -> Optional[str]:
        """Send to the peer whose embedding is most similar; returns the
        chosen peer id (None when no peer is registered or send fails)."""
        for peer in self.nearest_peers(embedding, k=len(self._embeddings)):
            if self.base.send(peer, kind, payload):
                return peer
        return None

    def broadcast_to_region(self, region_centroid, kind: str,
                            payload: dict,
                            similarity_threshold: float = 0.8) -> int:
        """Send to every peer whose embedding is within the region
        (cosine >= threshold); returns the delivery count."""
        import numpy as np

        c = np.asarray(region_centroid, dtype=np.float32)
        with self._lock:
            members = [p for p, v in self._embeddings.items()
                       if self._cosine(c, v) >= similarity_threshold]
        return sum(1 for p in members
                   if self.base.send(p, kind, payload))

    # passthrough so GeometricTransport satisfies the Transport surface
    def send(self, dst: str, kind: str, payload: dict) -> bool:
        return self.base.send(dst, kind, payload)

    def recv(self, timeout: Optional[float] = 0.0) -> Optional[Message]:
        return self.base.recv(timeout)

    def broadcast(self, kind: str, payload: dict) -> int:
        return self.base.broadcast(kind, payload)

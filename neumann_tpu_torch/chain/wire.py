"""Binary wire codec for cluster control-plane messages.

The reference frames cluster messages with bincode + LZ4 and a sparse
message encoding (tensor_chain/src/network.rs, tcp/{framing,
compression}.rs). JSON (round 1-2 here) is fine for correctness but
cannot sustain high-entry-rate replication: an AppendEntries batch
carrying embedding payloads spends most of its bytes and CPU printing
floats (~19 chars each) and re-parsing them.

This codec is a small tagged binary format for JSON-shaped values with
one critical extra: homogeneous numeric lists (embedding vectors, id
lists) encode as packed little-endian arrays — 8 bytes per float, zero
parsing. Layout per value: 1 tag byte + payload.

  N            None           T/F  bool
  i <i64>      int            f <f64>  float
  s <u32><utf8> str           b <u32><raw>  bytes
  D <u32><f64*n>   list of floats (packed)
  I <u32><i64*n>   list of ints  (packed)
  l <u32><value*n> list (mixed)
  d <u32><(str,value)*n> dict
  j <u32><json> fallback for anything else (e.g. ints > 63 bits)

Messages start with magic 0xN1 ("\\x4e\\x31"); decoders sniff the first
byte and fall back to JSON for '{'-led frames, so binary and JSON peers
interoperate during upgrades.

The port's copy of ``neumann_tpu/chain/wire.py``:
only its import lines differ.
"""

from __future__ import annotations

import json
import struct
from typing import Any, List, Tuple

MAGIC = b"N1"
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


def _enc_value(v: Any, out: List[bytes]) -> None:
    if v is None:
        out.append(b"N")
    elif v is True:
        out.append(b"T")
    elif v is False:
        out.append(b"F")
    elif type(v) is int:
        if _INT64_MIN <= v <= _INT64_MAX:
            out.append(b"i")
            out.append(_I64.pack(v))
        else:
            blob = json.dumps(v).encode()
            out.append(b"j")
            out.append(_U32.pack(len(blob)))
            out.append(blob)
    elif type(v) is float:
        out.append(b"f")
        out.append(_F64.pack(v))
    elif type(v) is str:
        b = v.encode("utf-8")
        out.append(b"s")
        out.append(_U32.pack(len(b)))
        out.append(b)
    elif type(v) is bytes:
        out.append(b"b")
        out.append(_U32.pack(len(v)))
        out.append(v)
    elif type(v) is list or type(v) is tuple:
        n = len(v)
        # packed fast paths: embedding vectors / id lists dominate
        # replication volume
        if n and all(type(x) is float for x in v):
            out.append(b"D")
            out.append(_U32.pack(n))
            out.append(struct.pack(f"<{n}d", *v))
        elif n and all(type(x) is int
                       and _INT64_MIN <= x <= _INT64_MAX for x in v):
            out.append(b"I")
            out.append(_U32.pack(n))
            out.append(struct.pack(f"<{n}q", *v))
        else:
            out.append(b"l")
            out.append(_U32.pack(n))
            for x in v:
                _enc_value(x, out)
    elif type(v) is dict:
        out.append(b"d")
        out.append(_U32.pack(len(v)))
        for key, val in v.items():
            if type(key) is not str:
                raise TypeError(
                    f"wire dict keys must be str, got {type(key)}")
            kb = key.encode("utf-8")
            out.append(_U32.pack(len(kb)))
            out.append(kb)
            _enc_value(val, out)
    else:
        # numpy scalars/arrays, Decimals, ... — JSON's repr rules
        blob = json.dumps(v, default=_np_default).encode()
        out.append(b"j")
        out.append(_U32.pack(len(blob)))
        out.append(blob)


def _np_default(v):
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        return tolist()
    item = getattr(v, "item", None)
    if item is not None:
        return item()
    raise TypeError(f"not wire-encodable: {type(v)}")


def _dec_value(buf: memoryview, pos: int) -> Tuple[Any, int]:
    tag = buf[pos]
    pos += 1
    if tag == 0x4E:          # N
        return None, pos
    if tag == 0x54:          # T
        return True, pos
    if tag == 0x46:          # F
        return False, pos
    if tag == 0x69:          # i
        return _I64.unpack_from(buf, pos)[0], pos + 8
    if tag == 0x66:          # f
        return _F64.unpack_from(buf, pos)[0], pos + 8
    if tag == 0x73:          # s
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if tag == 0x62:          # b
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        return bytes(buf[pos:pos + n]), pos + n
    if tag == 0x44:          # D packed f64
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        end = pos + 8 * n
        return list(struct.unpack_from(f"<{n}d", buf, pos)), end
    if tag == 0x49:          # I packed i64
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        end = pos + 8 * n
        return list(struct.unpack_from(f"<{n}q", buf, pos)), end
    if tag == 0x6C:          # l
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        out = []
        for _ in range(n):
            v, pos = _dec_value(buf, pos)
            out.append(v)
        return out, pos
    if tag == 0x64:          # d
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        out = {}
        for _ in range(n):
            kn = _U32.unpack_from(buf, pos)[0]
            pos += 4
            key = str(buf[pos:pos + kn], "utf-8")
            pos += kn
            out[key], pos = _dec_value(buf, pos)
        return out, pos
    if tag == 0x6A:          # j
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        return json.loads(bytes(buf[pos:pos + n])), pos + n
    raise ValueError(f"bad wire tag 0x{tag:02x} at {pos - 1}")


def encode_message(kind: str, src: str, dst: str, payload: dict
                   ) -> bytes:
    out: List[bytes] = [MAGIC]
    _enc_value(kind, out)
    _enc_value(src, out)
    _enc_value(dst, out)
    _enc_value(payload, out)
    return b"".join(out)


def decode_message(buf: bytes) -> Tuple[str, str, str, dict]:
    mv = memoryview(buf)
    if bytes(mv[:2]) != MAGIC:
        raise ValueError("not a binary wire message")
    pos = 2
    # A corrupt/truncated frame must surface as a domain error, never a
    # crash (reference fuzzes its framing the same way, tcp_framing.rs):
    # out-of-range reads raise IndexError/struct.error inside _dec_value.
    try:
        kind, pos = _dec_value(mv, pos)
        src, pos = _dec_value(mv, pos)
        dst, pos = _dec_value(mv, pos)
        payload, pos = _dec_value(mv, pos)
    except (IndexError, struct.error, OverflowError) as e:
        raise ValueError(f"corrupt wire message: {e}") from e
    if pos != len(buf):
        raise ValueError(f"trailing bytes after message ({len(buf)-pos})")
    return kind, src, dst, payload

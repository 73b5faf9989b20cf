"""Defense-in-depth validation for cluster messages.

Parity with tensor_chain/src/message_validation.rs: every inbound
Message is schema-checked (known kind, required payload fields, type and
bound constraints) before it reaches a consensus core, so a corrupted or
malicious frame degrades to a reject instead of an exception inside
Raft/2PC.

The port's copy of ``neumann_tpu/chain/message_validation.py``: a
``cluster_query``'s statement is bounded like a blob (``_MAX_BLOB``),
where the reference bounds it at ``_MAX_STR`` (4,096 characters) and so
drops every statement of a 768-float vector (an EMBED, a SIMILAR) that
a ClusterClient sends, the client waiting out its timeout; otherwise
only its import lines differ.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from neumann_tpu_torch.chain.transport import Message

_MAX_ENTRIES = 10_000
_MAX_STR = 4096

# kind -> {field: validator}
_SCHEMAS: Dict[str, Dict[str, object]] = {
    "pre_vote_req": {"term": int, "last_index": int, "last_term": int},
    "pre_vote_resp": {"term": int, "granted": bool},
    "vote_req": {"term": int, "last_index": int, "last_term": int},
    "vote_resp": {"term": int, "granted": bool},
    "append_entries": {"term": int, "prev_index": int, "prev_term": int,
                       "entries": list, "leader_commit": int},
    "append_resp": {"term": int, "success": bool, "match": int},
    "install_snapshot": {"term": int, "last_index": int,
                         "last_term": int},
    "timeout_now": {"term": int},
    "tx_prepare": {"tx": str, "ops": list},
    "tx_vote": {"tx": str, "ok": bool},
    "tx_commit": {"tx": str},
    "tx_abort": {"tx": str},
    "tx_ack": {"tx": str},
    "ping": {"members": dict},
    "ack": {"members": dict},
    "ping_req": {"target": str, "members": dict},
    "cluster_query": {"query": "blob"},   # a statement, vectors too
    "cluster_query_result": {},
    # node/cluster integration kinds (node.py / integration.py)
    "ack_relay": {"target": str, "members": dict},
    "snap_chunk": {"id": str, "offset": int, "total": int,
                   "sha256": str, "data": "blob"},
    "merge_offer": {"items": list, "reply_to": str, "oid": str},
    "merge_done": {"oid": str},
    "cluster_forward": {"entry": dict},
    "client_hello": {"addr": list},
}

# fields that are legal but not required (validated when present)
_OPTIONAL: Dict[str, Dict[str, object]] = {
    "cluster_query": {"reply_to": str, "qid": str, "strong": bool},
    "merge_done": {"report": dict},
    "snap_chunk": {"raft_meta": dict},
}

# hex payloads may legitimately exceed _MAX_STR (snap chunks are 256 KiB
# before hex doubling); bound them separately
_MAX_BLOB = 2 * 1024 * 1024


def _check_field(fname: str, val, ftype) -> Optional[str]:
    """None when valid, else the reject reason."""
    if ftype is int:
        if isinstance(val, bool) or not isinstance(val, int):
            return f"field {fname!r} must be int"
        if not (-1 <= val <= 2 ** 62):
            return f"field {fname!r} out of range"
    elif ftype is bool and not isinstance(val, bool):
        return f"field {fname!r} must be bool"
    elif ftype is str:
        if not isinstance(val, str) or len(val) > _MAX_STR:
            return f"field {fname!r} must be a short string"
    elif ftype is list and not isinstance(val, list):
        return f"field {fname!r} must be a list"
    elif ftype is dict and not isinstance(val, dict):
        return f"field {fname!r} must be a mapping"
    elif ftype == "blob":
        if not isinstance(val, str) or len(val) > _MAX_BLOB:
            return f"field {fname!r} must be a bounded blob"
    return None


def validate(msg: Message) -> Tuple[bool, str]:
    """(ok, reason). Unknown kinds and malformed payloads are rejected."""
    if not isinstance(msg.payload, dict):
        return False, "payload is not a mapping"
    if msg.payload.get("__corrupted__"):
        return False, "corruption marker set"
    schema = _SCHEMAS.get(msg.kind)
    if schema is None:
        return False, f"unknown message kind {msg.kind!r}"
    for fname, ftype in schema.items():
        if fname not in msg.payload:
            return False, f"missing field {fname!r}"
        reason = _check_field(fname, msg.payload[fname], ftype)
        if reason is not None:
            return False, reason
    for fname, ftype in _OPTIONAL.get(msg.kind, {}).items():
        if fname in msg.payload:
            reason = _check_field(fname, msg.payload[fname], ftype)
            if reason is not None:
                return False, reason
    if msg.kind == "append_entries":
        entries = msg.payload["entries"]
        if len(entries) > _MAX_ENTRIES:
            return False, "too many entries"
        for e in entries:
            if not isinstance(e, dict) or "term" not in e or \
                    "payload" not in e:
                return False, "malformed log entry"
    if msg.kind == "snap_chunk":
        off, total = msg.payload["offset"], msg.payload["total"]
        if not (0 <= off < max(total, 1)) or total > 2 ** 32:
            return False, "bad chunk offsets"
    if msg.kind == "merge_offer":
        items = msg.payload["items"]
        if len(items) > _MAX_ENTRIES:
            return False, "too many merge items"
        for it in items:
            if not isinstance(it, dict) or \
                    not isinstance(it.get("key"), str) or \
                    not isinstance(it.get("data"), str) or \
                    len(it["data"]) > _MAX_BLOB:
                return False, "malformed merge item"
    if msg.kind in ("ping", "ack", "ping_req", "ack_relay"):
        members = msg.payload["members"]
        if len(members) > _MAX_ENTRIES:
            return False, "too many members"
        for peer, info in members.items():
            if not isinstance(peer, str) or len(peer) > _MAX_STR:
                return False, "malformed member id"
            if not isinstance(info, dict):
                return False, "malformed member record"
            status = info.get("status")
            inc, ver = info.get("inc"), info.get("v")
            if status not in ("alive", "suspect", "faulty"):
                return False, "unknown member status"
            for fld in (inc, ver):
                if isinstance(fld, bool) or not isinstance(fld, int) \
                        or not (0 <= fld <= 2 ** 62):
                    return False, "malformed member counters"
    return True, ""


class ValidatingInbox:
    """Wrap a node's handle() with validation + a reject counter."""

    def __init__(self, node):
        self.node = node
        self.rejected = 0
        self.reasons: List[str] = []

    def handle(self, msg: Message):
        ok, reason = validate(msg)
        if not ok:
            self.rejected += 1
            if len(self.reasons) < 100:
                self.reasons.append(f"{msg.kind}: {reason}")
            return []
        return self.node.handle(msg)

"""Durable Raft persistent state (term, vote, log, snapshot).

Parity with tensor_chain/src/raft_wal.rs capability: every change to
Raft's persistent state (currentTerm, votedFor, log entries) is written
to an append-only CRC-framed file and fsynced *before* the node sends a
message that promises that state (a granted vote, a successful append
ack).  A SIGKILL at any point loses nothing promised: on restart the
node reloads hard state + log + snapshot and rejoins without
double-voting or dropping committed entries.

Record framing: ``[u32 crc32][u32 len][u8 type][json payload]``.
Replay stops at the first torn/corrupt record and truncates the file
there (same torn-tail policy as store/wal.py).

Types: HARD (term, voted_for), APPEND (first global index + entries;
implicitly truncates any conflicting suffix), TRUNCATE (drop suffix),
SNAPSHOT (compaction point + base config + state-machine data).
Compaction rewrites the whole file (SNAPSHOT + HARD + remaining log)
via atomic tmp+rename, so a SNAPSHOT record is normally the file head.

The port's copy of ``neumann_tpu/chain/raft_wal.py``:
only its import lines differ.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional

_FRAME = struct.Struct("<II")
HARD, APPEND, TRUNCATE, SNAPSHOT = 1, 2, 3, 4


@dataclass
class RecoveredRaftState:
    term: int = 0
    voted_for: Optional[str] = None
    log: List[dict] = field(default_factory=list)  # {"term","payload"}
    snapshot_index: int = 0
    snapshot_term: int = 0
    snapshot_data: Optional[dict] = None
    config: Optional[dict] = None  # {"voters","learners","joint_old"}


def _encode(rtype: int, obj: dict) -> bytes:
    payload = bytes([rtype]) + json.dumps(
        obj, separators=(",", ":")).encode("utf-8")
    return _FRAME.pack(zlib.crc32(payload), len(payload)) + payload


class RaftWal:
    """Append-only durable log for one RaftNode's persistent state."""

    def __init__(self, path):
        self.path = os.fspath(path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fh = open(self.path, "ab")
        self._dirty = False

    # -- write side (called by RaftNode at mutation points) ---------------
    def save_hard_state(self, term: int,
                        voted_for: Optional[str]) -> None:
        self._write(_encode(HARD, {"t": term, "v": voted_for}))

    def append(self, first_index: int, entries) -> None:
        if not entries:
            return
        self._write(_encode(APPEND, {
            "i": first_index,
            "e": [{"t": e.term, "p": e.payload} for e in entries]}))

    def truncate_suffix(self, from_index: int) -> None:
        self._write(_encode(TRUNCATE, {"i": from_index}))

    def save_snapshot(self, snapshot_index: int, snapshot_term: int,
                      config: dict, data: Optional[dict],
                      remaining_log, term: int,
                      voted_for: Optional[str]) -> None:
        """Compaction: atomically rewrite the file as
        SNAPSHOT + HARD + one APPEND with the surviving log suffix."""
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(_encode(SNAPSHOT, {
                "i": snapshot_index, "t": snapshot_term,
                "c": config, "d": data}))
            fh.write(_encode(HARD, {"t": term, "v": voted_for}))
            if remaining_log:
                fh.write(_encode(APPEND, {
                    "i": snapshot_index + 1,
                    "e": [{"t": e.term, "p": e.payload}
                          for e in remaining_log]}))
            fh.flush()
            os.fsync(fh.fileno())
        self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "ab")
        self._dirty = False

    def _write(self, frame: bytes) -> None:
        self._fh.write(frame)
        self._dirty = True

    def sync(self) -> None:
        """Durability barrier: flush + fsync if anything was written.
        RaftNode calls this before its outbound messages are sent."""
        if not self._dirty:
            return
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._dirty = False

    def close(self) -> None:
        self.sync()
        self._fh.close()

    # -- recovery ----------------------------------------------------------
    def load(self) -> Optional[RecoveredRaftState]:
        """Replay the file; returns None if it holds no records.
        Stops at the first torn/corrupt record and truncates there."""
        try:
            with open(self.path, "rb") as fh:
                buf = fh.read()
        except FileNotFoundError:
            return None
        st = RecoveredRaftState()
        pos, good, seen = 0, 0, False
        while pos + _FRAME.size <= len(buf):
            crc, ln = _FRAME.unpack_from(buf, pos)
            end = pos + _FRAME.size + ln
            if end > len(buf):
                break  # torn tail
            payload = buf[pos + _FRAME.size: end]
            if zlib.crc32(payload) != crc:
                break  # corrupt record
            try:
                obj = json.loads(payload[1:].decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError):
                break
            self._apply(st, payload[0], obj)
            pos = end
            good = pos
            seen = True
        if good < len(buf):  # drop the torn tail so appends are clean
            self._fh.close()
            with open(self.path, "r+b") as fh:
                fh.truncate(good)
            self._fh = open(self.path, "ab")
        return st if seen else None

    @staticmethod
    def _apply(st: RecoveredRaftState, rtype: int, obj: dict) -> None:
        if rtype == HARD:
            st.term, st.voted_for = obj["t"], obj["v"]
        elif rtype == APPEND:
            p = obj["i"] - st.snapshot_index - 1
            if p < 0:
                return  # predates the snapshot
            del st.log[p:]
            st.log.extend({"term": e["t"], "payload": e["p"]}
                          for e in obj["e"])
        elif rtype == TRUNCATE:
            p = obj["i"] - st.snapshot_index - 1
            if p >= 0:
                del st.log[p:]
        elif rtype == SNAPSHOT:
            keep = obj["i"] - st.snapshot_index
            del st.log[:max(0, keep)]
            st.snapshot_index = obj["i"]
            st.snapshot_term = obj["t"]
            st.config = obj.get("c")
            st.snapshot_data = obj.get("d")

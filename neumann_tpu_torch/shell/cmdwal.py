"""Command-history WAL: statement-level crash recovery for the shell.

Parity with the reference shell's WAL (neumann_shell/src/wal.rs +
lib.rs:186-220,365-372,478-503): after ``LOAD '<snap>'`` the shell
replays ``<snap>.log`` (every write statement issued since the last
SAVE) and then appends each successful write statement to it;
``SAVE`` truncates it. This complements the byte-level TensorStore WAL
(--wal-dir): snapshot+command-replay durability works even when the
store WAL is off, and the log doubles as a human-readable session
history.

Recovery modes (wal.rs WalRecoveryMode): ``strict`` stops at the first
statement that fails to replay (consistency first); ``recover`` skips
failures and reports them.

The port's copy of ``neumann_tpu/shell/cmdwal.py``, unchanged.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = ["CommandWal", "ReplayResult", "is_write_command"]


@dataclass
class ReplayResult:
    replayed: int = 0
    skipped: List[str] = field(default_factory=list)   # "stmt: error"

    def summary(self) -> str:
        msg = f"replayed {self.replayed} command(s) from WAL"
        if self.skipped:
            msg += f"; skipped {len(self.skipped)} failed"
        return msg


class CommandWal:
    """Append-only statement log, one UTF-8 line per write statement,
    fsync'd per append (wal.rs append)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", encoding="utf-8")

    def append(self, stmt: str) -> None:
        # newlines inside multi-line statements collapse to spaces so
        # one WAL line is always one statement
        self._f.write(stmt.replace("\n", " ").strip() + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def truncate(self) -> None:
        self._f.close()
        self._f = open(self.path, "w", encoding="utf-8")

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass

    @staticmethod
    def read_commands(path: str) -> List[str]:
        with open(path, encoding="utf-8") as f:
            return [ln.strip() for ln in f if ln.strip()]

    @staticmethod
    def replay(path: str, execute, mode: str = "strict"
               ) -> ReplayResult:
        """Replay each command through ``execute`` (a callable raising
        on failure). strict: re-raise on the first failure; recover:
        collect and continue."""
        out = ReplayResult()
        for stmt in CommandWal.read_commands(path):
            try:
                execute(stmt)
                out.replayed += 1
            except Exception as e:
                if mode == "strict":
                    raise RuntimeError(
                        f"WAL replay failed at {stmt!r}: {e}\n"
                        f"(replayed {out.replayed}; rerun with "
                        f"--wal-recovery recover to skip)") from e
                out.skipped.append(f"{stmt}: {e}")
        return out


_WRITE_FIRST = frozenset((
    "INSERT", "UPDATE", "DELETE", "CREATE", "DROP", "ALTER",
    "CHECKPOINT", "ROLLBACK", "BEGIN", "COMMIT", "ENTITY", "CONNECT",
    "MERGE", "UNWIND",
))


def _split_top_level(src: str):
    """Split a script on top-level ';' (quote-aware: ';' inside single
    or double quoted literals does not split)."""
    out, buf, quote = [], [], ""
    for ch in src:
        if quote:
            buf.append(ch)
            if ch == quote:
                quote = ""
        elif ch in ("'", '"'):
            quote = ch
            buf.append(ch)
        elif ch == ";":
            out.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    out.append("".join(buf))
    return [s for s in (p.strip() for p in out) if s]


def is_write_command(stmt: str) -> bool:
    """Statement-level write classification (lib.rs:186-220). Only
    write statements enter the command WAL — reads replay to nothing.

    Multi-statement scripts count as a write when ANY sub-statement
    writes (the WAL replays the whole script; re-running its reads is
    harmless, while dropping its writes loses data — a script led by a
    SELECT used to be classified by its first keyword only). MATCH-led
    Cypher counts as a write when a write clause appears (SET/CREATE/
    DELETE/MERGE/REMOVE) — over-inclusion is safe for the same reason.
    """
    parts = _split_top_level(stmt)
    if len(parts) > 1:
        return any(is_write_command(p) for p in parts)
    upper = " ".join(stmt.upper().split())
    first = upper.split(" ", 1)[0] if upper else ""
    if first in _WRITE_FIRST:
        return True
    if first in ("MATCH", "OPTIONAL"):
        # word-boundary match, not space-padded substrings: valid
        # no-space forms like "MATCH (a) CREATE(b)" or "SET(" must
        # still classify as writes or they vanish from the WAL
        return re.search(
            r"\b(SET|CREATE|DELETE|DETACH|MERGE|REMOVE)\b",
            upper) is not None
    if first == "NODE" or first == "EDGE":
        return not upper.startswith((f"{first} GET", f"{first} COUNT"))
    if first == "EMBED":
        return not upper.startswith(("EMBED GET", "EMBED SEARCH"))
    if first == "VAULT":
        return upper.startswith((
            "VAULT SET", "VAULT DELETE", "VAULT ROTATE", "VAULT GRANT",
            "VAULT REVOKE", "VAULT SEAL", "VAULT UNSEAL"))
    if first == "CACHE":
        return upper.startswith(("CACHE PUT", "CACHE CLEAR",
                                 "CACHE EVICT"))
    if first == "BLOB":
        return upper.startswith((
            "BLOB PUT", "BLOB DELETE", "BLOB LINK", "BLOB UNLINK",
            "BLOB TAG", "BLOB UNTAG", "BLOB GC", "BLOB REPAIR"))
    return False

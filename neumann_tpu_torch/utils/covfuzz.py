"""Coverage-guided mutation fuzzer (libFuzzer's loop, in-process).

The reference runs 139 libFuzzer targets nightly (fuzz/fuzz_targets/,
.github/workflows/fuzz.yml). This image has no libFuzzer/atheris, so this
module implements the same feedback loop on CPython 3.12's
``sys.monitoring``: LINE events fire once per (code, line) — the callback
records the hit and returns ``DISABLE`` — so "any event fired during this
run" IS the new-coverage signal, with near-zero steady-state overhead.

Loop: pick a corpus entry, mutate (bit/byte flips, splices, interesting
values, crossover), run the target; inputs that light up new lines join
the corpus; exceptions outside the target's allowed set are findings,
with the crashing input preserved for replay.

The port's copy of ``neumann_tpu/utils/covfuzz.py``: besides its
imports, coverage counts the lines of the port's package
(``path_filter="neumann_tpu_torch"``) by default, and the targets
import the port's modules.
"""

from __future__ import annotations

import random
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional, Tuple

_TOOL_NAME = "neumann-covfuzz"

_INTERESTING = [b"\x00", b"\xff", b"\x7f", b"\x80", b"\x00\x00\x00\x00",
                b"\xff\xff\xff\xff", b"\x00\x00\x00\x80", b"'", b'"',
                b"(", b")", b"[", b"]", b"{", b"}", b";", b"--", b"%",
                b"\\", b"\n", b" TOP ", b" WHERE ", b"SELECT", b"\xc3\x28"]


@dataclass
class Finding:
    input: bytes
    error: BaseException

    def __repr__(self):
        return (f"Finding({type(self.error).__name__}: {self.error!s:.80}"
                f", input={self.input[:40]!r}...)")


@dataclass
class FuzzStats:
    executions: int = 0
    corpus_size: int = 0
    new_coverage_inputs: int = 0
    lines_covered: int = 0
    findings: List[Finding] = field(default_factory=list)


class _Coverage:
    """First-hit line coverage over neumann_tpu_torch code via sys.monitoring."""

    def __init__(self, path_filter: str = "neumann_tpu_torch"):
        self._filter = path_filter
        self._hits_this_run = 0
        self._total = 0
        self._tool = None

    def __enter__(self):
        mon = sys.monitoring
        for tid in range(1, 6):
            if mon.get_tool(tid) is None:
                self._tool = tid
                break
        if self._tool is None:  # pragma: no cover - all tool ids busy
            raise RuntimeError("no free sys.monitoring tool id")
        mon.use_tool_id(self._tool, _TOOL_NAME)
        mon.register_callback(self._tool, mon.events.LINE, self._on_line)
        mon.set_events(self._tool, mon.events.LINE)
        return self

    def __exit__(self, *exc):
        mon = sys.monitoring
        mon.set_events(self._tool, 0)
        mon.register_callback(self._tool, mon.events.LINE, None)
        mon.free_tool_id(self._tool)
        return False

    def _on_line(self, code, line):
        if self._filter in code.co_filename:
            self._hits_this_run += 1
            self._total += 1
        return sys.monitoring.DISABLE

    def begin_run(self):
        self._hits_this_run = 0

    @property
    def new_hits(self) -> int:
        return self._hits_this_run

    @property
    def total(self) -> int:
        return self._total


def _mutate(rng: random.Random, data: bytes, corpus: List[bytes]) -> bytes:
    buf = bytearray(data)
    for _ in range(rng.randint(1, 4)):
        op = rng.randrange(7)
        if op == 0 and buf:                      # bit flip
            i = rng.randrange(len(buf))
            buf[i] ^= 1 << rng.randrange(8)
        elif op == 1 and buf:                    # byte set
            buf[rng.randrange(len(buf))] = rng.randrange(256)
        elif op == 2:                            # insert interesting
            tok = rng.choice(_INTERESTING)
            i = rng.randint(0, len(buf))
            buf[i:i] = tok
        elif op == 3 and len(buf) > 1:           # delete span
            i = rng.randrange(len(buf))
            j = min(len(buf), i + rng.randint(1, 8))
            del buf[i:j]
        elif op == 4 and buf:                    # duplicate span
            i = rng.randrange(len(buf))
            j = min(len(buf), i + rng.randint(1, 8))
            buf[i:i] = buf[i:j]
        elif op == 5 and corpus:                 # crossover / splice
            other = rng.choice(corpus)
            if other:
                i = rng.randint(0, len(buf))
                k = rng.randrange(len(other))
                m = min(len(other), k + rng.randint(1, 16))
                buf[i:i] = other[k:m]
        elif op == 6 and buf:                    # truncate
            del buf[rng.randrange(len(buf)):]
    return bytes(buf[:4096])


def fuzz(
    target: Callable[[bytes], None],
    seeds: Iterable[bytes],
    allowed: Tuple[type, ...],
    max_execs: int = 5000,
    max_seconds: float = 10.0,
    seed: int = 0,
    path_filter: str = "neumann_tpu_torch",
    max_findings: int = 5,
) -> FuzzStats:
    """Run the coverage-guided loop. ``allowed`` exceptions are the
    target's legitimate rejections; anything else becomes a Finding."""
    rng = random.Random(seed)
    corpus: List[bytes] = [bytes(s) for s in seeds] or [b""]
    stats = FuzzStats()
    deadline = time.monotonic() + max_seconds
    with _Coverage(path_filter) as cov:
        # seed pass: charge the coverage map with the seeds themselves
        for entry in list(corpus):
            cov.begin_run()
            _run_one(target, entry, allowed, stats, max_findings)
        while (stats.executions < max_execs
               and time.monotonic() < deadline
               and len(stats.findings) < max_findings):
            parent = rng.choice(corpus)
            child = _mutate(rng, parent, corpus)
            cov.begin_run()
            _run_one(target, child, allowed, stats, max_findings)
            if cov.new_hits:
                corpus.append(child)
                stats.new_coverage_inputs += 1
        stats.lines_covered = cov.total
    stats.corpus_size = len(corpus)
    return stats


def _run_one(target, data, allowed, stats, max_findings):
    stats.executions += 1
    try:
        target(data)
    except allowed:
        pass
    except Exception as e:  # noqa: BLE001 — that's the point
        if len(stats.findings) < max_findings:
            stats.findings.append(Finding(bytes(data), e))


# ---------------------------------------------------------------------------
# built-in targets, mirroring the reference's fuzz_targets/ inventory
# ---------------------------------------------------------------------------

def target_parser(data: bytes) -> None:
    """neumann_parser fuzz target (fuzz_targets/parser_*.rs)."""
    from neumann_tpu_torch.lang.parser import parse
    from neumann_tpu_torch.utils.errors import NeumannError  # noqa: F401

    parse(data.decode("utf-8", "replace"))


def target_wal_record(data: bytes) -> None:
    """WAL payload decoder fuzz (fuzz_targets/wal_*.rs): a CRC-valid but
    malformed record must raise StoreError, never crash."""
    from neumann_tpu_torch.store.wal import decode_record

    decode_record(data)


def target_varint(data: bytes) -> None:
    """tt/id codec round-trip fuzz (fuzz_targets/tt_roundtrip.rs)."""
    from neumann_tpu_torch.compress.codecs import varint_decode

    varint_decode(data)


def target_rle(data: bytes) -> None:
    from neumann_tpu_torch.compress.codecs import rle_decode

    rle_decode(data)


def target_grpc_web_frames(data: bytes) -> None:
    """grpc-web framing decoder (analogous to tcp_framing.rs)."""
    from neumann_tpu_torch.server.grpc_web import decode_frames

    decode_frames(data)


def target_cypher(data: bytes) -> None:
    from neumann_tpu_torch.lang.cypher import parse_cypher

    parse_cypher(data.decode("utf-8", "replace"))


def target_sparse(data: bytes) -> None:
    """SparseVector construction from hostile dims/values."""
    import numpy as np

    from neumann_tpu_torch.store.sparse import SparseVector

    if len(data) < 4:
        return
    arr = np.frombuffer(data[: (len(data) // 4) * 4], dtype=np.float32)
    sv = SparseVector.from_dense(arr.tolist())
    sv.dot(sv)
    sv.cosine_similarity(sv)


def target_parse_param(data: bytes) -> None:
    """Parameterized-template parser: must agree with parse() (or both
    reject) on arbitrary input (round-2 lang/parser.parse_param)."""
    from neumann_tpu_torch.lang.parser import parse, parse_param

    src = data.decode("utf-8", "replace")
    try:
        want = repr(parse(src))
    except Exception:
        try:
            parse_param(src)
        except Exception:
            return
        raise AssertionError("parse_param accepted what parse rejects")
    got = repr(parse_param(src))
    if got != want:
        raise AssertionError("parse_param diverged")


def target_raft_wal(data: bytes, _tmp=[]) -> None:
    """Raft WAL replay over hostile bytes: load() must never raise
    (torn/corrupt tails truncate cleanly)."""
    import os
    import tempfile

    from neumann_tpu_torch.chain.raft_wal import RaftWal

    if not _tmp:
        _tmp.append(tempfile.mkdtemp(prefix="covfuzz-rwal-"))
    p = os.path.join(_tmp[0], "w")
    with open(p, "wb") as fh:
        fh.write(data)
    RaftWal(p).load()


def target_snapshot(data: bytes) -> None:
    """Snapshot loads over hostile bytes -> StoreError only."""
    from neumann_tpu_torch.store import snapshot

    snapshot.loads(data)


def target_obfuscation(data: bytes) -> None:
    """Padding/metadata decoders over hostile bytes -> VaultError."""
    from neumann_tpu_torch.vault.obfuscation import ObfuscationLayer

    ObfuscationLayer.unpad(data)


def target_wal_overlay(data: bytes) -> None:
    """C++ overlay replay over hostile bytes: parse must stop cleanly
    or raise ValueError; surviving records must decode or StoreError."""
    from neumann_tpu_torch.store import codec
    from neumann_tpu_torch.utils.errors import StoreError

    ext = codec._native()
    if ext is None:
        return
    try:
        cap, n = ext.wal_overlay(bytes(data))
    except ValueError:
        return
    puts, dels = ext.overlay_keys(cap)
    for k in puts[:8]:
        code, td = ext.overlay_pop(cap, k)
        if code == 1:
            try:
                list(td.fields.items())
            except StoreError:
                pass

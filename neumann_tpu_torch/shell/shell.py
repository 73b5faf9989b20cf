"""REPL shell: readline editing, ASCII tables, built-ins, durability.

Capability parity with neumann_shell (neumann_shell/src/lib.rs:94-964):
built-ins (help/exit/clear/tables), SAVE/LOAD snapshots, WAL status, VAULT
INIT / CACHE INIT / BLOB INIT, `doctor` diagnostics, and all query
statements through the router. Replay-on-start comes from TensorStore WAL
recovery when started with --wal-dir.

The port's copy of ``neumann_tpu/shell/shell.py``. It builds the port's
``QueryRouter()``, which runs on the card ("cuda") unless a caller
passes a router of its own. Three changes besides the import lines:
``doctor`` reports torch's devices; ``--wal-dir`` attaches no checkpoint
manager (none is ported yet, ROADMAP item 6; CHECKPOINT statements
answer with an error naming it); and ``vault init``, which the port's
router refuses (item 6), prints that error instead of raising.
"""

from __future__ import annotations

import os
import re
import sys
from typing import List, Optional

from neumann_tpu_torch.router import QueryResult, QueryRouter
from neumann_tpu_torch.utils.errors import NeumannError

BANNER = r"""
  _  _ ___ _   _ __  __   _   _  _ _  _       _____ ___ _   _
 | \| | __| | | |  \/  | /_\ | \| | \| |  ___|_   _| _ \ | | |
 | .` | _|| |_| | |\/| |/ _ \| .` | .` | |___| | | |  _/ |_| |
 |_|\_|___|\___/|_|  |_/_/ \_\_|\_|_|\_|       |_| |_|  \___/

 TPU-native unified data engine — type `help` for commands
"""

HELP = """\
Built-ins:
  help                 show this help
  exit | quit          leave the shell
  clear                clear the screen
  tables               alias for SHOW TABLES
  save '<path>'        snapshot the store (truncates the command WAL)
  load '<path>'        load a snapshot, replay + activate '<path>.log'
                       (command WAL: every write statement since the
                       last save, replayed on load)
  wal status           show store-WAL and command-WAL state
  vault init '<pw>'    initialize the secrets vault
  vault identity '<e>' act as entity <e> for VAULT statements
  wal truncate         checkpoint the store and truncate the WAL
  cache init           initialize the LLM cache
  blob init            initialize blob storage
  doctor               run diagnostics

Statements: SELECT/INSERT/UPDATE/DELETE/CREATE TABLE/..., NODE/EDGE/
NEIGHBORS/PATH/PAGERANK, EMBED/SIMILAR, ENTITY/FIND, VAULT/CACHE/BLOB,
CHECKPOINT/ROLLBACK. See docs for the full language."""


def _fmt_value(v) -> str:
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, bytes):
        return f"<{len(v)} bytes>"
    s = str(v)
    return s if len(s) <= 60 else s[:57] + "..."


def format_table(rows: List[dict]) -> str:
    if not rows:
        return "(no rows)"
    cols: List[str] = []
    for row in rows:
        for k in row:
            if k not in cols:
                cols.append(k)
    widths = {c: len(c) for c in cols}
    rendered = []
    for row in rows:
        r = {c: _fmt_value(row.get(c)) for c in cols}
        rendered.append(r)
        for c in cols:
            widths[c] = max(widths[c], len(r[c]))
    sep = "+" + "+".join("-" * (widths[c] + 2) for c in cols) + "+"
    out = [sep,
           "|" + "|".join(f" {c.ljust(widths[c])} " for c in cols) + "|",
           sep]
    for r in rendered:
        out.append("|" + "|".join(
            f" {r[c].ljust(widths[c])} " for c in cols) + "|")
    out.append(sep)
    return "\n".join(out)


def format_result(res: QueryResult, theme=None) -> str:
    """Plain-theme rendering by default; pass a Theme (shell/output.py)
    for the styled per-result-type formatters."""
    if theme is not None and (theme.unicode or theme.color):
        from neumann_tpu_torch.shell.output import format_result as themed

        return themed(res, theme)
    if res.kind == "rows":
        body = format_table(res.rows)
        return f"{body}\n({len(res.rows)} row(s))"
    if res.kind == "similar":
        body = format_table(res.results)
        return f"{body}\n({len(res.results)} hit(s))"
    if res.kind == "count":
        return res.message or str(res.count)
    if res.kind == "value":
        if res.message:
            return res.message
        return _fmt_value(res.value)
    return res.message


_ANSI = {"kw": "\033[1;36m", "str": "\033[33m", "num": "\033[35m",
         "reset": "\033[0m"}


_HL_KEYWORDS = frozenset("""
    SELECT INSERT UPDATE DELETE CREATE DROP ALTER TABLE INTO VALUES FROM
    WHERE AND OR NOT NULL SET JOIN INNER LEFT RIGHT ON GROUP BY ORDER
    ASC DESC LIMIT OFFSET HAVING AS DISTINCT COUNT SUM AVG MIN MAX
    BEGIN COMMIT ROLLBACK SHOW TABLES DESCRIBE EXPLAIN INDEX UNIQUE
    PRIMARY KEY FOREIGN REFERENCES CASCADE DEFAULT CHECK CONSTRAINT
    STORE EMBEDDING SIMILAR TO METRIC FIND RELATED CONNECTED NODE EDGE
    GRAPH PATTERN BATCH COLLECTION QUANTIZED VAULT CACHE BLOB CHECKPOINT
    MATCH MERGE RETURN OPTIONAL WITH UNWIND WHEN THEN CASE ELSE END
    IN LIKE BETWEEN IS TRUE FALSE CHAIN CLUSTER STATUS SAVE LOAD
    COMPRESSED INT FLOAT TEXT BOOL VECTOR TOP USING
""".split())

_HL_STRING = re.compile(r"'(?:[^']|'')*'")
# one combined token pattern: a single pass never rescans the ANSI codes
# that substitution inserts (their digits would otherwise recolor)
_HL_TOKEN = re.compile(
    r"[A-Za-z_][A-Za-z0-9_]*|\d+(?:\.\d+)?(?:[eE][+-]?\d+)?")


def highlight(query: str) -> str:
    """ANSI syntax highlighting (keywords cyan, strings yellow, numbers
    magenta). Reference parity: the shell's colored statement echo.
    Regex-based so malformed input still displays unchanged."""
    def repl(m: "re.Match[str]") -> str:
        t = m.group(0)
        if t[0].isdigit():
            return f"{_ANSI['num']}{t}{_ANSI['reset']}"
        if t.upper() in _HL_KEYWORDS:
            return f"{_ANSI['kw']}{t}{_ANSI['reset']}"
        return t

    def color_code(seg: str) -> str:
        return _HL_TOKEN.sub(repl, seg)

    out = []
    pos = 0
    for m in _HL_STRING.finditer(query):
        out.append(color_code(query[pos:m.start()]))
        out.append(f"{_ANSI['str']}{m.group(0)}{_ANSI['reset']}")
        pos = m.end()
    out.append(color_code(query[pos:]))
    return "".join(out)


def _split_script(src: str) -> List[str]:
    """Split a .nql script into statements: `--` comment lines drop,
    statements end at a line ending in `;` (or at EOF)."""
    stmts: List[str] = []
    buf: List[str] = []
    for line in src.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("--"):
            continue
        buf.append(line)
        if stripped.endswith(";"):
            stmts.append("\n".join(buf).strip().rstrip(";").strip())
            buf = []
    if buf:
        stmts.append("\n".join(buf).strip())
    return [s for s in stmts if s]


class Shell:
    def __init__(self, wal_dir: Optional[str] = None,
                 router: Optional[QueryRouter] = None,
                 stdin=None, stdout=None, theme: Optional[str] = None,
                 wal_recovery: str = "strict"):
        from neumann_tpu_torch.shell.output import THEMES, detect_theme

        self.router = router or QueryRouter()
        self.wal_dir = wal_dir
        self.stdin = stdin or sys.stdin
        self.stdout = stdout or sys.stdout
        self.theme = THEMES[theme] if theme else detect_theme(
            self.stdout)
        self.wal_recovery = wal_recovery
        self.cmd_wal = None            # activated by LOAD (cmdwal.py)
        if wal_dir:
            os.makedirs(wal_dir, exist_ok=True)
            snap = os.path.join(wal_dir, "snapshot.ntpu")
            wal = os.path.join(wal_dir, "wal.log")
            n = self.router.store.recover(
                wal, snapshot_path=snap if os.path.exists(snap) else None)
            self.router.store.open_durable(wal)
            if n:
                self._print(f"(replayed {n} WAL record(s))")

    def _print(self, text: str) -> None:
        print(text, file=self.stdout)

    # ------------------------------------------------------------------
    def execute(self, line: str) -> Optional[str]:
        """Execute one input line; returns output text (None for exit)."""
        q = line.strip()
        if not q:
            return ""
        lower = q.lower().rstrip(";").strip()
        if lower in ("exit", "quit", "\\q"):
            return None
        if lower.startswith("\\i ") or lower.startswith("\\i\t"):
            # \i <path>: run a statement script (reference shell builtin)
            path = q[2:].strip().strip("'\"")
            try:
                with open(path, encoding="utf-8") as f:
                    src = f.read()
            except OSError as e:
                return f"error: cannot read {path}: {e}"
            outputs = []
            for stmt in _split_script(src):
                res = self.execute(stmt)
                if res:
                    outputs.append(res)
            return "\n".join(outputs) if outputs else \
                f"ran {path} (no output)"
        if lower == "help":
            return HELP
        if lower == "clear":
            return "\033[2J\033[H"
        if lower == "tables":
            q = "SHOW TABLES"
        elif lower == "save" or lower.startswith("save "):
            rest = q[4:].strip()
            # both orders accepted: SAVE COMPRESSED '<path>' (reference
            # builtin form) and SAVE '<path>' COMPRESSED
            compressed = False
            if rest.lower().startswith("compressed"):
                compressed = True
                rest = rest[len("compressed"):].strip()
            elif rest.lower().endswith(" compressed"):
                compressed = True
                rest = rest[: -len(" compressed")].strip()
            path = rest.strip("'\"")
            if not path:
                if not self.wal_dir:
                    return "usage: save [compressed] '<path>'"
                path = os.path.join(self.wal_dir, "snapshot.ntpu")
            self.router.store.save_snapshot(path, compressed=compressed)
            # the snapshot now covers everything in the command WAL
            # (reference truncates on SAVE, lib.rs:407-410)
            if self.cmd_wal is not None:
                self.cmd_wal.truncate()
            return f"saved to {path}" + (" (compressed)" if compressed
                                         else "")
        elif lower == "load" or lower.startswith("load "):
            path = q[4:].strip().strip("'\"")
            if not path:
                path = (os.path.join(self.wal_dir, "snapshot.ntpu")
                        if self.wal_dir else "")
                if not path or not os.path.exists(path):
                    return "usage: load '<path>'"
            self.router.store.load_snapshot(path)
            out = f"loaded {len(self.router.store)} entries from {path}"
            # activate the command WAL at <path>.log: replay writes
            # issued since the snapshot, then append new ones
            # (reference lib.rs:478-503)
            from neumann_tpu_torch.shell.cmdwal import CommandWal

            wal_path = path + ".log"
            if os.path.exists(wal_path):
                try:
                    rr = CommandWal.replay(
                        wal_path,
                        lambda stmt: (self.router.execute_many(stmt)
                                      if ";" in stmt.rstrip(";")
                                      else self.router.execute(stmt)),
                        mode=("recover"
                              if self.wal_recovery == "recover"
                              else "strict"))
                except RuntimeError as e:
                    return f"{out}\nerror: {e}"
                out += f"\n{rr.summary()}"
                for line in rr.skipped[:5]:
                    out += f"\n  skipped: {line}"
            if self.cmd_wal is not None:
                self.cmd_wal.close()
            self.cmd_wal = CommandWal(wal_path)
            return out
        elif lower == "wal status":
            wal = self.router.store._wal
            lines = []
            if wal is None:
                lines.append("store WAL: disabled (start with --wal-dir)")
            else:
                lines.append(f"store WAL: {wal.path} "
                             f"({wal.size_bytes()} bytes, "
                             f"sync={wal.sync_mode})")
            if self.cmd_wal is not None:
                lines.append(f"command WAL: {self.cmd_wal.path} "
                             f"({self.cmd_wal.size_bytes()} bytes)")
            else:
                lines.append("command WAL: inactive (activated by LOAD)")
            return "\n".join(lines)
        elif lower == "wal truncate":
            wal = self.router.store._wal
            if wal is None:
                return "WAL: disabled (start with --wal-dir)"
            if not self.wal_dir:
                return "WAL: no --wal-dir; cannot checkpoint"
            # checkpoint-then-truncate: state is snapshotted first so
            # no durability window opens
            snap = os.path.join(self.wal_dir, "snapshot.ntpu")
            self.router.store.save_snapshot(snap)
            before = wal.size_bytes()
            wal.truncate()
            return (f"checkpointed to {snap}; WAL truncated "
                    f"({before} -> {wal.size_bytes()} bytes)")
        elif lower.startswith("vault identity"):
            ident = q[len("vault identity"):].strip().strip("'\"")
            if not ident:
                cur = getattr(self.router, "vault_actor", None) or "root"
                return f"vault identity: {cur}"
            self.router.vault_actor = ident
            return f"vault identity set to '{ident}'"
        elif lower.startswith("vault init"):
            pw = q[len("vault init"):].strip().strip("'\"")
            if not pw:
                return "usage: vault init '<master password>'"
            try:
                self.router.init_vault(pw)
            except NeumannError as e:
                return f"error: {e}"
            return "vault initialized"
        elif lower == "doctor":
            return self.doctor()
        try:
            if ";" in q.rstrip().rstrip(";") and \
                    not q.lstrip().upper().startswith(
                        ("MATCH", "MERGE", "CREATE (", "OPTIONAL")):
                results = self.router.execute_many(q)
                self._wal_log(q)
                return "\n".join(format_result(r, self.theme)
                                 for r in results
                                 if r.kind != "message" or r.message)
            res = self.router.execute(q)
        except NeumannError as e:
            return f"error: {e}"
        except Exception as e:  # surface engine bugs honestly
            return f"internal error: {type(e).__name__}: {e}"
        self._wal_log(q)
        return format_result(res, self.theme)

    def _wal_log(self, stmt: str) -> None:
        """Append a SUCCESSFUL write statement to the command WAL
        (reference logs post-execution, lib.rs:365-372)."""
        if self.cmd_wal is None:
            return
        from neumann_tpu_torch.shell.cmdwal import is_write_command

        if is_write_command(stmt):
            self.cmd_wal.append(stmt)

    def doctor(self) -> str:
        """Diagnostics like the reference shell's doctor command."""
        checks = []
        store = self.router.store
        checks.append(("storage", f"{len(store)} entries", "ok"))
        wal = store._wal
        checks.append(("wal", "enabled" if wal else "disabled",
                       "ok" if wal else "warn"))
        try:
            import torch

            kind = self.router.vector.device.type
            n = torch.cuda.device_count() if kind == "cuda" else 1
            checks.append(("devices", f"{n} x {kind}", "ok"))
        except Exception as e:
            checks.append(("devices", str(e), "fail"))
        ncorp = sum(len(v) for v in self.router.vector._corpora.values())
        checks.append(("vector corpora", str(ncorp), "ok"))
        checks.append(("graph",
                       f"{self.router.graph.node_count()} nodes / "
                       f"{self.router.graph.edge_count()} edges", "ok"))
        checks.append(("vault", "initialized"
                       if getattr(self.router, "vault", None)
                       else "not initialized", "ok"))
        width = max(len(c[0]) for c in checks)
        return "\n".join(
            f"  [{'OK ' if st == 'ok' else ('WRN' if st == 'warn' else 'ERR')}] "
            f"{name.ljust(width)}  {detail}"
            for name, detail, st in checks)

    # ------------------------------------------------------------------
    def complete(self, text: str, state: int) -> Optional[str]:
        """readline tab-completion: keywords, builtins, table and
        collection names (reference shell completion parity)."""
        if state == 0:
            up = text.upper()
            cands = sorted(
                {kw for kw in _HL_KEYWORDS if kw.startswith(up)}
                | {b for b in ("help", "exit", "quit", "clear", "tables",
                               "save", "load", "doctor", "wal", "vault",
                               "cache", "blob")
                   if b.startswith(text.lower())}
                | {t for t in self.router.relational.list_tables()
                   if t.startswith(text)}
                | {c for c in self.router.vector.list_collections()
                   if c.startswith(text)})
            self._completions = cands
        try:
            return self._completions[state]
        except IndexError:
            return None

    def run(self) -> None:
        try:
            import readline

            readline.set_completer(self.complete)
            readline.set_completer_delims(" \t\n(),=")
            readline.parse_and_bind("tab: complete")
        except ImportError:
            pass
        self._print(BANNER)
        while True:
            try:
                line = input("neumann> ")
            except EOFError:
                self._print("bye")
                break
            except KeyboardInterrupt:
                self._print("")
                continue
            if line.strip() and getattr(self.stdout, "isatty",
                                        lambda: False)():
                # colored statement echo (reference shell highlighting)
                self._print(f"\033[F\033[Kneumann> {highlight(line)}")
            out = self.execute(line)
            if out is None:
                self._print("bye")
                break
            if out:
                self._print(out)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="neumann-tpu",
                                 description="TPU-native unified data engine")
    ap.add_argument("--wal-dir", default=None,
                    help="directory for WAL + snapshots (durable mode)")
    ap.add_argument("-c", "--command", default=None,
                    help="execute one statement and exit")
    ap.add_argument("--theme", default=None,
                    choices=("plain", "dark", "light", "minimal"),
                    help="output theme (default: dark on a TTY)")
    ap.add_argument("--wal-recovery", default="strict",
                    choices=("strict", "recover"),
                    help="command-WAL replay mode on LOAD: stop at the "
                         "first failed statement (strict) or skip and "
                         "report (recover)")
    args = ap.parse_args(argv)
    shell = Shell(wal_dir=args.wal_dir, theme=args.theme,
                  wal_recovery=args.wal_recovery)
    if args.command:
        out = shell.execute(args.command)
        if out:
            print(out)
        shell.router.store.wal_flush()
        return 0
    shell.run()
    shell.router.store.wal_flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

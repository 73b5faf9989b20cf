"""The port's shell against the JAX package's: the same input lines
through a JAX ``Shell`` and a port ``Shell`` (CPU router, plain theme
unless a script names another), with equal output text.

The scripts are samples/knowledge-base.nql statement by statement and
those of tests/test_shell.py and tests/test_shell_wal_themes.py:
built-ins, statements, errors, multi-statement lines, SAVE / LOAD and
the command WAL (activation, truncation, crash replay, strict and
recover modes), --wal-dir durability and ``wal truncate``, themed
output, completion. Paths in the output are the same once each shell's
directory is written as ``<dir>``. Where the port refuses a statement
(CACHE and CHECKPOINT: ROADMAP item 6), its output is an error naming
the item instead.
"""

import io
from pathlib import Path

import pytest

from neumann_tpu.router import QueryRouter as JRouter
from neumann_tpu.shell import Shell as JShell
from neumann_tpu_torch.router import QueryRouter as TRouter
from neumann_tpu_torch.shell import Shell as TShell
from neumann_tpu_torch.shell.shell import _split_script

ROOT = Path(__file__).resolve().parents[1]
SAMPLE = ROOT / "samples" / "knowledge-base.nql"
UNPORTED = ("CACHE", "CHECKPOINT")


def _jax_router():
    r = JRouter()
    r.vector.config.mesh_auto = False
    return r


def _shells(tmp_path, theme="plain", wal=False, **kw):
    """A JAX and a port shell, each with a directory of its own."""
    out = []
    for name, cls, router in (("jax", JShell, _jax_router),
                              ("port", TShell,
                               lambda: TRouter(device="cpu"))):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        sh = cls(router=router(), stdout=io.StringIO(), theme=theme,
                 wal_dir=str(d / "data") if wal else None, **kw)
        out.append((sh, d))
    return out


def _run(sh, d, lines):
    outs = []
    for line in lines:
        got = sh.execute(line.replace("{dir}", str(d)))
        outs.append(got if got is None else got.replace(str(d), "<dir>"))
    return outs


def _same(tmp_path, lines, **kw):
    (js, jd), (ts, td) = _shells(tmp_path, **kw)
    want, got = _run(js, jd, lines), _run(ts, td, lines)
    for line, g, w in zip(lines, got, want):
        assert g == w, line
    return js, ts


@pytest.fixture(scope="module")
def sample_outputs(tmp_path_factory):
    stmts = _split_script(SAMPLE.read_text())
    (js, jd), (ts, td) = _shells(tmp_path_factory.mktemp("kb"))
    return stmts, _run(js, jd, stmts), _run(ts, td, stmts)


@pytest.mark.parametrize("i", range(len(_split_script(SAMPLE.read_text()))))
def test_knowledge_base_sample(sample_outputs, i):
    stmts, want, got = sample_outputs
    if stmts[i].upper().startswith(UNPORTED):
        assert got[i].startswith("error:") and "ROADMAP: 6" in got[i], got[i]
    else:
        assert "error" not in got[i].lower(), (stmts[i], got[i])
        assert got[i] == want[i], stmts[i]


SCRIPTS = {
    "builtins": ["help", "", "tables", "quit;", "exit", "clear"],
    "statements": ["CREATE TABLE t (v INT)", "INSERT INTO t VALUES (42)",
                   "SELECT * FROM t", "EMBED STORE 'x' [1.0, 0.0]",
                   "EMBED STORE 'y' [0.6, 0.8]", "SIMILAR 'x' TOP 2",
                   "SHOW EMBEDDINGS", "COUNT EMBEDDINGS",
                   "NODE CREATE person {name: 'ada'}",
                   "NODE CREATE person {name: 'bob'}",
                   "EDGE CREATE 0 -> 1 : knows", "PATH SHORTEST 0 TO 1",
                   "NEIGHBORS 0 OUTGOING", "MATCH (a)-[:knows]->(b) "
                   "RETURN a.name, b.name"],
    "errors": ["SELECT * FROM missing", "SELEC * FROM t",
               "INSERT INTO nowhere VALUES (1)", "\\i /nope/missing.nql"],
    "multi": ["CREATE TABLE m (v INT); INSERT INTO m VALUES (1); "
              "SELECT * FROM m",
              "CREATE (a:X { name: 'semi;colon' })",
              "SELECT * FROM m; SELECT v FROM m"],
    "usage": ["SAVE", "LOAD", "vault init", "vault identity",
              "vault identity 'alice'", "vault identity", "wal status",
              "wal truncate"],
    "save_load": ["CREATE TABLE t (v INT)", "EMBED STORE 'k' [1.0]",
                  "save '{dir}/snap.ntpu'", "INSERT INTO t VALUES (5)",
                  "load '{dir}/snap.ntpu'", "COUNT EMBEDDINGS",
                  "SELECT * FROM t"],
    "command_wal": ["CREATE TABLE t (v INT)", "save '{dir}/s.ntpu'",
                    "wal status", "load '{dir}/s.ntpu'",
                    "INSERT INTO t VALUES (1)", "SELECT * FROM t",
                    "INSERT INTO t\nVALUES (2)",
                    "SELECT * FROM t; INSERT INTO t VALUES (42)",
                    "wal status", "save '{dir}/s.ntpu'", "wal status",
                    "SAVE COMPRESSED '{dir}/a.ntpz'",
                    "SAVE '{dir}/b.ntpz' COMPRESSED",
                    "LOAD '{dir}/a.ntpz'", "SELECT v FROM t ORDER BY v"],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script(tmp_path, name):
    _same(tmp_path, SCRIPTS[name])


@pytest.mark.parametrize("theme", ["dark", "light", "minimal"])
def test_themed_output(tmp_path, theme):
    _same(tmp_path, SCRIPTS["statements"] + ["SELECT v FROM t WHERE v > 1"],
          theme=theme)


def test_wal_dir_durability_and_truncate(tmp_path):
    lines = ["CREATE TABLE users (name TEXT, age INT)",
             "INSERT INTO users VALUES ('alice', 30)",
             "CREATE INDEX ON users (age)", "EMBED STORE 'a' [1.0, 2.0]"]
    lines += [f"INSERT INTO users VALUES ('u{i}', {i})" for i in range(20)]
    (js, jd), (ts, td) = _shells(tmp_path, wal=True)
    assert _run(ts, td, lines) == _run(js, jd, lines)
    for sh in (js, ts):
        sh.router.store.wal_flush()
    again = ["SELECT * FROM users WHERE age = 30", "SHOW EMBEDDINGS",
             "SELECT COUNT(*) FROM users", "wal status",
             "UPDATE users SET age = 31 WHERE name = 'alice'",
             "DELETE FROM users WHERE name = 'u3'", "wal truncate",
             "wal status", "SAVE", "LOAD", "SELECT age FROM users "
             "WHERE name = 'alice'"]
    (js2, _), (ts2, _) = _shells(tmp_path, wal=True)
    want, got = _run(js2, jd, again), _run(ts2, td, again)
    for line, g, w in zip(again, got, want):
        assert g == w, line
    assert ts2.router.relational.list_indexes("users")["hash"] == ["age"]
    (js3, _), (ts3, _) = _shells(tmp_path, wal=True)
    tail = ["SELECT COUNT(*) FROM users", "SELECT age FROM users WHERE "
            "name = 'alice'", "SELECT * FROM users WHERE name = 'u3'"]
    assert _run(ts3, td, tail) == _run(js3, jd, tail)


def test_crash_replay_strict_and_recover(tmp_path):
    (js, jd), (ts, td) = _shells(tmp_path)
    first = ["CREATE TABLE t (v INT)", "save '{dir}/s.ntpu'",
             "load '{dir}/s.ntpu'", "INSERT INTO t VALUES (7)",
             "INSERT INTO t VALUES (8)"]
    assert _run(ts, td, first) == _run(js, jd, first)
    replay = ["load '{dir}/s.ntpu'", "SELECT v FROM t ORDER BY v"]
    (js2, _), (ts2, _) = _shells(tmp_path)
    assert _run(ts2, td, replay) == _run(js2, jd, replay)
    for d in (jd, td):               # a failing line, then a good one
        with open(d / "s.ntpu.log", "a", encoding="utf-8") as f:
            f.write("INSERT INTO missing VALUES (1)\n")
            f.write("INSERT INTO t VALUES (9)\n")
    for mode in ("strict", "recover"):
        (js3, _), (ts3, _) = _shells(tmp_path, wal_recovery=mode)
        lines = replay + ["SELECT v FROM t WHERE v = 9"]
        got, want = _run(ts3, td, lines), _run(js3, jd, lines)
        assert got == want, mode
        assert ("skipped 1" in got[0]) == (mode == "recover")


def test_script_execution_builtin(tmp_path):
    """``\\i`` runs a script: equal text for every statement the port
    runs; the CACHE / CHECKPOINT lines are the port's named refusals."""
    (js, jd), (ts, td) = _shells(tmp_path, wal=True)
    line = f"\\i {SAMPLE}"
    want = _run(js, jd, [line])[0].split("\n")
    got = _run(ts, td, [line])[0].split("\n")
    refused = [g for g in got if g.startswith("error:")]
    assert len(refused) == 4 and all("ROADMAP: 6" in g for g in refused)
    assert [g for g in got if not g.startswith("error:")] == \
        [w for w in want if not w.startswith(("cache", "cached", "The MXU",
                                              "checkpoint"))]
    assert _run(ts, td, ["SELECT COUNT(*) FROM people", "\\q"]) == \
        _run(js, jd, ["SELECT COUNT(*) FROM people", "\\q"])


def test_completion(tmp_path):
    js, ts = _same(tmp_path, ["CREATE TABLE customers (id INT)",
                              "CREATE COLLECTION custdocs DIM 4"])
    for prefix in ("cust", "SEL", "he", "c"):
        got, want = [], []
        for sh, out in ((ts, got), (js, want)):
            i = 0
            while (c := sh.complete(prefix, i)) is not None:
                out.append(c)
                i += 1
        assert got == want and got, prefix


def test_doctor_reports_the_torch_device(tmp_path):
    """The JAX shell counts JAX's devices (eight virtual CPUs in the
    tests), the port's the router's torch device; the other checks are
    equal."""
    (js, jd), (ts, td) = _shells(tmp_path)
    got = ts.doctor().split("\n")
    want = js.doctor().split("\n")
    assert [g for g in got if "devices" not in g] == \
        [w for w in want if "devices" not in w]
    assert [g for g in got if "devices" in g] == \
        ["  [OK ] devices         1 x cpu"]


def test_main_runs_one_command(monkeypatch, capsys):
    """``python -m neumann_tpu_torch.shell -c ...`` wiring, on a CPU
    router in place of the default card router."""
    from neumann_tpu_torch.shell import shell as tshell

    monkeypatch.setattr(tshell, "QueryRouter",
                        lambda: TRouter(device="cpu"))
    assert tshell.main(["-c", "SHOW TABLES", "--theme", "plain"]) == 0
    assert "no rows" in capsys.readouterr().out

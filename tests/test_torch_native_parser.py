"""The port's native lexer and parser (neumann_tpu_torch/native/) against
the port's pure-Python parser and the JAX package's native parser.

The statements are those of tests/test_native_parser.py (its covered and
fallback lists, the grammar fuzz at the same seeds, the byte-mutation
fuzz at the same seed). For every statement the native parser accepts,
its AST equals the port's Python parser's (dataclass ``__eq__``, fields
compared recursively) and, field by field with class names, the JAX
native parser's; the rest return None, so the Python parser and its
ParseError stay authoritative. The native tokenizer gives the regex
tokenizer's tokens and errors.
"""

import dataclasses
import random
from pathlib import Path

import pytest

from neumann_tpu.native import pyparser as jax_pyparser
from neumann_tpu_torch.lang import lexer as tlexer
from neumann_tpu_torch.lang import parser as tparser
from neumann_tpu_torch.lang.parser import _Parser
from neumann_tpu_torch.native import BUILD_DIR
from neumann_tpu_torch.native import pylexer, pyparser
from neumann_tpu_torch.utils.errors import ParseError
from tests.test_native_parser import COVERED, FALLBACK

ext = pyparser.load()
lex = pylexer.load()
jext = jax_pyparser.load()
pytestmark = pytest.mark.skipif(ext is None or lex is None or jext is None,
                                reason="no native toolchain")

ERRORS = ["SELECT", "SELECT FROM", "INSERT INTO", "SIMILAR",
          "SELECT a FROM t WHERE", "SELECT a FROM t WHERE x = 1e",
          "SELECT a FROM t trailing junk here"]


def _plain(v):
    """An AST as nested (class name, fields) pairs, so the two
    packages' objects compare field by field with their class names."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, {f.name: _plain(getattr(v, f.name))
                                   for f in dataclasses.fields(v)})
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, [_plain(x) for x in v])
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return (type(v).__name__, v)


def _python_tokens(src):
    """The regex tokenizer's answer (the native path switched off)."""
    saved = tlexer._EXT, tlexer._EXT_TRIED
    tlexer._EXT, tlexer._EXT_TRIED = None, True
    try:
        return tlexer.tokenize(src)
    finally:
        tlexer._EXT, tlexer._EXT_TRIED = saved


def test_builds_into_the_build_directory_only():
    src_dir = Path(pyparser.__file__).parent
    for mod in (ext, lex):
        assert Path(mod.__file__).parent == BUILD_DIR
        assert Path(mod.__file__).name.startswith(mod.__name__ + "-")
    assert not list(src_dir.glob("*.so"))
    assert pyparser.built()
    # the port's images, not the JAX package's
    assert Path(jext.__file__).parent != BUILD_DIR


@pytest.mark.parametrize("src", COVERED)
def test_covered_statement_matches_python_and_jax(src):
    got = ext.parse(src)
    assert got is not None, f"native fell back on covered: {src!r}"
    assert type(got).__module__ == "neumann_tpu_torch.lang.ast"
    assert got == _Parser(src).statement()
    assert _plain(got) == _plain(jext.parse(src))


@pytest.mark.parametrize("src", FALLBACK)
def test_fallback_statement_returns_none(src):
    assert ext.parse(src) is None


def test_parse_entry_point_is_the_native_one():
    """Once the extension is built, ``parse`` is the C ``parse_full``:
    covered statements take the fast path, uncovered grammar and syntax
    errors the registered Python fallback."""
    tparser._native()
    assert tparser.parse.__name__ == "parse_full"
    for src in COVERED:
        assert tparser.parse(src) == _Parser(src).statement(), src
    assert type(tparser.parse("CREATE TABLE t (a INT)")).__name__ == \
        "CreateTable"
    assert tparser.parse_cached("SELECT * FROM t") == \
        _Parser("SELECT * FROM t").statement()


@pytest.mark.parametrize("bad", ERRORS)
def test_syntax_errors_raise_the_python_parse_error(bad):
    with pytest.raises(ParseError) as native:
        tparser.parse(bad)
    with pytest.raises(ParseError) as python:
        tparser._parse_python(bad)
    assert str(native.value) == str(python.value)


@pytest.mark.parametrize("seed", range(6))
def test_grammar_fuzz_differential(seed):
    """Random statements from the grammar fuzzer: wherever the native
    parser answers it agrees with the Python parser and with the JAX
    native parser, and it accepts nothing the Python parser rejects."""
    from tests.test_grammar_fuzz import Gen

    covered = 0
    g = Gen(seed)
    for _ in range(150):
        src = g.statement()
        try:
            want = _Parser(src).statement()
        except Exception:
            assert ext.parse(src) is None, src
            continue
        got = ext.parse(src)
        assert _plain(got) == _plain(jext.parse(src)), src
        if got is not None:
            covered += 1
            assert got == want, src
    assert covered > 5          # the fast path actually fires


def test_mutation_fuzz_no_crash_no_divergence():
    rng = random.Random(7)
    seeds = COVERED + FALLBACK
    for _ in range(3000):
        s = list(rng.choice(seeds))
        for _ in range(rng.randint(1, 4)):
            if not s:
                break
            i = rng.randrange(len(s))
            r = rng.random()
            if r < 0.4:
                s[i] = chr(rng.randint(32, 126))
            elif r < 0.7:
                del s[i]
            else:
                s.insert(i, chr(rng.randint(32, 126)))
        src = "".join(s)
        got = ext.parse(src)
        assert _plain(got) == _plain(jext.parse(src)), src
        if got is None:
            continue
        assert got == _Parser(src).statement(), src


def _tokens_or_error(tokenize, src):
    try:
        return tokenize(src)
    except ParseError as e:
        return ("ParseError", str(e), e.args)


# ASCII sources only: non-ASCII input takes the regex path by design
@pytest.mark.parametrize("src", [s for s in COVERED + FALLBACK + [
    "SIMILAR [0.5, -1e-3, 2.5E+2, .25, 7] TOP 3",
    "SELECT a FROM t WHERE x = 'it''s' -- note\n AND y >= 2",
    "EDGE CREATE 0 -> 1 : knows { w: 0.5 }",
    "SELECT 'unterminated", "SELECT a ? b", "SELECT 1e", "x = 2e+",
] if s.isascii()])
def test_native_tokenizer_equals_regex_tokenizer(src):
    """Tokens, or the ParseError (message, line, column), equal."""
    want = _tokens_or_error(_python_tokens, src)
    assert _tokens_or_error(tlexer.tokenize, src) == want
    try:
        got = lex.tokenize(src)
    except ValueError as e:     # the extension raises (msg, line, col)
        err = ParseError(*e.args)
        got = ("ParseError", str(err), err.args)
    assert got == want


def test_parse_param_fast_paths():
    """parse_param: covered statements parse natively; others through
    the native shape() key and the template cache; both equal the
    Python parser, also on a second call (a template hit)."""
    stmts = ["SIMILAR [0.25, -1.5, 3] TOP 4",
             "SIMILAR [0.5, 2, -7.25] IN docs TOP 2 METRIC EUCLIDEAN",
             "NODE CREATE person {name: 'b', age: 30}",
             "EDGE CREATE 3 -> 4 : knows",
             "NEIGHBORS 7 OUTGOING : knows",
             "INSERT INTO t VALUES (1, 'a', 2.5)"]
    for _ in range(2):
        for src in stmts:
            assert tparser.parse_param(src) == _Parser(src).statement(), src


def test_identifier_cache_value_correctness():
    names = [f"col{i}" for i in range(2000)] + ["a", "ab", "ba", "a"]
    for nm in names:
        s = ext.parse(f"SELECT {nm} FROM {nm}2")
        assert s is not None
        assert s.items[0].expr == nm
        assert s.table == nm + "2"

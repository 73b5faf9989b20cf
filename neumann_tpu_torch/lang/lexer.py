"""Regex-table lexer with source positions.

Mirrors neumann_parser/src/lexer.rs in capability: case-insensitive
keywords (identifier tokens, uppercased at parse level), single-quoted
strings with '' escapes, numbers (int/float/scientific), vector literals
are handled at parse level from '[' tokens, punctuation including ->
arrows.

One compiled master pattern per token class (3x faster than the previous
char-at-a-time loop — the lexer was 60% of parse time); tokens are a
NamedTuple because frozen-dataclass construction goes through
object.__setattr__ and measurably drags the hot loop.

Copy of ``neumann_tpu.lang.lexer`` with only its import lines changed:
the native tokenizer is the port's own build of the same source
(``neumann_tpu_torch/native/pylexer.py``), initialised with this
module's ``Token``. See ``neumann_tpu_torch.lang.parser`` for why the
language modules are copied.
"""

from __future__ import annotations

import re
from typing import List, NamedTuple

from neumann_tpu_torch.utils.errors import ParseError

PUNCT = (
    "->", "<=", ">=", "!=", "<>", "(", ")", "[", "]", "{", "}", ",", ":",
    ";", "=", "<", ">", "*", ".", "+", "-", "/", "%",
)


class Token(NamedTuple):
    kind: str   # "ident" | "string" | "number" | "punct" | "eof"
    text: str
    value: object
    line: int
    col: int

    def upper(self) -> str:
        return self.text.upper() if self.kind == "ident" else self.text


# Number pattern keeps the hand-lexer's greediness: an exponent marker
# consumes the optional sign and any digits, so "1e" / "2e+" lex as ONE
# malformed number token (-> "bad number") instead of number+ident.
_MASTER = re.compile(
    r"""(?P<ws>[ \t\r\n]+)
      | (?P<comment>--[^\n]*)
      | (?P<string>'(?:[^']|'')*')
      | (?P<number>\d+(?:\.\d*)?(?:[eE][+-]?\d*)?
                  |\.\d+(?:[eE][+-]?\d*)?)
      | (?P<ident>[^\W\d]\w*)
      | (?P<punct>->|<=|>=|!=|<>|[()\[\]{},:;=<>*.+\-/%])
    """,
    re.VERBOSE,
)


_EXT = None
_EXT_TRIED = False


def _ext():
    global _EXT, _EXT_TRIED
    if not _EXT_TRIED:
        _EXT_TRIED = True
        from neumann_tpu_torch.native import pylexer

        _EXT = pylexer.load()
    return _EXT


def tokenize(src: str) -> List[Token]:
    # ASCII sources take the native tokenizer (~10x); non-ASCII input
    # keeps the regex path so unicode identifier semantics are exact
    if src.isascii():
        ext = _EXT if _EXT_TRIED else _ext()
        if ext is not None:
            try:
                return ext.tokenize(src)
            except ValueError as e:
                msg, line, col = e.args
                raise ParseError(msg, line, col) from None
    toks: List[Token] = []
    append = toks.append
    match = _MASTER.match
    pos = 0
    line = 1
    line_start = 0
    n = len(src)
    while pos < n:
        m = match(src, pos)
        if m is None:
            col = pos - line_start + 1
            if src[pos] == "'":
                raise ParseError("unterminated string", line, col)
            raise ParseError(f"unexpected character {src[pos]!r}",
                             line, col)
        kind = m.lastgroup
        text = m.group()
        tok_line = line
        tok_col = pos - line_start + 1
        if "\n" in text:
            line += text.count("\n")
            line_start = pos + text.rindex("\n") + 1
        pos = m.end()
        if kind == "ws" or kind == "comment":
            continue
        if kind == "ident":
            append(Token("ident", text, text, tok_line, tok_col))
        elif kind == "punct":
            append(Token("punct", text, text, tok_line, tok_col))
        elif kind == "number":
            try:
                value: object = int(text)
            except ValueError:
                try:
                    value = float(text)
                except ValueError as e:
                    raise ParseError(f"bad number {text!r}", tok_line,
                                     tok_col) from e
            append(Token("number", text, value, tok_line, tok_col))
        else:  # string
            body = text[1:-1]
            if "''" in body:
                body = body.replace("''", "'")
            append(Token("string", body, body, tok_line, tok_col))
    append(Token("eof", "", None, line, pos - line_start + 1))
    return toks

"""Scalar expression trees for SELECT items.

The reference's select list takes full expressions (neumann_parser
ast.rs: SelectItem.expr is an Expr; operator/CASE/CAST surface in
docs/book/src/reference/functions.md:83-160). Here expressions are
evaluated row-wise in the router after the engine fetch; NULL
propagates through arithmetic like SQL (any NULL operand -> NULL).

Copy of ``neumann_tpu.lang.expr`` with only its import lines changed
(see ``neumann_tpu_torch.lang.parser`` for why).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from neumann_tpu_torch.engines.condition import Condition
from neumann_tpu_torch.utils.errors import NeumannError


class Expr:
    def evaluate(self, row: dict):
        raise NotImplementedError

    def label(self) -> str:
        raise NotImplementedError

    def map_cols(self, fn) -> "Expr":
        """Structurally rewrite column names (alias/qualifier fixes)."""
        return self


@dataclass(frozen=True)
class Col(Expr):
    name: str

    def evaluate(self, row: dict):
        return row.get(self.name)

    def label(self) -> str:
        return self.name

    def map_cols(self, fn) -> "Expr":
        return Col(fn(self.name))


@dataclass(frozen=True)
class Lit(Expr):
    value: object

    def evaluate(self, row: dict):
        return self.value

    def label(self) -> str:
        return repr(self.value)


@dataclass(frozen=True)
class Bin(Expr):
    op: str          # + - * / %
    left: Expr
    right: Expr

    def evaluate(self, row: dict):
        a = self.left.evaluate(row)
        b = self.right.evaluate(row)
        if a is None or b is None:
            return None
        try:
            if self.op == "+":
                return a + b
            if self.op == "-":
                return a - b
            if self.op == "*":
                return a * b
            if self.op == "/":
                return a / b
            if self.op == "%":
                return a % b
        except ZeroDivisionError:
            raise NeumannError("division by zero") from None
        except TypeError:
            raise NeumannError(
                f"bad operands for {self.op}: {a!r}, {b!r}") from None
        raise NeumannError(f"unknown operator {self.op}")

    def label(self) -> str:
        def side(e):
            lbl = e.label()
            return f"({lbl})" if isinstance(e, Bin) else lbl

        return f"{side(self.left)} {self.op} {side(self.right)}"

    def map_cols(self, fn) -> "Expr":
        return Bin(self.op, self.left.map_cols(fn),
                   self.right.map_cols(fn))


@dataclass(frozen=True)
class Case(Expr):
    whens: Tuple[Tuple[Condition, Expr], ...]
    else_: Optional[Expr] = None

    def evaluate(self, row: dict):
        for cond, result in self.whens:
            if cond.evaluate_row(row):
                return result.evaluate(row)
        return self.else_.evaluate(row) if self.else_ else None

    def label(self) -> str:
        return "case"

    def map_cols(self, fn) -> "Expr":
        from dataclasses import replace as _r

        def fix_cond(c):
            if c is None:
                return None
            kw = {}
            if c.column is not None:
                kw["column"] = fn(c.column)
            return _r(c, left=fix_cond(c.left),
                      right=fix_cond(c.right), **kw)

        return Case(tuple((fix_cond(c), r.map_cols(fn))
                          for c, r in self.whens),
                    self.else_.map_cols(fn) if self.else_ else None)


_CASTS = {
    "int": int, "float": float, "text": str,
    "bool": lambda v: bool(v) if not isinstance(v, str)
    else v.lower() in ("true", "t", "1"),
}


@dataclass(frozen=True)
class Cast(Expr):
    expr: Expr
    ctype: str       # int/float/text/bool

    def evaluate(self, row: dict):
        v = self.expr.evaluate(row)
        if v is None:
            return None
        fn = _CASTS.get(self.ctype)
        if fn is None:
            raise NeumannError(f"cannot CAST to {self.ctype}")
        try:
            return fn(v)
        except (TypeError, ValueError):
            raise NeumannError(
                f"cannot CAST {v!r} to {self.ctype}") from None

    def label(self) -> str:
        return f"cast({self.expr.label()} as {self.ctype})"

    def map_cols(self, fn) -> "Expr":
        return Cast(self.expr.map_cols(fn), self.ctype)


# ---------------------------------------------------------------------------
# Scalar function calls
# ---------------------------------------------------------------------------
# The reference PARSES calls (neumann_parser ExprKind::Call,
# parse_function_call_expr) but its router executes only aggregates;
# here the common scalar set also evaluates. SQL NULL rules: NULL in ->
# NULL out, except COALESCE (first non-NULL) and NULLIF.

def _round(v, nd=None):
    # SQL rounds half AWAY FROM ZERO (sqlite, postgres); Python's
    # round() is banker's. Always yields a float, like sqlite.
    import math

    scale = 10.0 ** int(nd or 0)
    x = float(v) * scale
    x = math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)
    return x / scale


def _substr(s, start, length=None):
    s = str(s)
    i = int(start) - 1          # SQL SUBSTR is 1-based
    if i < 0:
        i = max(0, len(s) + i + 1)
    return s[i:] if length is None else s[i: i + int(length)]


_FUNCS = {
    # name: (min_args, max_args, fn, null_propagates)
    "coalesce": (1, 99, None, False),        # special-cased
    "nullif": (2, 2, None, False),           # special-cased
    "abs": (1, 1, lambda v: abs(float(v) if not isinstance(v, int)
                                else v), True),
    "round": (1, 2, _round, True),
    "floor": (1, 1, lambda v: int(__import__("math").floor(float(v))),
              True),
    "ceil": (1, 1, lambda v: int(__import__("math").ceil(float(v))),
             True),
    "mod": (2, 2, lambda a, b: float(a) % float(b), True),
    "upper": (1, 1, lambda v: str(v).upper(), True),
    "lower": (1, 1, lambda v: str(v).lower(), True),
    "length": (1, 1, lambda v: len(str(v)), True),
    "trim": (1, 1, lambda v: str(v).strip(), True),
    "substr": (2, 3, _substr, True),
    "replace": (3, 3, lambda s, a, b: str(s).replace(str(a), str(b)),
                True),
}


def known_function(name: str) -> bool:
    return name.lower() in _FUNCS


def function_arity(name: str) -> Tuple[int, int]:
    lo, hi, _, _ = _FUNCS[name.lower()]
    return lo, hi


@dataclass(frozen=True)
class Func(Expr):
    name: str                    # lowercase
    args: Tuple[Expr, ...]

    def evaluate(self, row: dict):
        if self.name == "coalesce":
            for a in self.args:
                v = a.evaluate(row)
                if v is not None:
                    return v
            return None
        if self.name == "nullif":
            a = self.args[0].evaluate(row)
            if a is None:
                return None
            return None if a == self.args[1].evaluate(row) else a
        _, _, fn, null_prop = _FUNCS[self.name]
        vals = [a.evaluate(row) for a in self.args]
        if null_prop and any(v is None for v in vals):
            return None
        try:
            return fn(*vals)
        except (TypeError, ValueError):
            raise NeumannError(
                f"bad argument to {self.name}()") from None

    def label(self) -> str:
        return f"{self.name}({', '.join(a.label() for a in self.args)})"

    def map_cols(self, fn) -> "Expr":
        return Func(self.name, tuple(a.map_cols(fn) for a in self.args))

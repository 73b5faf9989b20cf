"""Predicate condition tree shared by the relational engine and router.

Parity with relational_engine::Condition (relational_engine/src/lib.rs:
561-659: comparison ops, AND/OR/NOT, IN, LIKE, IS NULL). Two evaluation
modes:

* ``evaluate_row`` — per-row dict evaluation (small scans, tx overlays);
* ``evaluate_columnar`` — vectorized numpy evaluation over whole columns,
  producing the selection bitmap that the reference builds with hand-SIMD
  (relational_engine/src/simd.rs:6-311). The same bitmap feeds device-side
  masked vector scans for hybrid queries.

Copy of ``neumann_tpu.engines.condition`` with only its import lines
changed: ``neumann_tpu.engines.__init__`` eagerly imports the JAX-backed
vector engine, so the original cannot be imported without JAX.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

_OPS = ("=", "!=", "<", "<=", ">", ">=")


def _like_to_regex(pattern: str) -> "re.Pattern":
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def _expr_to_dict(e) -> dict:
    """Serialize a Col/Lit/Bin expression tree (for shipping
    conditions to cluster peers); richer nodes (CASE/CAST) raise."""
    cls = type(e).__name__
    if cls == "Col":
        return {"t": "col", "name": e.name}
    if cls == "Lit":
        return {"t": "lit", "value": e.value}
    if cls == "Bin":
        return {"t": "bin", "op": e.op, "l": _expr_to_dict(e.left),
                "r": _expr_to_dict(e.right)}
    raise ValueError(f"expression condition not serializable: {cls}")


def _expr_from_dict(d: dict):
    from neumann_tpu_torch.lang import expr as E

    if d["t"] == "col":
        return E.Col(d["name"])
    if d["t"] == "lit":
        return E.Lit(d["value"])
    return E.Bin(d["op"], _expr_from_dict(d["l"]),
                 _expr_from_dict(d["r"]))


@dataclass(frozen=True, slots=True)
class Condition:
    op: str                      # cmp op | "and" | "or" | "not" | "in" |
    #                              "like" | "is_null" | "is_not_null" | "true"
    column: Optional[str] = None
    value: object = None
    left: Optional["Condition"] = None
    right: Optional["Condition"] = None
    # arithmetic comparison: (left_tree, right_tree) of lang.expr
    # trees; op is the comparison. `WHERE a + b > c * 2` parses here.
    expr: Optional[tuple] = None

    # -- constructors ------------------------------------------------------
    @staticmethod
    def cmp(column: str, op: str, value) -> "Condition":
        if op == "==":
            op = "="
        if op == "<>":
            op = "!="
        if op not in _OPS:
            raise ValueError(f"bad comparison op {op}")
        return Condition(op, column, value)

    @staticmethod
    def eq(column, value):
        return Condition("=", column, value)

    @staticmethod
    def in_(column: str, values: Sequence) -> "Condition":
        return Condition("in", column, tuple(values))

    @staticmethod
    def like(column: str, pattern: str) -> "Condition":
        return Condition("like", column, pattern)

    @staticmethod
    def is_null(column: str) -> "Condition":
        return Condition("is_null", column)

    @staticmethod
    def is_not_null(column: str) -> "Condition":
        return Condition("is_not_null", column)

    @staticmethod
    def true() -> "Condition":
        return Condition("true")

    def and_(self, other: "Condition") -> "Condition":
        return Condition("and", left=self, right=other)

    def or_(self, other: "Condition") -> "Condition":
        return Condition("or", left=self, right=other)

    def not_(self) -> "Condition":
        return Condition("not", left=self)

    # -- introspection / serialization --------------------------------------
    def columns(self) -> set:
        """All column names referenced anywhere in this tree."""
        out = set()
        if self.column is not None:
            out.add(self.column)
        if self.expr is not None:
            for tree in self.expr:
                tree.map_cols(lambda n: (out.add(n), n)[1])
        for side in (self.left, self.right):
            if side is not None:
                out |= side.columns()
        return out

    def to_dict(self) -> dict:
        d: dict = {"op": self.op}
        if self.expr is not None:
            d["expr"] = [_expr_to_dict(t) for t in self.expr]
        if self.column is not None:
            d["column"] = self.column
        if self.value is not None:
            v = self.value
            d["value"] = list(v) if isinstance(v, tuple) else v
        if self.left is not None:
            d["left"] = self.left.to_dict()
        if self.right is not None:
            d["right"] = self.right.to_dict()
        return d

    @staticmethod
    def from_dict(d: dict) -> "Condition":
        v = d.get("value")
        if d["op"] == "in" and isinstance(v, list):
            v = tuple(v)
        expr = None
        if d.get("expr"):
            expr = tuple(_expr_from_dict(e) for e in d["expr"])
        return Condition(
            d["op"], d.get("column"), v,
            Condition.from_dict(d["left"]) if d.get("left") else None,
            Condition.from_dict(d["right"]) if d.get("right") else None,
            expr)

    # -- row evaluation ------------------------------------------------------
    def evaluate_row(self, row: Dict[str, object]) -> bool:
        """True iff the condition is definitively TRUE for the row
        (SQL three-valued logic: UNKNOWN filters out at the top)."""
        return self._row3(row) is True

    def _row3(self, row: Dict[str, object]):
        """Kleene evaluation: True / False / None (UNKNOWN). Getting
        NOT right requires the distinction — `NOT (NULL = 1)` is
        UNKNOWN, not TRUE, so `WHERE NOT a = 1` and `a NOT IN (...)`
        must exclude NULL rows like every SQL engine does."""
        op = self.op
        if op == "true":
            return True
        if op == "exists":
            raise ValueError("unresolved subquery condition (EXISTS)")
        if type(self.value).__name__ == "Subquery":
            raise ValueError("unresolved subquery condition")
        if op == "and":
            a = self.left._row3(row)
            b = self.right._row3(row)
            if a is False or b is False:
                return False
            if a is None or b is None:
                return None
            return True
        if op == "or":
            a = self.left._row3(row)
            b = self.right._row3(row)
            if a is True or b is True:
                return True
            if a is None or b is None:
                return None
            return False
        if op == "not":
            a = self.left._row3(row)
            return None if a is None else (not a)
        if self.expr is not None:
            lt, rt = self.expr
            lv, rv = lt.evaluate(row), rt.evaluate(row)
            if lv is None or rv is None:
                return None
            return self._cmp_scalar(lv, op, rv)
        val = row.get(self.column)
        if op == "is_null":
            return val is None
        if op == "is_not_null":
            return val is not None
        if val is None:
            return None                    # comparisons with NULL: UNKNOWN
        if op == "in":
            return val in self.value
        if op == "like":
            return isinstance(val, str) and bool(
                _like_to_regex(self.value).match(val))
        try:
            if op == "=":
                return val == self.value
            if op == "!=":
                return val != self.value
            if op == "<":
                return val < self.value
            if op == "<=":
                return val <= self.value
            if op == ">":
                return val > self.value
            if op == ">=":
                return val >= self.value
        except TypeError:
            return False
        raise ValueError(f"bad condition op {op}")

    # -- columnar evaluation ---------------------------------------------------
    def evaluate_columnar(self, columns: Dict[str, np.ndarray],
                          nulls: Dict[str, np.ndarray],
                          n: int) -> np.ndarray:
        """Vectorized evaluation -> bool[n] selection bitmap.

        ``columns[name]`` is the raw value array (typed numpy or object),
        ``nulls[name]`` a bool array marking NULLs.
        """
        truth, _ = self._col3(columns, nulls, n)
        return truth

    def _col3(self, columns, nulls, n):
        """Vectorized Kleene evaluation -> (truth[n], unknown[n]).
        The unknown mask lets NOT / AND / OR treat NULL comparisons as
        UNKNOWN instead of FALSE (see _row3)."""
        op = self.op
        if op == "true":
            return np.ones(n, bool), np.zeros(n, bool)
        if op == "exists" or type(self.value).__name__ == "Subquery":
            raise ValueError("unresolved subquery condition")
        if op == "and":
            ta, ua = self.left._col3(columns, nulls, n)
            tb, ub = self.right._col3(columns, nulls, n)
            fa = ~ta & ~ua
            fb = ~tb & ~ub
            truth = ta & tb
            unknown = ~truth & ~(fa | fb)
            return truth, unknown
        if op == "or":
            ta, ua = self.left._col3(columns, nulls, n)
            tb, ub = self.right._col3(columns, nulls, n)
            truth = ta | tb
            fa = ~ta & ~ua
            fb = ~tb & ~ub
            unknown = ~truth & ~(fa & fb)
            return truth, unknown
        if op == "not":
            ta, ua = self.left._col3(columns, nulls, n)
            return ~ta & ~ua, ua
        if self.expr is not None:
            # expression comparisons evaluate row-wise (rare path)
            names = list(columns)
            truth = np.zeros(n, bool)
            unknown = np.zeros(n, bool)
            for i in range(n):
                row = {name: (None if nulls[name][i] else columns[name][i])
                       for name in names}
                r3 = self._row3(row)
                if r3 is True:
                    truth[i] = True
                elif r3 is None:
                    unknown[i] = True
            return truth, unknown
        if self.column not in columns:
            return np.zeros(n, bool), np.zeros(n, bool)
        col = columns[self.column]
        null = nulls[self.column]
        if op == "is_null":
            return null.copy(), np.zeros(n, bool)
        if op == "is_not_null":
            return ~null, np.zeros(n, bool)
        valid = ~null
        if op == "in":
            out = np.zeros(n, bool)
            for v in self.value:
                out |= self._cmp_vec(col, "=", v)
            return out & valid, null    # unknown masks are read-only
        if op == "like":
            rx = _like_to_regex(self.value)
            out = np.fromiter(
                (isinstance(v, str) and bool(rx.match(v)) for v in col),
                bool, count=n)
            return out & valid, null
        if col.dtype == object and null.any() and op not in ("=", "!="):
            # ordered compares on object columns choke on None; substitute
            # the probe value at null slots (result ANDed out by `valid`)
            col = col.copy()
            col[null] = self.value
        return self._cmp_vec(col, op, self.value) & valid, null

    @staticmethod
    def _cmp_scalar(a, op: str, b) -> bool:
        try:
            if op == "=":
                return bool(a == b)
            if op == "!=":
                return bool(a != b)
            if op == "<":
                return bool(a < b)
            if op == "<=":
                return bool(a <= b)
            if op == ">":
                return bool(a > b)
            if op == ">=":
                return bool(a >= b)
        except TypeError:
            return False
        raise ValueError(f"bad condition op {op}")

    @staticmethod
    def _cmp_vec(col: np.ndarray, op: str, value) -> np.ndarray:
        n = len(col)
        try:
            with np.errstate(invalid="ignore"):
                if op == "=":
                    res = col == value
                elif op == "!=":
                    res = col != value
                elif op == "<":
                    res = col < value
                elif op == "<=":
                    res = col <= value
                elif op == ">":
                    res = col > value
                else:
                    res = col >= value
        except TypeError:
            return np.zeros(n, bool)
        if not isinstance(res, np.ndarray):
            # incompatible dtype comparison collapsed to a scalar
            return np.full(n, bool(res))
        return res.astype(bool)

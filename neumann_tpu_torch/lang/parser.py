"""Recursive-descent parser for the query language.

One statement per `parse()` call (semicolon-separated lists via
`parse_many`). Keywords are case-insensitive. See
docs/book/src/reference/query-language.md in the reference for the
statement grammar this mirrors (parser structure itself is original).

Copy of ``neumann_tpu.lang.parser`` with only its import lines changed:
the native C fast path is the port's own build of the same source
(``neumann_tpu_torch/native/pyparser.py``), registered with the port's
``lang.ast`` classes and ``Condition``. The copy is the price of the
JAX package's eager ``engines/__init__`` (importing ``neumann_tpu.lang``
pulls in the JAX-backed vector engine): the PyTorch port must import on
a machine without JAX.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

from neumann_tpu_torch.engines.condition import Condition
from neumann_tpu_torch.lang import ast
from neumann_tpu_torch.lang.lexer import Token, tokenize
from neumann_tpu_torch.utils.errors import ParseError

_TYPE_MAP = {
    "INT": "int", "INTEGER": "int", "BIGINT": "int", "SMALLINT": "int",
    "FLOAT": "float", "DOUBLE": "float", "REAL": "float",
    "DECIMAL": "float", "NUMERIC": "float",
    "VARCHAR": "text", "CHAR": "text", "TEXT": "text", "BLOB": "text",
    "DATE": "text", "TIME": "text", "TIMESTAMP": "text",
    "BOOLEAN": "bool", "BOOL": "bool",
    "VECTOR": "vector",
}

_METRIC_MAP = {
    "COSINE": "cosine", "EUCLIDEAN": "euclidean", "DOT": "dot",
    "DOT_PRODUCT": "dot", "MANHATTAN": "manhattan",
    "COMPOSITE": "composite", "GEOMETRIC": "composite",
    "WEIGHTED_JACCARD": "weighted_jaccard",
    "WJACCARD": "weighted_jaccard",
    "ANGULAR": "angular", "GEODESIC": "geodesic",
    "JACCARD": "jaccard", "OVERLAP": "overlap",
}


_ARITH = ("+", "-", "*", "/", "%")


def _tree_cols(tree) -> set:
    out: set = set()
    tree.map_cols(lambda n: (out.add(n), n)[1])
    return out


class _Parser:
    # Cursor caching: `cur` is toks[pos] and `cur_up` its uppercased
    # text for ident tokens (None otherwise). The helpers below hit
    # these attributes instead of re-indexing + re-uppercasing on every
    # peek — at_kw/accept_kw run ~20x per statement and this halves
    # cold-parse time. Nothing assigns self.pos outside next().

    def __init__(self, src: str, toks=None):
        self.toks = toks if toks is not None else tokenize(src)
        self.pos = 0
        t = self.toks[0]
        self.cur = t
        self.cur_up = t.text.upper() if t.kind == "ident" else None

    # -- stream helpers ----------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        if ahead == 0:
            return self.cur
        toks = self.toks
        i = self.pos + ahead
        return toks[i] if i < len(toks) else toks[-1]

    def next(self) -> Token:
        t = self.cur
        if t.kind != "eof":
            self.pos += 1
            c = self.toks[self.pos]
            self.cur = c
            self.cur_up = c.text.upper() if c.kind == "ident" else None
        return t

    def at_kw(self, *kws: str) -> bool:
        up = self.cur_up
        return up is not None and up in kws

    def accept_kw(self, *kws: str) -> Optional[str]:
        up = self.cur_up
        if up is not None and up in kws:
            self.next()
            return up
        return None

    def expect_kw(self, *kws: str) -> str:
        up = self.cur_up
        if up is not None and up in kws:
            self.next()
            return up
        t = self.cur
        raise ParseError(
            f"expected {' or '.join(kws)}, got {t.text or 'EOF'!r}",
            t.line, t.col)

    def at_punct(self, p: str) -> bool:
        t = self.cur
        return t.kind == "punct" and t.text == p

    def accept_punct(self, p: str) -> bool:
        t = self.cur
        if t.kind == "punct" and t.text == p:
            self.next()
            return True
        return False

    def expect_punct(self, p: str) -> None:
        t = self.cur
        if t.kind == "punct" and t.text == p:
            self.next()
            return
        raise ParseError(f"expected {p!r}, got {t.text or 'EOF'!r}",
                         t.line, t.col)

    def ident(self, what: str = "identifier") -> str:
        t = self.cur
        if t.kind == "ident":
            self.next()
            return t.text
        if t.kind == "string":
            self.next()
            return t.value
        raise ParseError(f"expected {what}, got {t.text or 'EOF'!r}",
                         t.line, t.col)

    def string(self, what: str = "string") -> str:
        t = self.cur
        if t.kind == "string":
            self.next()
            return t.value
        raise ParseError(f"expected {what}, got {t.text or 'EOF'!r}",
                         t.line, t.col)

    def number(self, what: str = "number"):
        t = self.peek()
        neg = False
        if t.kind == "punct" and t.text == "-":
            self.next()
            neg = True
            t = self.peek()
        if t.kind == "number":
            v = self.next().value
            return -v if neg else v
        raise ParseError(f"expected {what}, got {t.text or 'EOF'!r}",
                         t.line, t.col)

    def int_(self, what: str = "integer") -> int:
        v = self.number(what)
        if not isinstance(v, int):
            t = self.peek()
            raise ParseError(f"expected {what}, got float", t.line, t.col)
        return v

    # -- values --------------------------------------------------------------
    def value(self):
        t = self.peek()
        if t.kind == "string":
            return self.next().value
        if t.kind == "number" or (t.kind == "punct" and t.text == "-"):
            return self.number()
        if t.kind == "punct" and t.text == "[":
            return self.vector()
        if t.kind == "ident":
            up = t.text.upper()
            if up == "TRUE":
                self.next()
                return True
            if up == "FALSE":
                self.next()
                return False
            if up == "NULL":
                self.next()
                return None
            return self.next().text  # bare identifier as string value
        raise ParseError(f"expected value, got {t.text or 'EOF'!r}",
                         t.line, t.col)

    def vector(self) -> List[float]:
        self.expect_punct("[")
        out: List[float] = []
        if not self.at_punct("]"):
            while True:
                out.append(float(self.number("vector element")))
                if not self.accept_punct(","):
                    break
        self.expect_punct("]")
        return out

    def property_map(self) -> Dict[str, object]:
        self.expect_punct("{")
        props: Dict[str, object] = {}
        if not self.at_punct("}"):
            while True:
                key = self.ident("property name")
                self.expect_punct(":")
                props[key] = self.value()
                if not self.accept_punct(","):
                    break
        self.expect_punct("}")
        return props

    # -- conditions --------------------------------------------------------
    _allow_aggs = False      # HAVING may reference aggregate results

    def condition(self, allow_aggs: bool = False) -> Condition:
        prev = self._allow_aggs
        self._allow_aggs = allow_aggs
        try:
            return self._or_expr()
        finally:
            self._allow_aggs = prev

    def _subselect(self) -> "ast.Subquery":
        """'(' already consumed; parses SELECT ... ')'."""
        self.expect_kw("SELECT")
        sub = self._stmt_select()
        self.expect_punct(")")
        return ast.Subquery(sub)

    def _at_subquery(self) -> bool:
        nxt = self.peek(1)
        return (self.at_punct("(") and nxt.kind == "ident"
                and nxt.text.upper() == "SELECT")

    def _or_expr(self) -> Condition:
        left = self._and_expr()
        while self.accept_kw("OR"):
            left = left.or_(self._and_expr())
        return left

    def _and_expr(self) -> Condition:
        left = self._not_expr()
        while self.accept_kw("AND"):
            left = left.and_(self._not_expr())
        return left

    def _not_expr(self) -> Condition:
        if self.accept_kw("NOT"):
            return self._not_expr().not_()
        return self._primary_cond()

    def _parse_in(self, col: str) -> Condition:
        self.expect_punct("(")
        if self.at_kw("SELECT"):
            sub = self._subselect()
            return Condition("in", col, sub)
        vals = [self.value()]
        while self.accept_punct(","):
            vals.append(self.value())
        self.expect_punct(")")
        return Condition.in_(col, vals)

    def _primary_cond(self) -> Condition:
        if self.at_kw("EXISTS") and self.peek(1).kind == "punct" \
                and self.peek(1).text == "(":
            self.next()
            self.next()
            return Condition("exists", value=self._subselect())
        if self.accept_punct("("):
            c = self._or_expr()
            self.expect_punct(")")
            return c
        t = self.peek()
        col = self.ident("column name")
        # HAVING may compare aggregate results: COUNT(*) / SUM(col) ...
        if self._allow_aggs and col.upper() in (
                "COUNT", "SUM", "AVG", "MIN", "MAX") and self.at_punct("("):
            self.next()
            arg = "*" if self.accept_punct("*") else self.ident()
            self.expect_punct(")")
            col = f"{col.lower()}({arg})"
        # dotted names (table.col)
        while self.at_punct("."):
            self.next()
            col = f"{col}.{self.ident('column name')}"
        if self.accept_kw("IS"):
            if self.accept_kw("NOT"):
                self.expect_kw("NULL")
                return Condition.is_not_null(col)
            self.expect_kw("NULL")
            return Condition.is_null(col)
        if self.accept_kw("NOT"):
            if self.accept_kw("IN"):
                return self._parse_in(col).not_()
            if self.accept_kw("LIKE"):
                return Condition.like(
                    col, self.string("LIKE pattern")).not_()
            bad = self.peek()
            raise ParseError("expected IN or LIKE after NOT",
                             bad.line, bad.col)
        if self.accept_kw("IN"):
            return self._parse_in(col)
        if self.accept_kw("LIKE"):
            return Condition.like(col, self.string("LIKE pattern"))
        if self.accept_kw("BETWEEN"):
            lo = self.value()
            self.expect_kw("AND")
            hi = self.value()
            return Condition.cmp(col, ">=", lo).and_(
                Condition.cmp(col, "<=", hi))
        if self.cur.kind == "punct" and self.cur.text in _ARITH:
            # arithmetic LHS: `a + b > 5`, `price * qty >= total`
            from neumann_tpu_torch.lang.expr import Col as _Col

            ltree = self._expr_continue(_Col(col))
            return self._expr_cond_tail(ltree)
        op_tok = self.peek()
        if op_tok.kind != "punct" or op_tok.text not in (
                "=", "!=", "<>", "<", "<=", ">", ">="):
            raise ParseError(
                f"expected comparison after {col!r}, got "
                f"{op_tok.text or 'EOF'!r}", op_tok.line, op_tok.col)
        op = self.next().text
        if self._at_subquery():
            self.next()
            return Condition.cmp(col, op, self._subselect())
        t, t2 = self.peek(), self.peek(1)
        if ((t.kind == "punct" and t.text == "(")
                or (t.kind in ("number", "ident")
                    and t2.kind == "punct" and t2.text in _ARITH)):
            # arithmetic RHS: `a = b + 1`, `a > (2 * 3)`
            from neumann_tpu_torch.lang.expr import Col as _Col

            rtree = self._expr()
            cols = _tree_cols(rtree)
            if not cols:
                return Condition.cmp(col, op, rtree.evaluate({}))
            return Condition(
                {"<>": "!=", "==": "="}.get(op, op),
                expr=(_Col(col), rtree))
        return Condition.cmp(col, op, self.value())

    def _expr_continue(self, left):
        """Finish an arithmetic expression whose first factor is
        already parsed (precedence: * / % bind before + -)."""
        from neumann_tpu_torch.lang.expr import Bin

        while self.cur.kind == "punct" and self.cur.text in (
                "*", "/", "%"):
            op = self.next().text
            left = Bin(op, left, self._expr_factor())
        while self.cur.kind == "punct" and self.cur.text in ("+", "-"):
            op = self.next().text
            left = Bin(op, left, self._expr_term())
        return left

    def _expr_cond_tail(self, ltree) -> Condition:
        op_tok = self.peek()
        if op_tok.kind != "punct" or op_tok.text not in (
                "=", "!=", "<>", "<", "<=", ">", ">="):
            raise ParseError(
                f"expected comparison after expression, got "
                f"{op_tok.text or 'EOF'!r}", op_tok.line, op_tok.col)
        op = {"<>": "!=", "==": "="}.get(self.next().text)  \
            or op_tok.text
        rtree = self._expr()
        return Condition(op, expr=(ltree, rtree))

    # ======================================================================
    # statements
    # ======================================================================
    def statement(self) -> ast.Statement:
        t = self.peek()
        if t.kind == "eof" or self.at_punct(";"):
            return ast.Empty()
        if t.kind != "ident":
            raise ParseError(f"expected statement, got {t.text!r}",
                             t.line, t.col)
        kw = t.text.upper()
        handler = getattr(self, f"_stmt_{kw.lower()}", None)
        if handler is None:
            raise ParseError(f"unknown statement {t.text!r}", t.line, t.col)
        self.next()
        return handler()

    def _stmt_explain(self) -> ast.Statement:
        return ast.Explain(inner=self.statement())

    # -- SQL ----------------------------------------------------------------
    def _stmt_select(self) -> ast.Statement:
        distinct = bool(self.accept_kw("DISTINCT"))
        items: List[ast.SelectItem] = []
        while True:
            items.append(self._select_item())
            if not self.accept_punct(","):
                break
        self.expect_kw("FROM")
        table = self.ident("table name")
        aliases: Dict[str, str] = {}
        alias = self._maybe_alias()
        if alias:
            aliases[alias] = table
        joins: List[ast.JoinClause] = []
        while self.at_kw("JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS",
                         "NATURAL"):
            joins.append(self._join_clause(aliases))
        where = self.condition() if self.accept_kw("WHERE") else None
        group_by: List[str] = []
        having = None
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")

            def gb_ident():
                name = self.ident()
                while self.accept_punct("."):
                    name = f"{name}.{self.ident()}"
                return name

            group_by.append(gb_ident())
            while self.accept_punct(","):
                group_by.append(gb_ident())
            if self.accept_kw("HAVING"):
                having = self.condition(allow_aggs=True)
        order_by: List[Tuple] = []
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                col = self.ident()
                while self.accept_punct("."):
                    col = f"{col}.{self.ident()}"
                desc = False
                if self.accept_kw("DESC"):
                    desc = True
                else:
                    self.accept_kw("ASC")
                if self.accept_kw("NULLS"):
                    nulls_first = self.expect_kw("FIRST",
                                                 "LAST") == "FIRST"
                    order_by.append((col, desc, nulls_first))
                else:
                    order_by.append((col, desc))
                if not self.accept_punct(","):
                    break
        limit = None
        offset = 0
        while self.at_kw("LIMIT", "OFFSET"):     # either order
            if self.accept_kw("LIMIT"):
                limit = self.int_()
            else:
                self.expect_kw("OFFSET")
                offset = self.int_()
        stmt = ast.Select(table=table, items=items, where=where,
                          joins=joins, group_by=group_by, having=having,
                          order_by=order_by, limit=limit, offset=offset,
                          distinct=distinct)
        if aliases:
            _rewrite_aliases(stmt, aliases)
        return stmt

    def _select_item(self) -> ast.SelectItem:
        from neumann_tpu_torch.lang.expr import Col

        if self.at_punct("*"):
            self.next()
            return ast.SelectItem("*")
        t = self.peek()
        up = t.text.upper() if t.kind == "ident" else ""
        if up in ("COUNT", "SUM", "AVG", "MIN", "MAX") and \
                self.peek(1).kind == "punct" and self.peek(1).text == "(":
            self.next()
            self.next()
            distinct = bool(self.accept_kw("DISTINCT"))
            if self.at_punct("*"):
                if distinct:
                    t = self.cur
                    raise ParseError(
                        "DISTINCT requires a column, not *",
                        t.line, t.col)
                self.next()
                arg = "*"
            else:
                arg = self.ident()
                while self.accept_punct("."):    # qualified: SUM(e.sal)
                    arg = f"{arg}.{self.ident('column name')}"
            self.expect_punct(")")
            alias = self.ident() if self.accept_kw("AS") else None
            return ast.SelectItem(arg, agg=up.lower(), distinct=distinct,
                                  alias=alias)
        tree = self._expr()
        alias = self.ident() if self.accept_kw("AS") else None
        if isinstance(tree, Col):       # plain column: engine projects it
            return ast.SelectItem(tree.name, alias=alias)
        return ast.SelectItem(tree.label(), alias=alias, tree=tree)

    # -- scalar expressions (functions.md:83-160: arithmetic, CASE, CAST)
    def _expr(self):
        from neumann_tpu_torch.lang.expr import Bin

        left = self._expr_term()
        while self.peek().kind == "punct" and self.peek().text in "+-":
            op = self.next().text
            left = Bin(op, left, self._expr_term())
        return left

    def _expr_term(self):
        from neumann_tpu_torch.lang.expr import Bin

        left = self._expr_factor()
        while self.peek().kind == "punct" and \
                self.peek().text in ("*", "/", "%"):
            op = self.next().text
            left = Bin(op, left, self._expr_factor())
        return left

    def _expr_factor(self):
        from neumann_tpu_torch.lang.expr import Bin, Case, Cast, Col, Lit

        t = self.peek()
        if t.kind == "punct" and t.text == "(":
            self.next()
            e = self._expr()
            self.expect_punct(")")
            return e
        if t.kind == "punct" and t.text == "-":
            self.next()
            return Bin("-", Lit(0), self._expr_factor())
        if t.kind == "number":
            return Lit(self.next().value)
        if t.kind == "string":
            return Lit(self.next().value)
        if t.kind != "ident":
            raise ParseError(f"expected expression, got "
                             f"{t.text or 'EOF'!r}", t.line, t.col)
        up = t.text.upper()
        if up in ("TRUE", "FALSE"):
            self.next()
            return Lit(up == "TRUE")
        if up == "NULL":
            self.next()
            return Lit(None)
        if up == "CASE":
            self.next()
            whens = []
            while self.accept_kw("WHEN"):
                cond = self.condition()
                self.expect_kw("THEN")
                whens.append((cond, self._expr()))
            if not whens:
                raise ParseError("CASE requires at least one WHEN",
                                 t.line, t.col)
            else_ = self._expr() if self.accept_kw("ELSE") else None
            self.expect_kw("END")
            return Case(tuple(whens), else_)
        if up == "CAST":
            self.next()
            self.expect_punct("(")
            e = self._expr()
            self.expect_kw("AS")
            tt = self.peek()
            type_kw = self.ident("type").upper()
            if type_kw not in _TYPE_MAP:
                raise ParseError(f"unknown CAST type {type_kw}",
                                 tt.line, tt.col)
            if self.accept_punct("("):      # VARCHAR(20) etc.
                self.number()
                if self.accept_punct(","):
                    self.number()
                self.expect_punct(")")
            self.expect_punct(")")
            return Cast(e, _TYPE_MAP[type_kw])
        from neumann_tpu_torch.lang.expr import Func, function_arity, \
            known_function

        if known_function(up) and self.peek(1).kind == "punct" and \
                self.peek(1).text == "(":
            self.next()
            self.next()
            args = [self._expr()]
            while self.accept_punct(","):
                args.append(self._expr())
            self.expect_punct(")")
            lo, hi = function_arity(up)
            if not (lo <= len(args) <= hi):
                raise ParseError(
                    f"{up} takes {lo}"
                    + (f"-{hi}" if hi != lo else "")
                    + f" arguments, got {len(args)}", t.line, t.col)
            return Func(up.lower(), tuple(args))
        name = self.ident("column name")
        while self.at_punct("."):
            self.next()
            name = f"{name}.{self.ident()}"
        return Col(name)

    _ALIAS_STOP = ("JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS",
                   "NATURAL", "WHERE", "GROUP", "HAVING", "ORDER",
                   "LIMIT", "OFFSET", "ON", "AS", "USING")

    def _maybe_alias(self) -> Optional[str]:
        if self.accept_kw("AS"):
            return self.ident("alias")
        t = self.peek()
        if t.kind == "ident" and t.text.upper() not in self._ALIAS_STOP:
            return self.next().text
        return None

    def _join_clause(self, aliases: Optional[Dict[str, str]] = None
                     ) -> ast.JoinClause:
        how = "inner"
        if self.accept_kw("INNER"):
            how = "inner"
        elif self.accept_kw("LEFT"):
            how = "left"
            self.accept_kw("OUTER")
        elif self.accept_kw("RIGHT"):
            how = "right"
            self.accept_kw("OUTER")
        elif self.accept_kw("FULL"):
            how = "full"
            self.accept_kw("OUTER")
        elif self.accept_kw("CROSS"):
            how = "cross"
        elif self.accept_kw("NATURAL"):
            how = "natural"
        self.expect_kw("JOIN")
        table = self.ident("table name")
        if aliases is not None:
            alias = self._maybe_alias()
            if alias:
                aliases[alias] = table
        left_col = right_col = None
        using = None
        if how not in ("cross", "natural"):
            if self.accept_kw("USING"):
                self.expect_punct("(")
                using = [self.ident("join column")]
                while self.accept_punct(","):
                    using.append(self.ident("join column"))
                self.expect_punct(")")
                left_col = right_col = using[0]
            else:
                self.expect_kw("ON")
                a = self._qualified()
                self.expect_punct("=")
                b = self._qualified()
                left_col, right_col = a[1], b[1]
                # normalize sides: (left_table.col = right_table.col)
                if a[0] == table:
                    left_col, right_col = b[1], a[1]
        return ast.JoinClause(table=table, how=how, left_col=left_col,
                              right_col=right_col, using=using)

    def _qualified(self) -> Tuple[Optional[str], str]:
        name = self.ident()
        if self.accept_punct("."):
            return name, self.ident()
        return None, name

    def _stmt_insert(self) -> ast.Statement:
        self.expect_kw("INTO")
        table = self.ident("table name")
        columns = None
        if self.accept_punct("("):
            columns = [self.ident()]
            while self.accept_punct(","):
                columns.append(self.ident())
            self.expect_punct(")")
        if self.accept_kw("SELECT"):            # INSERT INTO t SELECT ...
            return ast.Insert(table=table, columns=columns,
                              select=self._stmt_select())
        self.expect_kw("VALUES")
        rows: List[List[object]] = []
        while True:
            self.expect_punct("(")
            row = [self.value()]
            while self.accept_punct(","):
                row.append(self.value())
            self.expect_punct(")")
            rows.append(row)
            if not self.accept_punct(","):
                break
        return ast.Insert(table=table, columns=columns, rows=rows)

    def _stmt_update(self) -> ast.Statement:
        table = self.ident("table name")
        self.expect_kw("SET")
        updates: Dict[str, object] = {}
        while True:
            col = self.ident()
            self.expect_punct("=")
            t, t2 = self.peek(), self.peek(1)
            if ((t.kind == "punct" and t.text == "(")
                    or (t.kind in ("number", "ident")
                        and t2.kind == "punct" and t2.text in _ARITH)):
                # expression RHS: SET a = a + 10, SET b = (x * 2)
                tree = self._expr()
                updates[col] = (tree.evaluate({})
                                if not _tree_cols(tree) else tree)
            else:
                updates[col] = self.value()
            if not self.accept_punct(","):
                break
        where = self.condition() if self.accept_kw("WHERE") else None
        return ast.Update(table=table, updates=updates, where=where)

    def _stmt_delete(self) -> ast.Statement:
        self.expect_kw("FROM")
        table = self.ident("table name")
        where = self.condition() if self.accept_kw("WHERE") else None
        return ast.Delete(table=table, where=where)

    def _stmt_create(self) -> ast.Statement:
        if self.accept_kw("TABLE"):
            return self._create_table()
        if self.accept_kw("UNIQUE"):
            self.expect_kw("INDEX")
            return self._create_index(unique=True)
        if self.accept_kw("INDEX"):
            return self._create_index(unique=False)
        if self.accept_kw("BTREE"):
            self.expect_kw("INDEX")
            return self._create_index(unique=False, btree=True)
        if self.accept_kw("COLLECTION"):
            return self._create_collection()
        t = self.peek()
        raise ParseError("expected TABLE, INDEX or COLLECTION after CREATE",
                         t.line, t.col)

    def _create_table(self) -> ast.Statement:
        if_not_exists = False
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            if_not_exists = True
        table = self.ident("table name")
        self.expect_punct("(")
        cols: List[ast.ColumnDef] = []
        checks: List[Condition] = []
        uniques: List[List[str]] = []

        def col_list() -> List[str]:
            self.expect_punct("(")
            names = [self.ident("column name")]
            while self.accept_punct(","):
                names.append(self.ident("column name"))
            self.expect_punct(")")
            return names

        while True:
            # table-level constraints (query-language.md: PRIMARY KEY /
            # UNIQUE / FOREIGN KEY / CHECK after the column defs)
            if self.accept_kw("CONSTRAINT"):
                self.ident("constraint name")   # named; name unused
            if self.at_kw("PRIMARY"):
                self.next()
                self.expect_kw("KEY")
                pk_cols = col_list()
                if len(pk_cols) == 1:
                    for c in cols:
                        if c.name == pk_cols[0]:
                            c.primary_key = True
                            c.nullable = False
                else:
                    uniques.append(pk_cols)
                    for c in cols:
                        if c.name in pk_cols:
                            c.nullable = False
            elif self.at_kw("UNIQUE") and self.peek(1).kind == "punct" \
                    and self.peek(1).text == "(":
                self.next()
                u_cols = col_list()
                if len(u_cols) == 1:
                    for c in cols:
                        if c.name == u_cols[0]:
                            c.unique = True
                else:
                    uniques.append(u_cols)
            elif self.at_kw("FOREIGN"):
                self.next()
                self.expect_kw("KEY")
                fk_cols = col_list()
                self.expect_kw("REFERENCES")
                ref = self._references_clause()
                if len(fk_cols) != 1:
                    t = self.peek()
                    raise ParseError(
                        "composite FOREIGN KEY is not supported",
                        t.line, t.col)
                for c in cols:
                    if c.name == fk_cols[0]:
                        c.references = ref
            elif self.at_kw("CHECK"):
                self.next()
                self.expect_punct("(")
                checks.append(self.condition())
                self.expect_punct(")")
            else:
                cols.append(self._column_def())
            if not self.accept_punct(","):
                break
        self.expect_punct(")")
        return ast.CreateTable(table=table, columns=cols,
                               if_not_exists=if_not_exists,
                               checks=checks, uniques=uniques)

    def _column_def(self) -> ast.ColumnDef:
        name = self.ident("column name")
        t = self.peek()
        type_kw = self.ident("column type").upper()
        if type_kw not in _TYPE_MAP:
            raise ParseError(f"unknown column type {type_kw}",
                             t.line, t.col)
        if self.accept_punct("("):  # VARCHAR(255), DECIMAL(10,2)
            self.number()
            if self.accept_punct(","):
                self.number()
            self.expect_punct(")")
        col = ast.ColumnDef(name=name, ctype=_TYPE_MAP[type_kw])
        while True:
            if self.accept_kw("NOT"):
                self.expect_kw("NULL")
                col.nullable = False
            elif self.accept_kw("NULL"):
                col.nullable = True
            elif self.accept_kw("UNIQUE"):
                col.unique = True
            elif self.accept_kw("PRIMARY"):
                self.expect_kw("KEY")
                col.primary_key = True
                col.nullable = False
            elif self.accept_kw("DEFAULT"):
                col.default = self.value()
            elif self.accept_kw("CHECK"):
                self.expect_punct("(")
                col.check = self.condition()
                self.expect_punct(")")
            elif self.accept_kw("REFERENCES"):
                col.references = self._references_clause()
            else:
                break
        return col

    def _fk_action(self) -> str:
        if self.accept_kw("CASCADE"):
            return "cascade"
        if self.accept_kw("RESTRICT"):
            return "restrict"
        if self.accept_kw("SET"):
            if self.accept_kw("DEFAULT"):
                return "set_default"
            self.expect_kw("NULL")
            return "set_null"
        self.expect_kw("NO")
        self.expect_kw("ACTION")
        return "restrict"   # NO ACTION == RESTRICT here (no deferral)

    def _references_clause(self) -> tuple:
        """REFERENCES table(col) [ON DELETE act] [ON UPDATE act] ->
        (table, col, on_delete, on_update)."""
        rtable = self.ident("referenced table")
        self.expect_punct("(")
        rcol = self.ident("referenced column")
        self.expect_punct(")")
        on_delete = on_update = "restrict"
        while self.accept_kw("ON"):
            if self.accept_kw("DELETE"):
                on_delete = self._fk_action()
            else:
                self.expect_kw("UPDATE")
                on_update = self._fk_action()
        return (rtable, rcol, on_delete, on_update)

    def _create_index(self, unique: bool, btree: bool = False
                      ) -> ast.Statement:
        name = None
        if not self.at_kw("ON"):
            name = self.ident("index name")
        self.expect_kw("ON")
        table = self.ident("table name")
        self.expect_punct("(")
        columns = [self.ident()]
        while self.accept_punct(","):
            columns.append(self.ident())
        self.expect_punct(")")
        return ast.CreateIndex(table=table, columns=columns, name=name,
                               unique=unique, btree=btree)

    def _create_collection(self) -> ast.Statement:
        name = self.ident("collection name")
        stmt = ast.CreateCollection(name=name)
        while True:
            if self.accept_kw("DIMENSION", "DIM"):
                stmt.dimension = self.int_()
            elif self.accept_kw("METRIC"):
                m = self.ident().upper()
                stmt.metric = _METRIC_MAP.get(m, m.lower())
            elif self.accept_kw("QUANTIZATION", "QUANT"):
                stmt.quantization = self.ident().lower()
            else:
                break
        return stmt

    def _stmt_drop(self) -> ast.Statement:
        if self.accept_kw("TABLE"):
            if_exists = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                if_exists = True
            table = self.ident("table name")
            self.accept_kw("CASCADE")
            return ast.DropTable(table=table, if_exists=if_exists)
        if self.accept_kw("INDEX"):
            if_exists = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                if_exists = True
            if self.accept_kw("ON"):
                table = self.ident()
                self.expect_punct("(")
                column = self.ident()
                self.expect_punct(")")
                return ast.DropIndex(table=table, column=column,
                                     if_exists=if_exists)
            return ast.DropIndex(name=self.ident("index name"),
                                 if_exists=if_exists)
        if self.accept_kw("COLLECTION"):
            return ast.DropCollection(name=self.ident("collection name"))
        t = self.peek()
        raise ParseError("expected TABLE, INDEX or COLLECTION after DROP",
                         t.line, t.col)

    def _stmt_show(self) -> ast.Statement:
        if self.accept_kw("TABLES"):
            return ast.ShowTables()
        if self.accept_kw("EMBEDDINGS"):
            limit = self.int_() if self.accept_kw("LIMIT") else None
            return ast.ShowEmbeddings(limit=limit)
        if self.accept_kw("COLLECTIONS"):
            return ast.ShowCollections()
        if self.accept_kw("VECTOR"):
            self.expect_kw("INDEX")
            return ast.ShowCollections()
        if self.accept_kw("CODEBOOK"):
            if self.accept_kw("GLOBAL"):
                return ast.Chain(action="show_codebook_global")
            self.expect_kw("LOCAL")
            return ast.Chain(action="show_codebook_local",
                             key=self.string("codebook domain"))
        t = self.peek()
        raise ParseError(
            "expected TABLES, EMBEDDINGS, COLLECTIONS or CODEBOOK",
            t.line, t.col)

    def _stmt_analyze(self) -> ast.Statement:
        self.expect_kw("CODEBOOK")
        self.expect_kw("TRANSITIONS")
        return ast.Chain(action="analyze_transitions")

    def _stmt_describe(self) -> ast.Statement:
        target = "table"
        if self.accept_kw("TABLE"):
            target = "table"
        elif self.accept_kw("NODE"):
            target = "node"
        elif self.accept_kw("EDGE"):
            target = "edge"
        return ast.Describe(target=target, name=self.ident("name"))

    def _stmt_count(self) -> ast.Statement:
        self.expect_kw("EMBEDDINGS")
        return ast.CountEmbeddings()

    # -- graph ----------------------------------------------------------------
    def _stmt_node(self) -> ast.Statement:
        act = self.expect_kw("CREATE", "GET", "DELETE", "LIST")
        if act == "CREATE":
            label = self.ident("node label")
            props = self.property_map() if self.at_punct("{") else {}
            return ast.NodeCreate(label=label, properties=props)
        if act == "GET":
            return ast.NodeGet(node_id=self.value())
        if act == "DELETE":
            return ast.NodeDelete(node_id=self.value())
        label = None
        if self.peek().kind in ("ident", "string") and \
                not self.at_kw("LIMIT", "OFFSET"):
            label = self.ident()
        limit = self.int_() if self.accept_kw("LIMIT") else None
        offset = self.int_() if self.accept_kw("OFFSET") else 0
        return ast.NodeList(label=label, limit=limit, offset=offset)

    def _stmt_edge(self) -> ast.Statement:
        act = self.expect_kw("CREATE", "GET", "DELETE", "LIST")
        if act == "CREATE":
            src = self.value()
            self.expect_punct("->")
            dst = self.value()
            if self.accept_punct(":"):
                etype = self.ident("edge type")
            else:
                etype = self.ident("edge type")
            props = self.property_map() if self.at_punct("{") else {}
            return ast.EdgeCreate(src=src, dst=dst, edge_type=etype,
                                  properties=props)
        if act == "GET":
            return ast.EdgeGet(edge_id=self.value())
        if act == "DELETE":
            return ast.EdgeDelete(edge_id=self.value())
        etype = None
        if self.peek().kind in ("ident", "string") and \
                not self.at_kw("LIMIT", "OFFSET"):
            etype = self.ident()
        limit = self.int_() if self.accept_kw("LIMIT") else None
        offset = self.int_() if self.accept_kw("OFFSET") else 0
        return ast.EdgeList(edge_type=etype, limit=limit, offset=offset)

    def _stmt_neighbors(self) -> ast.Statement:
        node_id = self.value()
        stmt = ast.Neighbors(node_id=node_id)
        if self.accept_kw("OUTGOING", "OUT"):
            stmt.direction = "out"
        elif self.accept_kw("INCOMING", "IN"):
            stmt.direction = "in"
        elif self.accept_kw("BOTH"):
            stmt.direction = "both"
        if self.accept_punct(":"):
            stmt.edge_type = self.ident("edge type")
        if self.accept_kw("BY"):
            self.expect_kw("SIMILARITY", "SIMILAR")
            if self.at_punct("["):
                stmt.by_similarity = self.vector()
            else:
                stmt.by_similarity = []  # use node's own embedding
        if self.accept_kw("LIMIT"):
            stmt.limit = self.int_()
        return stmt

    def _stmt_path(self) -> ast.Statement:
        mode = "shortest"
        if self.accept_kw("SHORTEST"):
            mode = "shortest"
        elif self.accept_kw("ALL"):
            mode = "all"
        elif self.accept_kw("WEIGHTED"):
            mode = "weighted"
        elif self.accept_kw("ALL_WEIGHTED"):
            mode = "weighted"
        elif self.accept_kw("VARIABLE"):
            mode = "variable"
        src = self.value()
        self.expect_kw("TO")
        dst = self.value()
        stmt = ast.Path(mode=mode, src=src, dst=dst)
        while True:
            if self.accept_kw("MAX_DEPTH"):
                stmt.max_depth = self.int_()
            elif self.accept_kw("MIN_DEPTH"):
                stmt.min_depth = self.int_()
            elif self.accept_kw("WEIGHT"):
                stmt.weight = self.ident("weight property")
            else:
                break
        return stmt

    def _stmt_pagerank(self) -> ast.Statement:
        stmt = ast.PageRank()
        while True:
            if self.accept_kw("DAMPING"):
                stmt.damping = float(self.number())
            elif self.accept_kw("MAX_ITERATIONS") or \
                    self.accept_kw("ITERATIONS"):
                stmt.max_iterations = self.int_()
            elif self.accept_kw("TOLERANCE"):
                self.number()  # accepted, fixed-iteration kernel
            elif self.accept_kw("OUTGOING") or self.accept_kw("INCOMING") \
                    or self.accept_kw("BOTH"):
                pass  # reference direction flag; kernel runs over all edges
            elif self.accept_kw("EDGE"):
                self.expect_kw("TYPE")
                self.ident()  # accepted; kernel runs over all edges
            else:
                break
        return stmt

    def _graph_algorithm(self, name: str, numeric_params) -> ast.Statement:
        """Algorithm parameter tail.

        Accepts both our spellings (SAMPLING_RATIO, MAX_ITERATIONS,
        MAX_PASSES, DIRECTION OUTGOING, EDGE_TYPE t) and the reference
        grammar's (SAMPLING, ITERATIONS, PASSES, bare OUTGOING/INCOMING/
        BOTH, EDGE TYPE t — parser.rs:2407-2560).
        """
        stmt = ast.GraphAlgorithm(name=name)
        while True:
            matched = False
            for kw, key, conv in numeric_params:
                if self.accept_kw(kw):
                    stmt.params[key] = conv(self.number())
                    matched = True
                    break
            if not matched:
                if self.accept_kw("DIRECTION"):
                    d = self.expect_kw("OUTGOING", "INCOMING", "BOTH")
                    stmt.params["direction"] = {
                        "OUTGOING": "out", "INCOMING": "in",
                        "BOTH": "both"}[d]
                elif self.accept_kw("OUTGOING"):
                    stmt.params["direction"] = "out"
                elif self.accept_kw("INCOMING"):
                    stmt.params["direction"] = "in"
                elif self.accept_kw("BOTH"):
                    stmt.params["direction"] = "both"
                elif self.accept_kw("EDGE_TYPE"):
                    stmt.params["edge_type"] = self.ident()
                elif self.accept_kw("EDGE"):
                    self.expect_kw("TYPE")
                    stmt.params["edge_type"] = self.ident()
                else:
                    break
        return stmt

    def _stmt_betweenness(self) -> ast.Statement:
        self.accept_kw("CENTRALITY")
        return self._graph_algorithm("betweenness", [
            ("SAMPLING_RATIO", "sampling_ratio", float),
            ("SAMPLING", "sampling_ratio", float)])

    def _stmt_closeness(self) -> ast.Statement:
        self.accept_kw("CENTRALITY")
        return self._graph_algorithm("closeness", [])

    def _stmt_eigenvector(self) -> ast.Statement:
        self.accept_kw("CENTRALITY")
        return self._graph_algorithm("eigenvector", [
            ("MAX_ITERATIONS", "max_iterations", int),
            ("ITERATIONS", "max_iterations", int),
            ("TOLERANCE", "tol", float)])

    def _stmt_louvain(self) -> ast.Statement:
        self.accept_kw("COMMUNITIES")
        return self._graph_algorithm("louvain", [
            ("RESOLUTION", "resolution", float),
            ("MAX_PASSES", "max_passes", int),
            ("PASSES", "max_passes", int)])

    def _stmt_label_propagation(self) -> ast.Statement:
        return self._graph_algorithm("label_propagation", [
            ("MAX_ITERATIONS", "max_iterations", int),
            ("ITERATIONS", "max_iterations", int)])

    def _stmt_graph(self) -> ast.Statement:
        # Reference grammar routes graph algorithms through GRAPH
        # (parser.rs:2337-2356): GRAPH PAGERANK / BETWEENNESS CENTRALITY /
        # CLOSENESS CENTRALITY / EIGENVECTOR CENTRALITY / LOUVAIN
        # COMMUNITIES / LABEL PROPAGATION.
        if self.accept_kw("PAGERANK"):
            return self._stmt_pagerank()
        if self.accept_kw("BETWEENNESS"):
            return self._stmt_betweenness()
        if self.accept_kw("CLOSENESS"):
            return self._stmt_closeness()
        if self.accept_kw("EIGENVECTOR"):
            return self._stmt_eigenvector()
        if self.accept_kw("LOUVAIN"):
            return self._stmt_louvain()
        if self.accept_kw("LABEL"):
            self.expect_kw("PROPAGATION")
            return self._stmt_label_propagation()
        if self.accept_kw("CONSTRAINT"):
            return self._graph_constraint()
        if self.accept_kw("INDEX"):
            return self._graph_index()
        if self.accept_kw("PATTERN"):
            return self._graph_pattern()
        if self.accept_kw("BATCH"):
            return self._graph_batch()
        self.expect_kw("AGGREGATE")
        func = self.expect_kw("COUNT", "SUM", "AVG", "MIN", "MAX").lower()
        stmt = ast.GraphAggregate(func=func)
        target = self.expect_kw("NODES", "EDGES", "NODE", "EDGE")
        if target in ("NODES", "EDGES"):
            stmt.target = target.lower()
            if self.peek().kind in ("ident", "string") and \
                    not self.at_kw("WHERE"):
                stmt.label = self.ident()
        else:
            stmt.target = target.lower() + "s"
            stmt.prop = self.ident("property")
            if self.peek().kind in ("ident", "string") and \
                    not self.at_kw("WHERE"):
                stmt.label = self.ident()
        if self.accept_kw("WHERE"):
            stmt.where = self.condition()
        return stmt

    def _graph_constraint(self) -> ast.Statement:
        """Both our compact form (CONSTRAINT CREATE c ON NODE (label)
        prop UNIQUE) and the reference's (CONSTRAINT CREATE c ON NODE
        [label] PROPERTY prop UNIQUE|EXISTS|TYPE t —
        parser.rs:2701-2775) parse."""
        act = self.expect_kw("CREATE", "DROP", "LIST", "GET")
        if act == "LIST":
            return ast.GraphConstraint(action="list")
        if act in ("DROP", "GET"):
            return ast.GraphConstraint(action=act.lower(),
                                       name=self.ident("constraint name"))
        name = self.ident("constraint name")
        self.expect_kw("ON")
        target = self.expect_kw("NODE", "EDGE").lower()
        label = None
        if self.accept_punct("("):
            label = self.ident("label")
            self.expect_punct(")")
            self.accept_kw("PROPERTY")
            prop = self.ident("property")
        elif self.at_kw("PROPERTY"):
            self.next()
            prop = self.ident("property")
        else:
            # one ident = prop; ident then PROPERTY = label; two
            # idents = label + prop
            first = self.ident("label or property")
            if self.accept_kw("PROPERTY"):
                label, prop = first, self.ident("property")
            elif self.peek().kind in ("ident", "string") and \
                    not self.at_kw("UNIQUE", "EXISTS", "TYPE"):
                label, prop = first, self.ident("property")
            else:
                prop = first
        kind = self.expect_kw("UNIQUE", "EXISTS", "TYPE").lower()
        vtype = self.ident("value type") if kind == "type" else None
        return ast.GraphConstraint(action="create", name=name,
                                   target=target, label=label,
                                   prop=prop, kind=kind, vtype=vtype)

    def _graph_index(self) -> ast.Statement:
        # Both our compact form (GRAPH INDEX CREATE NODE PROPERTY p) and
        # the reference's (GRAPH INDEX CREATE ON NODE PROPERTY p /
        # ON EDGE TYPE / ON LABEL — parser.rs:2589-2690) parse.
        act = self.expect_kw("CREATE", "DROP", "SHOW")
        self.accept_kw("ON")
        if act == "SHOW":
            target = self.expect_kw("NODE", "EDGE").lower()
            return ast.GraphIndex(action="show", target=target)
        target = self.expect_kw("NODE", "EDGE", "LABEL",
                                "EDGE_TYPE").lower()
        prop = None
        if target == "edge" and self.accept_kw("TYPE"):
            target = "edge_type"
        elif target in ("node", "edge"):
            if act == "CREATE":
                self.expect_kw("PROPERTY")
            else:
                self.accept_kw("PROPERTY")
            prop = self.ident("property")
        return ast.GraphIndex(action=act.lower(), target=target,
                              prop=prop)

    def _graph_pattern(self) -> ast.Statement:
        mode = self.expect_kw("MATCH", "COUNT", "EXISTS").lower()
        # capture the raw pattern text between parens for the cypher
        # pattern parser (balanced parens)
        t = self.peek()
        if not self.at_punct("("):
            raise ParseError("expected ( pattern )", t.line, t.col)
        depth = 0
        parts = []
        while True:
            tok = self.peek()
            if tok.kind == "eof":
                raise ParseError("unterminated pattern", tok.line, tok.col)
            if tok.kind == "ident" and tok.text.upper() == "LIMIT" and                     depth == 0:
                break
            self.next()
            if tok.kind == "punct" and tok.text == "(":
                depth += 1
            elif tok.kind == "punct" and tok.text == ")":
                depth -= 1
            if tok.kind == "string":
                parts.append(f"'{tok.value}'")
            else:
                parts.append(tok.text)
            if depth == 0 and tok.kind == "punct" and tok.text == ")":
                nxt = self.peek()
                # pattern continues with a relationship?
                if not (nxt.kind == "punct" and nxt.text in
                        ("-", "<", "->")):
                    break
        limit = self.int_() if self.accept_kw("LIMIT") else None
        return ast.GraphPattern(mode=mode, pattern=" ".join(parts),
                                limit=limit)

    def _graph_batch(self) -> ast.Statement:
        act = self.expect_kw("CREATE", "DELETE", "UPDATE")
        target = self.expect_kw("NODES", "EDGES").lower()
        self.expect_punct("[")
        items = []
        if act == "CREATE" and target == "nodes":
            while not self.at_punct("]"):
                self.expect_punct("(")
                label = self.ident("label")
                props = self.property_map() if self.at_punct("{") else {}
                self.expect_punct(")")
                items.append((label, props))
                if not self.accept_punct(","):
                    break
            action = "create_nodes"
        elif act == "CREATE":
            while not self.at_punct("]"):
                self.expect_punct("(")
                src = self.value()
                self.expect_punct("->")
                dst = self.value()
                self.expect_punct(":")
                etype = self.ident("edge type")
                props = self.property_map() if self.at_punct("{") else {}
                self.expect_punct(")")
                items.append((src, dst, etype, props))
                if not self.accept_punct(","):
                    break
            action = "create_edges"
        elif act == "UPDATE":
            while not self.at_punct("]"):
                self.expect_punct("(")
                nid = self.value()
                props = self.property_map()
                self.expect_punct(")")
                items.append((nid, props))
                if not self.accept_punct(","):
                    break
            action = "update_nodes"
        else:
            while not self.at_punct("]"):
                items.append(self.value())
                if not self.accept_punct(","):
                    break
            action = f"delete_{target}"
        self.expect_punct("]")
        return ast.GraphBatch(action=action, items=items)

    # -- reference top-level graph statements ---------------------------------
    # The reference routes these without a GRAPH prefix
    # (parser.rs:736-739): CONSTRAINT …, BATCH …, AGGREGATE ….

    def _stmt_constraint(self) -> ast.Statement:
        return self._graph_constraint()

    def _stmt_batch(self) -> ast.Statement:
        """Reference batch grammar (parser.rs:2807-3060): brace-map
        items instead of our GRAPH BATCH tuple items.

        BATCH CREATE NODES [{labels: [a, b], k: v, …}, …]
        BATCH CREATE EDGES [{from: i, to: j, type: t, …props}, …]
        BATCH DELETE NODES|EDGES id, id, …
        BATCH UPDATE NODES [{id: i, k: v, …}, …]
        """
        act = self.expect_kw("CREATE", "DELETE", "UPDATE")
        target = self.expect_kw("NODES", "EDGES", "NODE", "EDGE").lower()
        target = target if target.endswith("s") else target + "s"
        if act == "DELETE":
            ids = [self.value()]
            while self.accept_punct(","):
                ids.append(self.value())
            return ast.GraphBatch(action=f"delete_{target}", items=ids)
        items = []
        self.expect_punct("[")
        while not self.at_punct("]"):
            items.append(self._batch_brace_item())
            if not self.accept_punct(","):
                break
        self.expect_punct("]")
        if act == "UPDATE":
            out = []
            for t_it, props in items:
                if "id" not in props:
                    raise ParseError("missing 'id' in node update",
                                     t_it.line, t_it.col)
                nid = props.pop("id")
                out.append((nid, props))
            return ast.GraphBatch(action="update_nodes", items=out)
        if target == "nodes":
            out = []
            for t_it, props in items:
                labels = props.pop("labels", [])
                if isinstance(labels, str):
                    labels = [labels]
                label = labels[0] if labels else props.pop("label", "")
                if len(labels) > 1:
                    props["labels"] = labels
                out.append((label, props))
            return ast.GraphBatch(action="create_nodes", items=out)
        out = []
        for t_it, props in items:
            missing = [k for k in ("from", "to", "type")
                       if k not in props]
            if missing:
                raise ParseError(
                    f"missing '{missing[0]}' in edge definition",
                    t_it.line, t_it.col)
            out.append((props.pop("from"), props.pop("to"),
                        props.pop("type"), props))
        return ast.GraphBatch(action="create_edges", items=out)

    def _batch_brace_item(self):
        """One `{…}` batch item; `labels:` takes a bare-ident list."""
        t = self.peek()
        self.expect_punct("{")
        props: Dict[str, object] = {}
        if not self.at_punct("}"):
            while True:
                key = self.ident("property name")
                self.expect_punct(":")
                if key == "labels" and self.at_punct("["):
                    self.expect_punct("[")
                    labels = []
                    while not self.at_punct("]"):
                        labels.append(self.value())
                        if not self.accept_punct(","):
                            break
                    self.expect_punct("]")
                    props[key] = labels
                else:
                    props[key] = self.value()
                if not self.accept_punct(","):
                    break
        self.expect_punct("}")
        return t, props

    def _stmt_aggregate(self) -> ast.Statement:
        """AGGREGATE NODE|EDGE PROPERTY p FUNC [BY LABEL l | BY TYPE t]
        [WHERE cond] (parser.rs:3081-3150)."""
        target = self.expect_kw("NODE", "EDGE").lower() + "s"
        self.expect_kw("PROPERTY")
        prop = self.ident("property")
        func = self.expect_kw("SUM", "AVG", "MIN", "MAX",
                              "COUNT").lower()
        stmt = ast.GraphAggregate(func=func, target=target, prop=prop)
        if self.accept_kw("BY"):
            self.expect_kw("LABEL") if target == "nodes" \
                else self.expect_kw("TYPE")
            stmt.label = self.ident()
        if self.accept_kw("WHERE"):
            stmt.where = self.condition()
        return stmt

    # -- vector ---------------------------------------------------------------
    def _stmt_embed(self) -> ast.Statement:
        if self.accept_kw("STORE"):
            key = self.string("embedding key")
            vec = self.vector()
            coll = self.ident() if self.accept_kw("IN") else None
            return ast.EmbedStore(key=key, vector=vec, collection=coll)
        if self.accept_kw("GET"):
            key = self.string("embedding key")
            coll = self.ident() if self.accept_kw("IN") else None
            return ast.EmbedGet(key=key, collection=coll)
        if self.accept_kw("DELETE"):
            key = self.string("embedding key")
            coll = self.ident() if self.accept_kw("IN") else None
            return ast.EmbedDelete(key=key, collection=coll)
        if self.accept_kw("BATCH"):
            self.expect_punct("[")
            items = []
            while not self.at_punct("]"):
                self.expect_punct("(")
                key = self.string("key")
                self.expect_punct(",")
                vec = self.vector()
                self.expect_punct(")")
                items.append((key, vec))
                if not self.accept_punct(","):
                    break
            self.expect_punct("]")
            coll = self.ident() if self.accept_kw("IN") else None
            return ast.EmbedBatch(items=items, collection=coll)
        if self.accept_kw("BUILD"):
            self.expect_kw("INDEX")
            coll = self.ident() if self.accept_kw("IN") else None
            return ast.Empty()  # exact scan needs no index build
        # bare EMBED 'key' [vec] (README short form)
        key = self.string("embedding key")
        vec = self.vector()
        coll = self.ident() if self.accept_kw("IN") else None
        return ast.EmbedStore(key=key, vector=vec, collection=coll)

    def _stmt_similar(self) -> ast.Statement:
        stmt = ast.Similar()
        if self.at_punct("["):
            stmt.query_vector = self.vector()
        else:
            stmt.query_key = self.string("key or [vector]")
        while True:
            if self.accept_kw("TOP", "LIMIT"):
                stmt.limit = self.int_()
            elif self.accept_kw("METRIC"):
                m = self.ident("metric").upper()
                if m not in _METRIC_MAP:
                    t = self.peek()
                    raise ParseError(f"unknown metric {m}", t.line, t.col)
                stmt.metric = _METRIC_MAP[m]
            elif self.accept_kw("COSINE"):
                stmt.metric = "cosine"  # bare metric kw, parser.rs:1888
            elif self.accept_kw("EUCLIDEAN"):
                stmt.metric = "euclidean"
            elif self.accept_kw("DOTPRODUCT") or \
                    self.accept_kw("DOT_PRODUCT"):
                stmt.metric = "dot"
            elif self.accept_kw("CONNECTED"):
                self.expect_kw("TO")
                stmt.connected_to = self.string("entity key")
            elif self.accept_kw("IN") or self.accept_kw("INTO"):
                stmt.collection = self.ident("collection")
            elif self.accept_kw("WHERE"):
                stmt.where = self.condition()
            else:
                break
        return stmt

    # -- unified ---------------------------------------------------------------
    def _stmt_entity(self) -> ast.Statement:
        act = self.expect_kw("CREATE", "GET", "UPDATE", "DELETE",
                             "CONNECT", "BATCH")
        if act == "BATCH":
            self.expect_kw("CREATE")
            self.expect_punct("[")
            items = []
            if not self.at_punct("]"):
                while True:
                    t = self.peek()
                    props = self.property_map()
                    if "key" not in props:
                        raise ParseError(
                            "each batch entity needs a 'key' property",
                            t.line, t.col)
                    items.append(props)
                    if not self.accept_punct(","):
                        break
            self.expect_punct("]")
            return ast.EntityBatchCreate(items=items)
        if act in ("CREATE", "UPDATE"):
            key = self.string("entity key")
            props = self.property_map() if self.at_punct("{") else {}
            emb = None
            if self.accept_kw("EMBEDDING"):
                emb = self.vector()
            return ast.EntityCreate(key=key, properties=props,
                                    embedding=emb, update=(act == "UPDATE"))
        if act == "GET":
            return ast.EntityGet(key=self.string("entity key"))
        if act == "DELETE":
            return ast.EntityDelete(key=self.string("entity key"))
        src = self.string("entity key")
        self.expect_punct("->")
        dst = self.string("entity key")
        etype = "related"
        if self.accept_punct(":"):
            etype = self.ident("edge type")
        return ast.EntityConnect(src=src, dst=dst, edge_type=etype)

    def _stmt_find(self) -> ast.Statement:
        stmt = ast.Find()
        # Reference grammar (parser.rs:1925-1991): VERTEX aliases NODE,
        # and a bare FIND (pattern omitted) means all nodes.
        if self.at_kw("WHERE", "RETURN", "LIMIT") or \
                self.peek().kind == "eof":
            target = "NODE"
        else:
            target = self.expect_kw("NODE", "VERTEX", "EDGE", "ROWS",
                                    "ENTITY", "PATH")
            if target == "VERTEX":
                target = "NODE"
        stmt.target = target.lower()
        if target == "ROWS":
            self.expect_kw("FROM")
            stmt.label = self.ident("table name")
        elif target == "PATH":
            # FIND PATH from_label -[edge_type]-> to_label
            if self.peek().kind == "ident" and not self.at_punct("-"):
                stmt.path_from = self.ident()
            self.expect_punct("-")
            self.expect_punct("[")
            if not self.at_punct("]"):
                stmt.path_edge = self.ident("edge type")
            self.expect_punct("]")
            self.expect_punct("->")
            if self.peek().kind == "ident" and not self.at_kw(
                    "WHERE", "LIMIT"):
                stmt.path_to = self.ident()
        elif self.peek().kind in ("ident", "string") and not self.at_kw(
                "WHERE", "SIMILAR", "CONNECTED", "LIMIT", "RETURN"):
            stmt.label = self.ident()
        while True:
            if self.accept_kw("WHERE"):
                stmt.where = self.condition()
            elif self.accept_kw("SIMILAR"):
                self.expect_kw("TO")
                if self.at_punct("["):
                    stmt.similar_to = self.vector()
                else:
                    stmt.similar_to = self.string("key")
            elif self.accept_kw("CONNECTED"):
                self.expect_kw("TO")
                stmt.connected_to = self.string("key")
            elif self.accept_kw("RETURN"):
                items = []
                while True:
                    col = self.ident("return column")
                    alias = self.ident("alias") \
                        if self.accept_kw("AS") else col
                    items.append((col, alias))
                    if not self.accept_punct(","):
                        break
                stmt.return_items = items
            elif self.accept_kw("LIMIT"):
                stmt.limit = self.int_()
            else:
                break
        return stmt

    # -- vault / cache / blob ----------------------------------------------------
    def _stmt_vault(self) -> ast.Statement:
        act = self.expect_kw("INIT", "SET", "GET", "DELETE", "LIST",
                             "ROTATE", "GRANT", "REVOKE", "SEAL",
                             "UNSEAL", "HISTORY", "ROLLBACK", "AUDIT")
        stmt = ast.Vault(action=act.lower())
        if act == "HISTORY":
            stmt.key = self.string("secret key")
        elif act == "ROLLBACK":
            stmt.key = self.string("secret key")
        elif act == "AUDIT":
            if self.peek().kind == "number":
                stmt.pattern = str(self.int_())   # limit
        elif act == "UNSEAL":
            stmt.value = self.string("master password")
        elif act == "ROTATE" and self.accept_kw("MASTER"):
            stmt.action = "rotate_master"
            stmt.value = self.string("new master password")
        elif act == "SET" or act == "ROTATE":
            stmt.key = self.string("secret key")
            stmt.value = self.string("secret value")
        elif act in ("GET", "DELETE"):
            stmt.key = self.string("secret key")
        elif act == "LIST":
            if self.peek().kind == "string":
                stmt.pattern = self.string()
        elif act in ("GRANT", "REVOKE"):
            stmt.entity = self.string("entity")
            self.expect_kw("ON")
            stmt.key = self.string("secret key")
        return stmt

    def _stmt_cache(self) -> ast.Statement:
        if self.accept_kw("INIT"):
            return ast.Cache(action="init")
        if self.accept_kw("STATS"):
            return ast.Cache(action="stats")
        if self.accept_kw("CLEAR"):
            return ast.Cache(action="clear")
        if self.accept_kw("EVICT"):
            count = None
            if self.peek().kind == "number":
                count = self.int_()
            return ast.Cache(action="evict", count=count)
        if self.accept_kw("GET"):
            return ast.Cache(action="get", key=self.string("cache key"))
        if self.accept_kw("PUT"):
            return ast.Cache(action="put", key=self.string("cache key"),
                             value=self.string("cache value"))
        self.expect_kw("SEMANTIC")
        act = self.expect_kw("GET", "PUT")
        if act == "GET":
            stmt = ast.Cache(action="semantic_get",
                             key=self.string("query"))
            if self.accept_kw("THRESHOLD"):
                stmt.threshold = float(self.number())
            return stmt
        stmt = ast.Cache(action="semantic_put", key=self.string("query"),
                         value=self.string("response"))
        if self.accept_kw("EMBEDDING"):
            stmt.embedding = self.vector()
        return stmt

    def _stmt_blob(self) -> ast.Statement:
        act = self.expect_kw(
            "INIT", "PUT", "GET", "DELETE", "INFO", "LINK", "UNLINK",
            "LINKS", "TAG", "UNTAG", "VERIFY", "GC", "REPAIR", "STATS",
            "META")
        stmt = ast.Blob(action=act.lower())
        if act == "PUT":
            stmt.name = self.string("filename")
            # reference inline-data form: BLOB PUT 'name' 'data'
            # (parser.rs:3199-3211)
            if self.peek().kind == "string":
                stmt.data = self.string("data")
            while True:
                if self.accept_kw("DATA"):
                    stmt.data = self.string("data")
                elif self.accept_kw("FROM"):
                    stmt.path = self.string("path")
                elif self.accept_kw("TYPE"):
                    stmt.content_type = self.string("content type")
                elif self.accept_kw("BY"):
                    stmt.creator = self.string("creator")
                elif self.accept_kw("LINK"):
                    stmt.entity = self.string("entity")
                elif self.accept_kw("TAG"):
                    stmt.tag = self.string("tag")
                else:
                    break
        elif act == "GET":
            stmt.name = self.string("artifact id")
            if self.accept_kw("TO"):
                stmt.path = self.string("path")
        elif act in ("DELETE", "INFO", "LINKS", "VERIFY"):
            stmt.name = self.string("artifact id")
        elif act == "LINK":
            stmt.name = self.string("artifact id")
            self.expect_kw("TO")
            stmt.entity = self.string("entity")
        elif act == "UNLINK":
            stmt.name = self.string("artifact id")
            self.expect_kw("FROM")
            stmt.entity = self.string("entity")
        elif act in ("TAG", "UNTAG"):
            stmt.name = self.string("artifact id")
            stmt.tag = self.string("tag")
        elif act == "GC":
            stmt.full = bool(self.accept_kw("FULL"))
        elif act == "META":
            sub = self.expect_kw("SET", "GET")
            stmt.action = f"meta_{sub.lower()}"
            stmt.name = self.string("artifact id")
            stmt.meta_key = self.string("meta key")
            if sub == "SET":
                stmt.meta_value = self.string("meta value")
        return stmt

    def _stmt_blobs(self) -> ast.Statement:
        if self.accept_kw("FOR"):
            return ast.Blobs(mode="for", entity=self.string("entity"))
        if self.accept_kw("BY"):
            self.expect_kw("TAG")
            return ast.Blobs(mode="by_tag", tag=self.string("tag"))
        if self.accept_kw("WHERE"):
            self.expect_kw("TYPE")
            self.expect_punct("=")
            return ast.Blobs(mode="where_type",
                             content_type=self.string("content type"))
        if self.accept_kw("SIMILAR"):
            self.expect_kw("TO")
            stmt = ast.Blobs(mode="similar",
                             artifact=self.string("artifact id"))
            if self.accept_kw("LIMIT"):
                stmt.limit = self.int_()
            return stmt
        stmt = ast.Blobs(mode="all")
        if self.peek().kind == "string":
            stmt.pattern = self.string()
        return stmt

    # -- checkpoint / chain / cluster ---------------------------------------------
    def _stmt_checkpoint(self) -> ast.Statement:
        name = None
        if self.peek().kind == "string":
            name = self.string()
        return ast.Checkpoint(name=name)

    def _stmt_checkpoints(self) -> ast.Statement:
        limit = self.int_() if self.accept_kw("LIMIT") else None
        return ast.Checkpoints(limit=limit)

    def _stmt_rollback(self) -> ast.Statement:
        if self.accept_kw("CHAIN"):
            if self.accept_kw("TO"):
                return ast.Chain(action="rollback", height=self.int_())
            # bare ROLLBACK CHAIN: abort the open transaction
            self.accept_kw("TRANSACTION")   # optional symmetry
            return ast.Chain(action="abort")
        self.expect_kw("TO")
        return ast.Rollback(target=self.string("checkpoint"))

    def _stmt_begin(self) -> ast.Statement:
        self.expect_kw("CHAIN")
        self.accept_kw("TRANSACTION")    # optional, like the reference
        return ast.Chain(action="begin")

    def _stmt_commit(self) -> ast.Statement:
        self.expect_kw("CHAIN")
        self.accept_kw("TRANSACTION")       # optional symmetry with
        return ast.Chain(action="commit")   # BEGIN CHAIN TRANSACTION

    def _stmt_chain(self) -> ast.Statement:
        act = self.expect_kw("HEIGHT", "TIP", "BLOCK", "VERIFY", "HISTORY",
                             "SIMILAR", "DRIFT", "STATS")
        stmt = ast.Chain(action=act.lower())
        if act == "BLOCK":
            stmt.height = self.int_()
        elif act == "HISTORY":
            stmt.key = self.string("key")
        elif act == "SIMILAR":
            stmt.embedding = self.vector()
            if self.accept_kw("LIMIT"):
                stmt.limit = self.int_()
        elif act == "DRIFT":
            self.expect_kw("FROM")
            stmt.from_height = self.int_()
            self.expect_kw("TO")
            stmt.to_height = self.int_()
        return stmt

    def _stmt_cluster(self) -> ast.Statement:
        act = self.expect_kw("CONNECT", "DISCONNECT", "STATUS", "NODES",
                             "LEADER")
        stmt = ast.Cluster(action=act.lower())
        if act == "CONNECT":
            stmt.address = self.string("address")
        return stmt


_NP = None          # bound _neumann_parser.parse, or None
_NATIVE_TRIED = False


def _parse_python(src: str) -> ast.Statement:
    """The pure-Python recursive-descent path (also the native
    parser's registered fallback for uncovered grammar and every
    syntax error)."""
    p = _Parser(src)
    stmt = p.statement()
    while p.accept_punct(";"):
        pass
    t = p.peek()
    if t.kind != "eof":
        raise ParseError(f"unexpected trailing input {t.text!r}",
                         t.line, t.col)
    return stmt


def _native():
    global _NP, _NATIVE_TRIED, parse
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        from neumann_tpu_torch.native import pyparser

        mod = pyparser.load()
        _NP = mod.parse if mod is not None else None
        if mod is not None:
            # upgrade the module-level entry to the zero-frame C path
            # for importers that bind after this point
            mod.set_fallback(_parse_python)
            parse = mod.parse_full
    return _NP


def parse(src: str) -> ast.Statement:
    """Parse a single statement (trailing semicolon allowed).

    Hot statement shapes (SELECT / INSERT…VALUES / SIMILAR / NODE
    CREATE / FIND over plain conditions) go through the native parser
    (native/parser_ext.cpp), which builds identical AST objects ~15x
    faster; anything it does not cover — including every syntax
    error — falls through to the Python recursive-descent parser.
    When the extension is already built, module import rebinds this
    name to the C entry point (parse_full) so the hot path has no
    Python wrapper frame at all."""
    np = _NP if _NATIVE_TRIED else _native()
    if np is not None:
        stmt = np(src)
        if stmt is not None:
            return stmt
    return _parse_python(src)


@functools.lru_cache(maxsize=1024)
def parse_cached(src: str) -> ast.Statement:
    """Statement-cache variant of parse() (the router's entry point).

    Two cache tiers. Exact: repeated statements skip everything (the
    returned AST is SHARED across calls: executors treat statements as
    read-only; the one rewrite site uses dataclasses.replace). On an
    exact miss, the PARAMETERIZED tier kicks in: the statement's
    literals are stripped into a shape key, the AST template for that
    shape is cached once, and fresh literals substitute along the
    template's literal spine — so workloads whose statements differ
    only in values (bulk INSERTs, point lookups) cold-"parse" at
    template-substitution speed instead of full parse speed (the
    reference parses at native 1.9M/s, benchmarks/index.md:46)."""
    return parse_param(src)


# -- parameterized statement templates ----------------------------------
#
# Literal tokens are replaced by value-preserving marker subclasses
# (_IntLit(5) IS the int 5, plus a slot id), so the template parse
# behaves byte-for-byte like a real parse — any parser branch that
# inspects a literal's value sees the true value. After parsing, the
# AST is scanned for the markers; if every slot is found, a builder is
# compiled that reconstructs ONLY the spine from the root to each
# literal (all other subtrees are shared). If any slot vanished (value
# folded into an ndarray, arithmetic, string surgery), the shape is
# marked unparameterizable and always takes the direct parse.


class _IntLit(int):
    slot: int


class _FloatLit(float):
    slot: int


class _StrLit(str):
    slot: int


_MARKS = (_IntLit, _FloatLit, _StrLit)
_PLAIN = {_IntLit: int, _FloatLit: float, _StrLit: str}


def _mark(value, slot):
    if isinstance(value, bool):      # bool is int; never parameterize
        return None
    for mk in _MARKS:
        if type(value) is _PLAIN[mk]:
            m = mk(value)
            m.slot = slot
            return m
    return None


def _compile_subst(node, found):
    """Returns builder(vals)->subtree, or None when the subtree holds
    no markers (callers then share `node`). Records slots in `found`.
    Builders bypass dataclass __init__ (prototype __dict__ copy + hot
    field patch) — the whole point is to be much cheaper than parsing.
    """
    t = type(node)
    if t in _MARKS:
        found.add(node.slot)
        plain = _PLAIN[t]
        return lambda vals, i=node.slot, c=plain: c(vals[i])
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        subs = [(f.name, _compile_subst(getattr(node, f.name), found))
                for f in dataclasses.fields(node)]
        hot = [(n, b) for n, b in subs if b is not None]
        if not hot:
            return None
        cls = t
        if hasattr(node, "__dict__"):
            proto = dict(node.__dict__)

            def build(vals, cls=cls, proto=proto, hot=hot):
                obj = object.__new__(cls)
                d = obj.__dict__      # mutate in place: rebinding
                d.update(proto)       # __dict__ trips frozen __setattr__
                for n, b in hot:
                    d[n] = b(vals)
                return obj
        else:   # slotted dataclass: construct via kwargs
            def build(vals, cls=cls, node=node, subs=subs):
                return cls(**{n: (getattr(node, n) if b is None
                                  else b(vals)) for n, b in subs})
        return build
    if t is list or t is tuple:
        subs = [_compile_subst(x, found) for x in node]
        hot = [(i, b) for i, b in enumerate(subs) if b is not None]
        if not hot:
            return None
        if t is list:
            def build_seq(vals, node=node, hot=hot):
                out = list(node)
                for i, b in hot:
                    out[i] = b(vals)
                return out
        else:
            def build_seq(vals, node=node, hot=hot):
                out = list(node)
                for i, b in hot:
                    out[i] = b(vals)
                return tuple(out)
        return build_seq
    if t is dict:
        subs = {k: (_compile_subst(k, found), _compile_subst(v, found))
                for k, v in node.items()}
        if all(kb is None and vb is None
               for kb, vb in subs.values()):
            return None

        def build_map(vals, node=node, subs=subs):
            return {(k if subs[k][0] is None else subs[k][0](vals)):
                    (v if subs[k][1] is None else subs[k][1](vals))
                    for k, v in node.items()}
        return build_map
    return None


_UNPARAM = object()
_template_cache: Dict[tuple, object] = {}
_TEMPLATE_CACHE_MAX = 2048
# shape-key markers: one interned singleton per literal type (the key
# must distinguish INSERT .. (1) from (1.5) from ('1'))
_KI, _KF, _KS = "\x00i", "\x00f", "\x00s"
_LITKINDS = frozenset(("number", "string"))


def parse_param(src: str) -> ast.Statement:
    """parse() with the parameterized-template fast path. The hit path
    is one native shape() pass (key + literal values, no Token objects)
    plus a spine rebuild; tokens and template compilation only happen
    on a shape miss. Statements the native parser covers skip the
    template machinery entirely — a direct parse is faster than the
    rebuild."""
    np = _NP if _NATIVE_TRIED else _native()
    if np is not None:
        stmt = np(src)
        if stmt is not None:
            return stmt
    from neumann_tpu_torch.lang import lexer as _lx

    ext = _lx._EXT if _lx._EXT_TRIED else _lx._ext()
    if ext is not None and src.isascii():
        try:
            key, vals = ext.shape(src)
        except ValueError:
            return _parse_tokens(tokenize(src))  # full ParseError path
        if not vals:
            return _parse_tokens(tokenize(src))
        entry = _template_cache.get(key)
        if entry is not None:
            if entry is _UNPARAM:
                return _parse_tokens(tokenize(src))
            return entry(vals)
        toks = tokenize(src)
    else:
        toks = tokenize(src)
        key = tuple(
            (t.text if t.kind not in _LITKINDS
             else (_KS if t.kind == "string"
                   else (_KI if type(t.value) is int else _KF)))
            for t in toks)
        vals = [t.value for t in toks if t.kind in _LITKINDS]
        if not vals:
            return _parse_tokens(toks)
        entry = _template_cache.get(key)
        if entry is not None:
            if entry is _UNPARAM:
                return _parse_tokens(toks)
            return entry(vals)

    # template miss: parse once with value-preserving markers
    marked = []
    i = 0
    for t in toks:
        if t.kind in ("number", "string"):
            m = _mark(t.value, i)
            if m is None:          # exotic literal type
                _template_cache[key] = _UNPARAM
                return _parse_tokens(toks)
            marked.append(Token(t.kind, t.text, m, t.line, t.col))
            i += 1
        else:
            marked.append(t)
    stmt = _parse_tokens(marked)   # ParseError: don't cache
    found: set = set()
    builder = _compile_subst(stmt, found)
    if found != set(range(len(vals))) or builder is None:
        entry = _UNPARAM   # a literal vanished into the AST
    else:
        entry = builder
    if len(_template_cache) >= _TEMPLATE_CACHE_MAX:
        _template_cache.clear()
    _template_cache[key] = entry
    if entry is _UNPARAM:
        return _parse_tokens(toks)
    return stmt          # first hit: markers ARE the right values


def _parse_tokens(toks) -> ast.Statement:
    p = _Parser("", toks=toks)
    stmt = p.statement()
    while p.accept_punct(";"):
        pass
    t = p.peek()
    if t.kind != "eof":
        raise ParseError(f"unexpected trailing input {t.text!r}",
                         t.line, t.col)
    return stmt


def parse_many(src: str) -> List[ast.Statement]:
    """Parse a semicolon-separated list of statements."""
    p = _Parser(src)
    out: List[ast.Statement] = []
    while p.peek().kind != "eof":
        while p.accept_punct(";"):
            pass
        if p.peek().kind == "eof":
            break
        out.append(p.statement())
        while p.accept_punct(";"):
            pass
    return out


def _rewrite_aliases(stmt: "ast.Select", aliases: Dict[str, str]) -> None:
    """Replace alias-qualified names (u.col) with table-qualified ones."""

    def fix_name(name: str) -> str:
        if "." in name:
            prefix, col = name.split(".", 1)
            if prefix in aliases:
                return f"{aliases[prefix]}.{col}"
        return name

    def fix_cond(c):
        if c is None:
            return None
        kwargs = {}
        if c.column is not None:
            kwargs["column"] = fix_name(c.column)
        left = fix_cond(c.left)
        right = fix_cond(c.right)
        from dataclasses import replace as _replace

        return _replace(c, left=left, right=right, **kwargs)

    def fix_tree(e):
        from neumann_tpu_torch.lang import expr as E

        if isinstance(e, E.Col):
            return E.Col(fix_name(e.name))
        if isinstance(e, E.Bin):
            return E.Bin(e.op, fix_tree(e.left), fix_tree(e.right))
        if isinstance(e, E.Case):
            return E.Case(tuple((fix_cond(c), fix_tree(r))
                                for c, r in e.whens),
                          fix_tree(e.else_) if e.else_ else None)
        if isinstance(e, E.Cast):
            return E.Cast(fix_tree(e.expr), e.ctype)
        return e

    for item in stmt.items:
        item.expr = fix_name(item.expr)
        if item.tree is not None:
            item.tree = fix_tree(item.tree)
    stmt.where = fix_cond(stmt.where)
    stmt.having = fix_cond(stmt.having)
    stmt.group_by = [fix_name(g) for g in stmt.group_by]
    stmt.order_by = [(fix_name(sp[0]), *sp[1:]) for sp in stmt.order_by]


# Eagerly bind the native entry point when the extension is already
# built (a plain import — no compile subprocess), so every importer of
# `parse` gets the zero-frame C path. First-ever runs stay lazy: the
# wrapper above builds the extension on first parse and upgrades the
# binding for later importers.
def _eager_native() -> None:
    try:
        from neumann_tpu_torch.native import pyparser as _pp

        if _pp.built():
            _native()
    except Exception:       # noqa: BLE001 — never block import on this
        pass


_eager_native()

"""Cypher subset: MATCH / CREATE / MERGE / DELETE / SET over GraphEngine.

Copy of ``neumann_tpu.lang.cypher`` with only its import lines changed
(the port's lexer and condition tree).

Parity with the reference's experimental Cypher support
(query_router/src/cypher.rs capability, query-language.md "Cypher
Commands"): node/relationship patterns with labels, types, inline
property maps, direction (-> / <- / undirected), variable-length
segments [*min..max], WHERE conditions, RETURN with aliases and
COUNT(*), ORDER BY / SKIP / LIMIT, DETACH DELETE, and MERGE with
ON CREATE SET / ON MATCH SET.

Execution is host-side backtracking over the graph engine's adjacency
caches — pattern matching is control-flow-heavy and tiny compared to the
vector path, so it stays off-device by design.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from neumann_tpu_torch.engines.condition import Condition
from neumann_tpu_torch.lang.lexer import Token, tokenize
from neumann_tpu_torch.utils.errors import GraphError, ParseError


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclass
class NodePattern:
    var: Optional[str] = None
    label: Optional[str] = None
    props: Dict[str, object] = field(default_factory=dict)


@dataclass
class RelPattern:
    var: Optional[str] = None
    rel_type: Optional[str] = None
    direction: str = "out"          # out | in | both
    min_hops: int = 1
    max_hops: int = 1
    props: Dict[str, object] = field(default_factory=dict)


@dataclass
class Pattern:
    """Alternating nodes and relationships: n0 r0 n1 r1 n2 ..."""

    nodes: List[NodePattern] = field(default_factory=list)
    rels: List[RelPattern] = field(default_factory=list)


@dataclass
class ReturnItem:
    var: str
    prop: Optional[str] = None
    agg: Optional[str] = None       # count
    alias: Optional[str] = None

    @property
    def name(self) -> str:
        if self.alias:
            return self.alias
        if self.agg:
            return f"{self.agg}(*)" if self.var == "*" else \
                f"{self.agg}({self.var})"
        return f"{self.var}.{self.prop}" if self.prop else self.var


@dataclass
class CypherQuery:
    kind: str                        # match | create | merge
    patterns: List[Pattern] = field(default_factory=list)
    where: Optional[Condition] = None
    returns: List[ReturnItem] = field(default_factory=list)
    order_by: List[Tuple[str, bool]] = field(default_factory=list)
    skip: int = 0
    limit: Optional[int] = None
    delete_vars: List[str] = field(default_factory=list)
    detach: bool = False
    set_items: List[Tuple[str, str, object]] = field(default_factory=list)
    create_patterns: List[Pattern] = field(default_factory=list)
    on_create_set: List[Tuple[str, str, object]] = field(
        default_factory=list)
    on_match_set: List[Tuple[str, str, object]] = field(
        default_factory=list)
    optional: bool = False


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

class _CypherParser:
    def __init__(self, src: str):
        self.toks = tokenize(src)
        self.pos = 0

    def peek(self) -> Token:
        return self.toks[min(self.pos, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.pos]
        if t.kind != "eof":
            self.pos += 1
        return t

    def at_kw(self, *kws) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.text.upper() in kws

    def accept_kw(self, *kws) -> Optional[str]:
        if self.at_kw(*kws):
            return self.next().text.upper()
        return None

    def expect_kw(self, *kws) -> str:
        t = self.peek()
        if not self.at_kw(*kws):
            raise ParseError(f"expected {' or '.join(kws)}, got "
                             f"{t.text or 'EOF'!r}", t.line, t.col)
        return self.next().text.upper()

    def at_punct(self, p) -> bool:
        t = self.peek()
        return t.kind == "punct" and t.text == p

    def accept_punct(self, p) -> bool:
        if self.at_punct(p):
            self.next()
            return True
        return False

    def expect_punct(self, p) -> None:
        t = self.peek()
        if not self.at_punct(p):
            raise ParseError(f"expected {p!r}, got {t.text or 'EOF'!r}",
                             t.line, t.col)
        self.next()

    def ident(self, what="identifier") -> str:
        t = self.peek()
        if t.kind == "ident":
            return self.next().text
        raise ParseError(f"expected {what}, got {t.text or 'EOF'!r}",
                         t.line, t.col)

    def value(self):
        t = self.peek()
        if t.kind == "string":
            return self.next().value
        if t.kind == "number":
            return self.next().value
        if t.kind == "punct" and t.text == "-":
            self.next()
            return -self.value()
        if t.kind == "ident":
            up = t.text.upper()
            if up in ("TRUE", "FALSE"):
                self.next()
                return up == "TRUE"
            if up == "NULL":
                self.next()
                return None
        raise ParseError(f"expected value, got {t.text or 'EOF'!r}",
                         t.line, t.col)

    def props(self) -> Dict[str, object]:
        out: Dict[str, object] = {}
        self.expect_punct("{")
        if not self.at_punct("}"):
            while True:
                k = self.ident("property")
                self.expect_punct(":")
                out[k] = self.value()
                if not self.accept_punct(","):
                    break
        self.expect_punct("}")
        return out

    # -- patterns -----------------------------------------------------------
    def node_pattern(self) -> NodePattern:
        self.expect_punct("(")
        np_ = NodePattern()
        if self.peek().kind == "ident" and not self.at_punct(")"):
            np_.var = self.ident()
        if self.accept_punct(":"):
            np_.label = self.ident("label")
        if self.at_punct("{"):
            np_.props = self.props()
        self.expect_punct(")")
        return np_

    def rel_pattern(self) -> Optional[RelPattern]:
        # <-[r:T]- | -[r:T]-> | -[r:T]- | -> | <- | --
        if self.at_punct("<"):
            self.next()
            self.expect_punct("-")
            rel = self._rel_body()
            rel.direction = "in"
            self.expect_punct("-")
            return rel
        if self.at_punct("-"):
            self.next()
            rel = self._rel_body()
            if self.accept_punct("->"):
                rel.direction = "out"
            elif self.accept_punct("-"):
                rel.direction = "both"
            else:
                t = self.peek()
                raise ParseError("expected -> or - after relationship",
                                 t.line, t.col)
            return rel
        return None

    def _rel_body(self) -> RelPattern:
        rel = RelPattern()
        if self.accept_punct("["):
            if self.peek().kind == "ident":
                rel.var = self.ident()
            if self.accept_punct(":"):
                rel.rel_type = self.ident("relationship type")
            if self.accept_punct("*"):
                # variable length: * | *n | *n..m | *..m
                # NB: the shared lexer tokenizes "1..3" as numbers "1."
                # and ".3", so bounds are recovered from token text
                rel.min_hops, rel.max_hops = 1, 5
                t = self.peek()
                if t.kind == "number":
                    self.next()
                    txt = t.text
                    if txt.endswith("."):          # "n.." -> "n." + ".m"
                        rel.min_hops = int(txt[:-1])
                        t2 = self.peek()
                        if t2.kind == "number" and \
                                t2.text.startswith("."):
                            self.next()
                            rel.max_hops = int(t2.text[1:])
                        else:
                            # open-ended "*n..": "n.." lexed as the
                            # number "n." plus a lone "." to consume
                            self.accept_punct(".")
                            rel.max_hops = 5
                    else:
                        rel.min_hops = int(t.value)
                        rel.max_hops = rel.min_hops
                        if self.accept_punct("."):
                            self.expect_punct(".")
                            if self.peek().kind == "number":
                                rel.max_hops = int(self.next().value)
                            else:
                                rel.max_hops = 5
                elif self.at_punct("."):           # "*..m"
                    self.next()
                    t2 = self.peek()
                    if t2.kind == "number" and t2.text.startswith("."):
                        self.next()
                        rel.max_hops = int(t2.text[1:])
                    else:
                        self.expect_punct(".")
                        t3 = self.peek()
                        if t3.kind != "number":
                            raise ParseError(
                                f"expected hop bound after '..', got "
                                f"{t3.text or 'EOF'!r}", t3.line, t3.col)
                        rel.max_hops = int(self.next().value)
            if self.at_punct("{"):
                rel.props = self.props()
            self.expect_punct("]")
        return rel

    def pattern(self) -> Pattern:
        p = Pattern()
        p.nodes.append(self.node_pattern())
        while True:
            rel = self.rel_pattern()
            if rel is None:
                return p
            p.rels.append(rel)
            p.nodes.append(self.node_pattern())

    # -- conditions (reuse the SQL condition grammar on var.prop) ----------
    def condition(self) -> Condition:
        left = self._and_cond()
        while self.accept_kw("OR"):
            left = left.or_(self._and_cond())
        return left

    def _and_cond(self) -> Condition:
        left = self._primary_cond()
        while self.accept_kw("AND"):
            left = left.and_(self._primary_cond())
        return left

    def _primary_cond(self) -> Condition:
        if self.accept_punct("("):
            c = self.condition()
            self.expect_punct(")")
            return c
        if self.accept_kw("NOT"):
            return self._primary_cond().not_()
        name = self.ident("variable")
        if self.accept_punct("."):
            name = f"{name}.{self.ident('property')}"
        t = self.peek()
        if t.kind == "punct" and t.text in ("=", "!=", "<>", "<", "<=",
                                            ">", ">="):
            op = self.next().text
            return Condition.cmp(name, op, self.value())
        if self.accept_kw("IS"):
            if self.accept_kw("NOT"):
                self.expect_kw("NULL")
                return Condition.is_not_null(name)
            self.expect_kw("NULL")
            return Condition.is_null(name)
        raise ParseError(f"expected comparison after {name!r}",
                         t.line, t.col)

    # -- set items -----------------------------------------------------------
    def set_items(self) -> List[Tuple[str, str, object]]:
        out = []
        while True:
            var = self.ident("variable")
            self.expect_punct(".")
            prop = self.ident("property")
            self.expect_punct("=")
            out.append((var, prop, self.value()))
            if not self.accept_punct(","):
                return out

    # -- statements --------------------------------------------------------
    def parse(self) -> CypherQuery:
        q = CypherQuery(kind="match")
        if self.accept_kw("OPTIONAL"):
            q.optional = True
        kw = self.expect_kw("MATCH", "CREATE", "MERGE")
        if kw == "CREATE":
            q.kind = "create"
            q.patterns.append(self.pattern())
            while self.accept_punct(","):
                q.patterns.append(self.pattern())
            return q
        if kw == "MERGE":
            q.kind = "merge"
            q.patterns.append(self.pattern())
            while True:
                if self.accept_kw("ON"):
                    which = self.expect_kw("CREATE", "MATCH")
                    self.expect_kw("SET")
                    items = self.set_items()
                    if which == "CREATE":
                        q.on_create_set += items
                    else:
                        q.on_match_set += items
                else:
                    break
            if self.accept_kw("RETURN"):
                self._parse_return(q)
            return q
        # MATCH
        q.patterns.append(self.pattern())
        while self.accept_punct(","):
            q.patterns.append(self.pattern())
        if self.accept_kw("WHERE"):
            q.where = self.condition()
        if self.accept_kw("CREATE"):
            q.create_patterns.append(self.pattern())
            while self.accept_punct(","):
                q.create_patterns.append(self.pattern())
        if self.accept_kw("SET"):
            q.set_items = self.set_items()
        if self.accept_kw("DETACH"):
            self.expect_kw("DELETE")
            q.detach = True
            q.delete_vars.append(self.ident())
            while self.accept_punct(","):
                q.delete_vars.append(self.ident())
        elif self.accept_kw("DELETE"):
            q.delete_vars.append(self.ident())
            while self.accept_punct(","):
                q.delete_vars.append(self.ident())
        if self.accept_kw("RETURN"):
            self._parse_return(q)
        t = self.peek()
        if t.kind != "eof":
            raise ParseError(f"unexpected trailing input {t.text!r}",
                             t.line, t.col)
        return q

    def _parse_return(self, q: CypherQuery) -> None:
        while True:
            item = self._return_item()
            q.returns.append(item)
            if not self.accept_punct(","):
                break
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                name = self.ident()
                if self.accept_punct("."):
                    name = f"{name}.{self.ident()}"
                desc = bool(self.accept_kw("DESC"))
                if not desc:
                    self.accept_kw("ASC")
                q.order_by.append((name, desc))
                if not self.accept_punct(","):
                    break
        if self.accept_kw("SKIP"):
            q.skip = self.next().value
        if self.accept_kw("LIMIT"):
            q.limit = self.next().value

    def _return_item(self) -> ReturnItem:
        t = self.peek()
        if t.kind == "ident" and t.text.upper() == "COUNT":
            self.next()
            self.expect_punct("(")
            var = "*"
            if self.at_punct("*"):
                self.next()
            else:
                var = self.ident()
            self.expect_punct(")")
            alias = self.ident() if self.accept_kw("AS") else None
            return ReturnItem(var=var, agg="count", alias=alias)
        var = self.ident("return item")
        prop = None
        if self.accept_punct("."):
            prop = self.ident("property")
        alias = self.ident() if self.accept_kw("AS") else None
        return ReturnItem(var=var, prop=prop, alias=alias)


def parse_cypher(src: str) -> CypherQuery:
    return _CypherParser(src).parse()


def looks_like_cypher(src: str) -> bool:
    s = src.lstrip().upper()
    if s.startswith(("MATCH", "MERGE", "OPTIONAL MATCH")):
        return True
    if s.startswith("CREATE"):
        rest = s[len("CREATE"):].lstrip()
        return rest.startswith("(")
    return False


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

class CypherExecutor:
    def __init__(self, graph):
        self.graph = graph

    # -- matching -----------------------------------------------------------
    def _node_candidates(self, np_: NodePattern) -> List[int]:
        nodes = self.graph.find_nodes(np_.label)
        out = []
        for n in nodes:
            if all(n["properties"].get(k) == v
                   for k, v in np_.props.items()):
                out.append(n["id"])
        return out

    def _expand(self, nid: int, rel: RelPattern) -> List[Tuple[int, int]]:
        """(neighbor, edge_id) pairs one hop from nid matching rel."""
        out = []
        g = self.graph
        with g._lock:
            edge_lists = []
            if rel.direction in ("out", "both"):
                edge_lists.append(("fwd", g._out.get(nid, [])))
            if rel.direction in ("in", "both"):
                edge_lists.append(("rev", g._in.get(nid, [])))
            seen = set()
            for side, lst in edge_lists:
                for eid in lst:
                    if eid in seen:
                        continue
                    e = g._edges[eid]
                    if rel.rel_type is not None and \
                            e["type"] != rel.rel_type:
                        continue
                    if rel.props and not all(
                            e["props"].get(k) == v
                            for k, v in rel.props.items()):
                        continue
                    if side == "fwd":
                        other = e["dst"] if e["src"] == nid else e["src"]
                    else:
                        if e["directed"]:
                            other = e["src"]
                        else:
                            other = e["src"] if e["dst"] == nid \
                                else e["dst"]
                    seen.add(eid)
                    out.append((other, eid))
        return out

    def _match_pattern(self, pattern: Pattern) -> List[dict]:
        """All bindings: var -> node id (rel vars -> edge id)."""
        results: List[dict] = []

        def backtrack(idx: int, binding: dict, current: int):
            if idx == len(pattern.rels):
                results.append(dict(binding))
                return
            rel = pattern.rels[idx]
            target = pattern.nodes[idx + 1]

            def try_node(cand: int, eid: Optional[int], hops_used):
                node = self.graph.get_node(cand)
                if node is None:
                    return
                if target.label is not None and \
                        node["label"] != target.label:
                    return
                if any(node["properties"].get(k) != v
                       for k, v in target.props.items()):
                    return
                if target.var and target.var in binding and \
                        binding[target.var] != cand:
                    return
                b2 = dict(binding)
                if target.var:
                    b2[target.var] = cand
                if rel.var is not None and eid is not None:
                    b2[rel.var] = ("edge", eid)
                backtrack(idx + 1, b2, cand)

            if rel.min_hops == 1 and rel.max_hops == 1:
                for cand, eid in self._expand(current, rel):
                    try_node(cand, eid, 1)
            else:
                # variable length BFS (simple paths)
                frontier = [(current, [current])]
                for hop in range(1, rel.max_hops + 1):
                    nxt = []
                    for nid, path in frontier:
                        for cand, eid in self._expand(nid, rel):
                            if cand in path:
                                continue
                            if hop >= rel.min_hops:
                                try_node(cand, None, hop)
                            nxt.append((cand, path + [cand]))
                    frontier = nxt

        for start in self._node_candidates(pattern.nodes[0]):
            b = {}
            if pattern.nodes[0].var:
                b[pattern.nodes[0].var] = start
            backtrack(0, b, start)
        return results

    def _match_all(self, q: CypherQuery) -> List[dict]:
        bindings = [{}]
        for pattern in q.patterns:
            pat_bindings = self._match_pattern(pattern)
            merged = []
            for b in bindings:
                for pb in pat_bindings:
                    conflict = any(
                        k in b and b[k] != v for k, v in pb.items())
                    if not conflict:
                        merged.append({**b, **pb})
            bindings = merged
        # WHERE
        if q.where is not None:
            bindings = [b for b in bindings
                        if q.where.evaluate_row(self._row_view(b))]
        return bindings

    def _row_view(self, binding: dict) -> dict:
        row = {}
        for var, val in binding.items():
            if isinstance(val, tuple) and val[0] == "edge":
                e = self.graph.get_edge(val[1])
                if e:
                    for k, v in e["properties"].items():
                        row[f"{var}.{k}"] = v
                continue
            node = self.graph.get_node(val)
            if node:
                row[var] = val
                for k, v in node["properties"].items():
                    row[f"{var}.{k}"] = v
        return row

    # -- execution ------------------------------------------------------------
    def execute(self, q: CypherQuery) -> List[dict]:
        if q.kind == "create":
            return self._exec_create(q)
        if q.kind == "merge":
            return self._exec_merge(q)
        return self._exec_match(q)

    def _exec_create(self, q: CypherQuery,
                     env: Optional[Dict[str, int]] = None) -> List[dict]:
        created = []
        env = dict(env or {})
        for pattern in q.patterns:
            ids = []
            for np_ in pattern.nodes:
                if np_.var and np_.var in env:
                    ids.append(env[np_.var])
                    continue
                if np_.var and np_.label is None and not np_.props:
                    # bare (a) with unknown var: must exist already
                    raise GraphError(
                        f"unbound variable '{np_.var}' in CREATE")
                nid = self.graph.create_node(np_.label or "node",
                                             np_.props)
                if np_.var:
                    env[np_.var] = nid
                ids.append(nid)
                created.append({"node": nid})
            for i, rel in enumerate(pattern.rels):
                src, dst = ids[i], ids[i + 1]
                if rel.direction == "in":
                    src, dst = dst, src
                eid = self.graph.create_edge(
                    src, dst, rel.rel_type or "related", rel.props,
                    directed=rel.direction != "both")
                created.append({"edge": eid})
        return created

    def _exec_merge(self, q: CypherQuery) -> List[dict]:
        pattern = q.patterns[0]
        matches = self._match_pattern(pattern)
        if matches:
            for var, prop, val in q.on_match_set:
                for b in matches:
                    if var in b and not isinstance(b[var], tuple):
                        self.graph.update_node(b[var], {prop: val})
            return [self._row_view(b) for b in matches]
        created = self._exec_create(
            CypherQuery(kind="create", patterns=[pattern]))
        node_id = created[0]["node"] if created else None
        if node_id is not None:
            for var, prop, val in q.on_create_set:
                if pattern.nodes[0].var == var:
                    self.graph.update_node(node_id, {prop: val})
        return created

    def _exec_match(self, q: CypherQuery) -> List[dict]:
        bindings = self._match_all(q)
        # MATCH ... CREATE: instantiate create patterns per binding,
        # with matched variables bound as endpoints
        if q.create_patterns:
            created = []
            for b in bindings:
                env = {k: v for k, v in b.items()
                       if not isinstance(v, tuple)}
                created += self._exec_create(
                    CypherQuery(kind="create",
                                patterns=q.create_patterns), env)
            if not q.returns:
                return created
        # SET
        for var, prop, val in q.set_items:
            for b in bindings:
                target = b.get(var)
                if target is not None and not isinstance(target, tuple):
                    self.graph.update_node(target, {prop: val})
        # DELETE
        if q.delete_vars:
            deleted_nodes = set()
            deleted_edges = set()
            for b in bindings:
                for var in q.delete_vars:
                    val = b.get(var)
                    if val is None:
                        continue
                    if isinstance(val, tuple):
                        deleted_edges.add(val[1])
                    else:
                        deleted_nodes.add(val)
            for eid in deleted_edges:
                self.graph.delete_edge(eid)
            for nid in deleted_nodes:
                if not q.detach and \
                        self.graph.get_entity_neighbors(nid):
                    raise GraphError(
                        f"node {nid} still has relationships "
                        f"(use DETACH DELETE)")
                self.graph.delete_node(nid)
            return [{"deleted_nodes": len(deleted_nodes),
                     "deleted_edges": len(deleted_edges)}]
        # RETURN
        if not q.returns:
            return [self._row_view(b) for b in bindings]
        agg_items = [i for i in q.returns if i.agg]
        if agg_items:
            row = {}
            for item in q.returns:
                if item.agg == "count":
                    if item.var == "*":
                        row[item.name] = len(bindings)
                    else:
                        row[item.name] = sum(
                            1 for b in bindings
                            if b.get(item.var) is not None)
            return [row]
        pairs = []
        for b in bindings:
            view = self._row_view(b)
            row = {}
            for item in q.returns:
                if item.prop:
                    row[item.name] = view.get(f"{item.var}.{item.prop}")
                else:
                    row[item.name] = b.get(item.var)
            pairs.append((row, view))
        if q.order_by:
            # ORDER BY may reference columns outside the projection, so
            # sort on the full bound view (projection as fallback)
            def keyfn(col):
                def key(pair):
                    row, view = pair
                    v = row.get(col, view.get(col))
                    return (v is None, v)
                return key

            for col, desc in reversed(q.order_by):
                pairs.sort(key=keyfn(col), reverse=desc)
        rows = [row for row, _ in pairs]
        if q.skip:
            rows = rows[q.skip:]
        if q.limit is not None:
            rows = rows[: q.limit]
        return rows

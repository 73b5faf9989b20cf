"""Server-rendered web admin: browse and operate all three engines.

Parity with the reference's axum/maud admin app
(neumann_server/src/web/mod.rs:86-166 route table; handlers/ has
relational.rs, vector.rs, graph.rs, graph_algorithms.rs, metrics.rs,
achievements.rs): dashboard, relational table browser, vector
collection/point browser with a search form, graph overview +
node/edge lists + path finder + algorithm runner, a metrics dashboard
with a JSON snapshot API, the achievements page, and the HTMX-style
subgraph JSON API. Rendering is plain f-string HTML over one shared
dark layout — the reference's maud templates role without a
template engine dependency.

Mounted by RestServer under the same HTTP port (see rest.py); every
page is also reachable headless, so the conformance tests drive it
with urllib alone.

The port's copy of ``neumann_tpu/server/admin.py`` with only its import
lines changed (the graph-algorithms runner imports the port's module).
"""

from __future__ import annotations

import html
import json
from typing import Optional
from urllib.parse import parse_qs

from neumann_tpu_torch.utils.errors import NeumannError

_NAV = (
    ("/", "dashboard"), ("/relational", "relational"),
    ("/vector", "vector"), ("/graph", "graph"),
    ("/graph/algorithms", "algorithms"), ("/metrics/dashboard",
                                          "metrics"),
    ("/achievements/page", "achievements"),
)

_CSS = """body{font-family:monospace;margin:2em;background:#101418;
color:#d7e0ea}table{border-collapse:collapse;margin:1em 0}
td,th{border:1px solid #33404f;padding:4px 10px;text-align:left}
h1{color:#7dd3fc}h2{color:#94a3b8}code{color:#fbbf24}
a{color:#7dd3fc}nav a{margin-right:1em}
input,select,button{background:#1a222c;color:#d7e0ea;
border:1px solid #33404f;padding:4px 8px;font-family:monospace}
button{cursor:pointer}form{margin:1em 0}
.err{color:#f87171}.muted{color:#64748b}"""


def _esc(v) -> str:
    return html.escape(str(v), quote=True)


def _page(title: str, body: str) -> str:
    nav = " ".join(f'<a href="{p}">{n}</a>' for p, n in _NAV)
    return (f"<!doctype html><html><head><title>{_esc(title)} · "
            f"neumann-tpu</title><style>{_CSS}</style></head><body>"
            f"<nav>{nav}</nav><h1>{_esc(title)}</h1>{body}"
            f"</body></html>")


def _table(headers, rows) -> str:
    head = "".join(f"<th>{_esc(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{c}</td>" for c in r) + "</tr>"
        for r in rows)
    if not body:
        body = (f'<tr><td colspan="{len(headers)}" class="muted">'
                "empty</td></tr>")
    return f"<table><tr>{head}</tr>{body}</table>"


def _pager(base: str, limit: int, offset: int, n_shown: int) -> str:
    links = []
    if offset > 0:
        links.append(f'<a href="{base}?limit={limit}&offset='
                     f'{max(0, offset - limit)}">&larr; prev</a>')
    if n_shown == limit:
        links.append(f'<a href="{base}?limit={limit}&offset='
                     f'{offset + limit}">next &rarr;</a>')
    return f"<p>{' · '.join(links)}</p>" if links else ""


class AdminApp:
    """Route dispatcher for the HTML admin + its JSON APIs."""

    def __init__(self, router, tracker=None):
        self.router = router
        self.tracker = tracker

    # -- entry ---------------------------------------------------------
    def dispatch(self, method: str, path: str, body: dict):
        """Returns (payload, content_type) or None when unrouted."""
        raw_q = path.split("?", 1)[1] if "?" in path else ""
        q = {k: v[-1] for k, v in parse_qs(raw_q).items()}
        parts = [p for p in path.split("?")[0].split("/") if p]
        limit = max(1, min(int(q.get("limit", 50)), 1000))
        offset = max(0, int(q.get("offset", 0)))
        r = self.router
        if parts[:1] == ["relational"]:
            if method != "GET":
                raise NeumannError("relational admin pages are GET")
            if len(parts) == 1:
                return self._tables_list(), "text/html"
            if len(parts) == 2:
                return self._table_detail(parts[1]), "text/html"
            if len(parts) == 3 and parts[2] == "rows":
                return (self._table_rows(parts[1], limit, offset),
                        "text/html")
        if parts[:1] == ["vector"]:
            if len(parts) == 1:
                return self._collections_list(), "text/html"
            name = parts[1]
            if len(parts) == 2:
                return self._collection_detail(name), "text/html"
            if parts[2] == "points" and len(parts) == 3:
                return (self._points_list(name, limit, offset),
                        "text/html")
            if parts[2] == "points" and len(parts) == 4:
                return (self._point_detail(name, parts[3]),
                        "text/html")
            if parts[2] == "search":
                return (self._vector_search(name, method, q, body),
                        "text/html")
        if parts[:1] == ["graph"]:
            if len(parts) == 1:
                return self._graph_overview(), "text/html"
            if parts[1] == "nodes":
                return (self._graph_nodes(q, limit, offset),
                        "text/html")
            if parts[1] == "edges":
                return (self._graph_edges(limit, offset), "text/html")
            if parts[1] == "path":
                return (self._graph_path(method, q, body), "text/html")
            if parts[1] == "algorithms":
                return (self._graph_algorithms(method, q, body),
                        "text/html")
        if parts == ["metrics", "dashboard"]:
            return self._metrics_dashboard(), "text/html"
        if parts == ["achievements", "page"]:
            return self._achievements_page(), "text/html"
        if parts == ["api", "metrics"]:
            return {"statements": r.metrics.snapshot(),
                    "slow_queries": r.metrics.slow_queries()}, None
        if parts == ["api", "graph", "subgraph"]:
            return self._api_subgraph(q), None
        if parts == ["api", "query"] and method == "POST":
            res = r.execute(body["query"])
            return {"kind": res.kind, "message": res.message,
                    "rows": res.rows, "hits": res.results,
                    "count": res.count, "value": res.value}, None
        return None

    # -- relational (handlers/relational.rs) ----------------------------
    def _tables_list(self) -> str:
        rel = self.router.relational
        rows = [(f'<a href="/relational/{_esc(t)}">{_esc(t)}</a>',
                 len(rel.describe(t)), rel.row_count(t))
                for t in rel.list_tables()]
        return _page("relational", _table(
            ("table", "columns", "rows"), rows))

    def _table_detail(self, name: str) -> str:
        rel = self.router.relational
        cols = rel.describe(name)
        rows = [(_esc(c["name"]), _esc(c["type"]),
                 "yes" if c.get("primary_key") else "",
                 "yes" if c.get("unique") else "",
                 "" if c.get("nullable", True) else "NOT NULL",
                 _esc(c.get("references") or ""))
                for c in cols]
        body = _table(("column", "type", "pk", "unique", "null",
                       "references"), rows)
        body += (f'<p><a href="/relational/{_esc(name)}/rows">'
                 "browse rows</a></p>")
        return _page(f"table {name}", body)

    def _table_rows(self, name: str, limit: int, offset: int) -> str:
        rel = self.router.relational
        cols = [c["name"] for c in rel.describe(name)]
        recs = rel.select(name, limit=limit, offset=offset)
        rows = [tuple(_esc(rec.get(c)) for c in cols) for rec in recs]
        body = _table(cols, rows)
        body += _pager(f"/relational/{name}/rows", limit, offset,
                       len(recs))
        return _page(f"rows of {name}", body)

    # -- vector (handlers/vector.rs) ------------------------------------
    def _collections_list(self) -> str:
        vec = self.router.vector
        rows = []
        for n in ["_default"] + vec.list_collections():
            if n == "_default":
                cnt = vec.count_embeddings()
                dim = metric = quant = "—"
            else:
                st = vec.collection_stats(n)
                cnt, dim = st["count"], st["dimension"]
                metric, quant = st["metric"], st["quantization"]
            rows.append((f'<a href="/vector/{_esc(n)}">{_esc(n)}</a>',
                         cnt, dim, metric, quant))
        return _page("vector collections", _table(
            ("collection", "count", "dim", "metric", "quant"), rows))

    def _coll_keys(self, name: str):
        store = self.router.store
        prefix = "emb:" if name == "_default" else f"col:{name}:"
        return prefix, store.scan(prefix)

    def _collection_detail(self, name: str) -> str:
        vec = self.router.vector
        if name == "_default":
            body = (f"<p>default embedding namespace · "
                    f"<code>{vec.count_embeddings()}</code> vectors"
                    "</p>")
        else:
            st = vec.collection_stats(name)
            body = "<p>" + " · ".join(
                f"{k}: <code>{_esc(v)}</code>"
                for k, v in sorted(st.items())) + "</p>"
        body += (f'<p><a href="/vector/{_esc(name)}/points">browse '
                 f'points</a> · <a href="/vector/{_esc(name)}/search">'
                 "search</a></p>")
        return _page(f"collection {name}", body)

    def _points_list(self, name: str, limit: int, offset: int) -> str:
        prefix, keys = self._coll_keys(name)
        page = keys[offset:offset + limit]
        rows = [(f'<a href="/vector/{_esc(name)}/points/'
                 f'{_esc(k[len(prefix):])}">{_esc(k[len(prefix):])}'
                 "</a>",) for k in page]
        body = _table(("point",), rows)
        body += _pager(f"/vector/{name}/points", limit, offset,
                       len(page))
        return _page(f"points of {name}", body)

    def _point_detail(self, name: str, pid: str) -> str:
        store = self.router.store
        key = f"emb:{pid}" if name == "_default" else f"col:{name}:{pid}"
        data = store.get(key)
        if data is None:
            return _page(f"point {pid}",
                         '<p class="err">not found</p>')
        fields = []
        vec_html = ""
        for fname, val in data.fields.items():
            if val.kind == "vector":
                dense = val.value.to_dense() if hasattr(
                    val.value, "to_dense") else val.value
                import numpy as np

                a = np.asarray(dense, dtype=float)
                head = ", ".join(f"{x:.4f}" for x in a[:16])
                vec_html = (f"<h2>{_esc(fname)}</h2><p>dim "
                            f"<code>{a.shape[-1]}</code> · norm "
                            f"<code>{float(np.linalg.norm(a)):.4f}"
                            f"</code></p><p class=muted>[{head}"
                            f"{', …' if a.shape[-1] > 16 else ''}]"
                            "</p>")
            else:
                fields.append((_esc(fname), _esc(val.value)))
        body = _table(("payload field", "value"), fields) + vec_html
        return _page(f"point {pid}", body)

    def _vector_search(self, name: str, method: str, q: dict,
                       body: dict) -> str:
        form = (f'<form method="post" action="/vector/{_esc(name)}'
                '/search">'
                '<p>vector (comma-separated floats):<br>'
                '<input name="vector" size="80" '
                'placeholder="0.1, -0.3, ..."></p>'
                '<p>top k: <input name="limit" value="10" size="4"> '
                '<button>search</button></p></form>')
        out = ""
        vec_in = (body or {}).get("vector") or q.get("vector")
        if method == "POST" and vec_in:
            try:
                if isinstance(vec_in, str):
                    vec = [float(x) for x in vec_in.replace(
                        "[", "").replace("]", "").split(",") if
                        x.strip()]
                else:
                    vec = [float(x) for x in vec_in]
                k = int((body or {}).get("limit") or
                        q.get("limit") or 10)
                eng = self.router.vector
                if name == "_default":
                    hits = eng.search_similar(vec, k)
                else:
                    hits = eng.search_in_collection(name, vec, k)
                out = _table(("key", "score"), [
                    (_esc(h.key), f"{h.score:.6f}") for h in hits])
            except Exception as e:  # noqa: BLE001 — render the error
                out = f'<p class="err">{_esc(e)}</p>'
        return _page(f"search {name}", form + out)

    # -- graph (handlers/graph.rs) --------------------------------------
    def _graph_overview(self) -> str:
        g = self.router.graph
        labels = {}
        with g._lock:
            for n in g._nodes.values():
                labels[n["label"]] = labels.get(n["label"], 0) + 1
        rows = [(f'<a href="/graph/nodes?label={_esc(lb)}">{_esc(lb)}'
                 "</a>", c) for lb, c in sorted(labels.items())]
        body = (f"<p><code>{g.node_count()}</code> nodes · "
                f"<code>{g.edge_count()}</code> edges</p>"
                + _table(("label", "nodes"), rows)
                + '<p><a href="/graph/nodes">all nodes</a> · '
                '<a href="/graph/edges">edges</a> · '
                '<a href="/graph/path">path finder</a> · '
                '<a href="/graph/algorithms">algorithms</a> · '
                '<a href="/graph/viz">viz (SVG)</a></p>')
        return _page("graph", body)

    def _graph_nodes(self, q: dict, limit: int, offset: int) -> str:
        g = self.router.graph
        label = q.get("label")
        nodes = g.find_nodes(label=label, limit=limit, offset=offset)
        rows = [(n["id"], _esc(n["label"]),
                 _esc(json.dumps(n["properties"])[:120]))
                for n in nodes]
        base = "/graph/nodes" + (f"?label={label}&" if label else "")
        body = _table(("id", "label", "properties"), rows)
        body += _pager("/graph/nodes", limit, offset, len(nodes))
        _ = base
        return _page("graph nodes", body)

    def _graph_edges(self, limit: int, offset: int) -> str:
        g = self.router.graph
        with g._lock:
            eids = sorted(g._edges)[offset:offset + limit]
            rows = [(e, g._edges[e]["src"],
                     _esc(g._edges[e]["type"]), g._edges[e]["dst"],
                     _esc(json.dumps(g._edges[e].get("props") or
                                     {})[:80]))
                    for e in eids]
        body = _table(("id", "src", "type", "dst", "props"), rows)
        body += _pager("/graph/edges", limit, offset, len(rows))
        return _page("graph edges", body)

    def _graph_path(self, method: str, q: dict, body: dict) -> str:
        form = ('<form method="post" action="/graph/path">'
                '<p>from <input name="src" size="6"> to '
                '<input name="dst" size="6"> '
                '<label>weighted <input type="checkbox" '
                'name="weighted"></label> '
                '<button>find path</button></p></form>')
        out = ""
        src = (body or {}).get("src") or q.get("src")
        dst = (body or {}).get("dst") or q.get("dst")
        if src is not None and dst is not None and method == "POST":
            g = self.router.graph
            try:
                if (body or {}).get("weighted") or q.get("weighted"):
                    path, cost = g.find_weighted_path(int(src),
                                                      int(dst))
                    out = (f"<p>cost <code>{cost:.4f}</code></p>"
                           if path else "")
                else:
                    path = g.find_path(int(src), int(dst))
                if path:
                    out += "<p>" + " &rarr; ".join(
                        f"<code>{n}</code>" for n in path) + "</p>"
                else:
                    out += '<p class="err">no path</p>'
            except Exception as e:  # noqa: BLE001
                out = f'<p class="err">{_esc(e)}</p>'
        return _page("path finder", form + out)

    _ALGOS = ("pagerank", "connected_components", "triangle_count",
              "strongly_connected_components", "louvain",
              "betweenness_centrality", "closeness_centrality")

    def _graph_algorithms(self, method: str, q: dict,
                          body: dict) -> str:
        opts = "".join(f'<option value="{a}">{a}</option>'
                       for a in self._ALGOS)
        form = ('<form method="post" action="/graph/algorithms">'
                f'<p><select name="algo">{opts}</select> '
                '<button>run</button></p></form>')
        out = ""
        algo = (body or {}).get("algo") or q.get("algo")
        if algo and method == "POST":
            if algo not in self._ALGOS:
                out = '<p class="err">unknown algorithm</p>'
            else:
                g = self.router.graph
                try:
                    fn = getattr(g, algo, None)
                    if fn is None:
                        from neumann_tpu_torch.engines.graph_algorithms \
                            import GraphAlgorithms

                        fn = getattr(GraphAlgorithms(g), algo)
                    res = fn()
                    out = self._render_algo(algo, res)
                except Exception as e:  # noqa: BLE001
                    out = f'<p class="err">{_esc(e)}</p>'
        return _page("graph algorithms", form + out)

    @staticmethod
    def _render_algo(algo: str, res) -> str:
        if isinstance(res, dict):
            top = sorted(res.items(), key=lambda kv: -kv[1]
                         if isinstance(kv[1], (int, float)) else 0)[:25]
            return _table(("node", algo), [
                (k, f"{v:.6f}" if isinstance(v, float) else _esc(v))
                for k, v in top])
        return f"<p>{algo}: <code>{_esc(res)}</code></p>"

    # -- metrics (handlers/metrics.rs) -----------------------------------
    def _metrics_dashboard(self) -> str:
        m = self.router.metrics
        snap = m.snapshot()
        rows = [(k, v["count"], v["errors"], v["avg_ms"], v["max_ms"])
                for k, v in sorted(snap.items())]
        slow = "".join(
            f"<li><code>{q['ms']} ms</code> {_esc(q['query'][:140])}"
            "</li>" for q in m.slow_queries()[-15:])
        body = (_table(("kind", "count", "errors", "avg ms", "max ms"),
                       rows)
                + f"<h2>slow queries</h2><ul>{slow or '<li>none</li>'}"
                "</ul><p>JSON: "
                '<a href="/api/metrics">/api/metrics</a></p>')
        return _page("metrics", body)

    # -- achievements (handlers/achievements.rs) -------------------------
    def _achievements_page(self) -> str:
        if self.tracker is None:
            return _page("achievements", "<p>tracking disabled</p>")
        prog = self.tracker.snapshot()
        tier_color = {"bronze": "#cd7f32", "silver": "#c0c0c0",
                      "gold": "#fbbf24", "platinum": "#7dd3fc"}
        rows = [(f'<span style="color:'
                 f'{tier_color[a["tier"]]}">{_esc(a["name"])}</span>',
                 _esc(a["description"]), a["tier"],
                 "✓" if a["unlocked"] else "")
                for a in prog["achievements"]]
        body = (f"<p>level <code>{prog['level']}</code> · "
                f"{prog['xp']} XP · streak "
                f"<code>{prog['streak_days']}d</code></p>"
                + _table(("achievement", "description", "tier",
                          "unlocked"), rows))
        return _page("achievements", body)

    # -- JSON APIs --------------------------------------------------------
    def _api_subgraph(self, q: dict) -> dict:
        """Subgraph JSON around a center node (the reference's HTMX
        /api/graph/subgraph)."""
        g = self.router.graph
        center = int(q.get("center", -1))
        depth = min(int(q.get("depth", 1)), 4)
        if center < 0 or not g.node_exists(center):
            with g._lock:
                ids = sorted(g._nodes)[:25]
        else:
            seen = {center}
            frontier = [center]
            for _ in range(depth):
                nxt = []
                for nid in frontier:
                    for nb in g.neighbors(nid, direction="both"):
                        if nb not in seen:
                            seen.add(nb)
                            nxt.append(nb)
                frontier = nxt
            ids = sorted(seen)[:200]
        shown = set(ids)
        nodes = [{"id": nid, **(g.get_node(nid) or {})}
                 for nid in ids]
        edges = []
        with g._lock:
            for eid, e in g._edges.items():
                if e["src"] in shown and e["dst"] in shown:
                    edges.append({"id": eid, "src": e["src"],
                                  "dst": e["dst"], "type": e["type"]})
                if len(edges) >= 500:
                    break
        return {"nodes": nodes, "edges": edges}

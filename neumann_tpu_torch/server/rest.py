"""REST API facade (the reference's axum REST layer, Qdrant-style).

Endpoints (JSON in/out):
  GET  /health
  GET  /metrics
  POST /query                         {"query": "..."}
  PUT  /collections/{name}            {"dimension", "metric", "quantization"}
  GET  /collections
  DELETE /collections/{name}
  PUT  /collections/{name}/points     {"points": [{id, vector, payload}]}
  POST /collections/{name}/points/query
                                      {"vector": [...], "limit", "filter"}
  POST /collections/{name}/points/delete  {"ids": [...]}

stdlib http.server with a thread pool — the control-plane surface; bulk
traffic belongs on the gRPC service.

The port's copy of ``neumann_tpu/server/rest.py``, serving the port's
``QueryRouter(device=device)`` (``device`` "cuda" unless the caller asks
for the CPU, or passes a router of its own). Changes besides the import
lines and ``device``: ``/health`` and the dashboard
report the router's torch device type where the reference asks JAX for
its devices. And the listening socket's backlog is 128, not the
standard library's 5: with the reference's 5, connections past the
fifth concurrent one lose their handshake and retry 1-3 s later, or are
reset (32 concurrent clients saw both).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from neumann_tpu_torch.router import QueryRouter
from neumann_tpu_torch.server.server import dumps
from neumann_tpu_torch.utils.errors import NeumannError


class _HTTPServer(ThreadingHTTPServer):
    request_queue_size = 128     # listen backlog (socketserver's is 5)


class RestServer:
    def __init__(self, router: Optional[QueryRouter] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 api_keys=None, grpc_web=None, device="cuda"):
        """grpc_web: a GrpcWebGateway (or NeumannServer, whose gateway is
        taken) to serve browser gRPC-web traffic on this HTTP port.
        device: where the router built when none is given runs."""
        self.router = router or QueryRouter(device=device)
        if grpc_web is not None and hasattr(grpc_web, "web_gateway"):
            grpc_web = grpc_web.web_gateway()
        self._grpc_web = grpc_web
        from neumann_tpu_torch.server.gamification import ProgressTracker

        self.tracker = ProgressTracker()
        self.router.metrics.listeners.append(
            lambda kind, ms, err: self.tracker.record(kind, ms))
        from neumann_tpu_torch.server.admin import AdminApp

        self._admin = AdminApp(self.router, self.tracker)
        keys = set(api_keys) if api_keys else None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            _MAX_BODY = 64 * 1024 * 1024

            def _body(self):
                length = int(self.headers.get("Content-Length") or 0)
                if not length:
                    return {}
                if length > self._MAX_BODY:
                    raise NeumannError(
                        f"request body too large ({length} bytes)")
                raw = self.rfile.read(length) or b"{}"
                ctype = (self.headers.get("Content-Type") or "")
                if ctype.startswith(
                        "application/x-www-form-urlencoded"):
                    # admin-page HTML forms post urlencoded bodies
                    from urllib.parse import parse_qs

                    return {k: v[-1] for k, v in parse_qs(
                        raw.decode("utf-8", "replace")).items()}
                try:
                    parsed = json.loads(raw)
                except (ValueError, UnicodeDecodeError) as e:
                    # a malformed body is the CLIENT's error: 400
                    raise NeumannError(
                        f"malformed JSON body: {e}") from None
                if not isinstance(parsed, dict):
                    raise NeumannError(
                        "request body must be a JSON object")
                return parsed

            def _send(self, code: int, payload) -> None:
                if isinstance(payload, tuple):  # (body, content-type)
                    blob = payload[0].encode("utf-8")
                    ctype = payload[1]
                elif isinstance(payload, str):  # pre-rendered HTML
                    blob = payload.encode("utf-8")
                    ctype = "text/html; charset=utf-8"
                else:
                    blob = dumps(payload).encode("utf-8")
                    ctype = "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def _auth(self) -> bool:
                if keys is None:
                    return True
                if self.headers.get("x-api-key") in keys:
                    return True
                self._send(401, {"error": "invalid API key"})
                return False

            def _route(self, method: str) -> None:
                if not self._auth():
                    return
                try:
                    out = outer._dispatch(method, self.path,
                                          self._body())
                    self._send(200, out)
                except NeumannError as e:
                    self._send(400, {"error": str(e)})
                except Exception as e:  # noqa: BLE001
                    self._send(500, {"error":
                                     f"{type(e).__name__}: {e}"})

            def _cors(self):
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Access-Control-Allow-Headers",
                                 "content-type,x-api-key,x-request-id,"
                                 "x-grpc-web,x-user-agent")
                self.send_header("Access-Control-Expose-Headers",
                                 "grpc-status,grpc-message")

            def do_OPTIONS(self):  # CORS preflight for grpc-web
                self.send_response(204)
                self._cors()
                self.send_header("Access-Control-Allow-Methods",
                                 "POST, GET, OPTIONS")
                self.end_headers()

            def do_GET(self):
                self._route("GET")

            def do_POST(self):
                from neumann_tpu_torch.server.grpc_web import GrpcWebGateway

                ctype = self.headers.get("Content-Type")
                if (outer._grpc_web is not None
                        and GrpcWebGateway.is_grpc_web(ctype)):
                    # this port's api_keys gate grpc-web traffic too —
                    # mounting the gateway must not open a key-free
                    # side door (the gRPC server's own auth still
                    # applies inside the replayed handlers)
                    if not self._auth():
                        return
                    length = int(self.headers.get("Content-Length") or 0)
                    if length > self._MAX_BODY:
                        self.send_response(413)
                        self.end_headers()
                        return
                    raw = self.rfile.read(length) if length else b""
                    body, out_type = outer._grpc_web.handle(
                        self.path, self.headers, raw)
                    self.send_response(200)
                    self.send_header("Content-Type", out_type)
                    self.send_header("Content-Length", str(len(body)))
                    self._cors()
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self._route("POST")

            def do_PUT(self):
                self._route("PUT")

            def do_DELETE(self):
                self._route("DELETE")

        self._httpd = _HTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _dispatch(self, method: str, path: str, body: dict):
        parts = [p for p in path.split("?")[0].split("/") if p]
        if method == "GET" and not parts:
            return self._dashboard()
        if method == "GET" and parts == ["health"]:
            return {"ok": True,
                    "entries": len(self.router.store),
                    "device": self.router.vector.device.type}
        if method == "GET" and parts == ["metrics"]:
            return {"statements": self.router.metrics.snapshot(),
                    "slow_queries": self.router.metrics.slow_queries()}
        if method == "GET" and parts == ["achievements"]:
            vec_count = sum(
                c.count() for by_dim in
                self.router.vector._corpora.values()
                for c in by_dim.values())
            self.tracker.record_embeddings(vec_count)
            return self.tracker.snapshot()
        if method == "GET" and parts == ["graph", "viz"]:
            return (self._graph_svg(), "image/svg+xml")
        if method == "POST" and parts == ["query"]:
            res = self.router.execute(body["query"])
            return {"kind": res.kind, "message": res.message,
                    "rows": res.rows, "hits": res.results,
                    "count": res.count, "value": res.value}
        if parts and parts[0] == "collections":
            return self._collections(method, parts[1:], body)
        routed = self._admin.dispatch(method, path, body)
        if routed is not None:
            payload, ctype = routed
            return (payload, ctype) if ctype else payload
        raise NeumannError(f"no route {method} {path}")

    def _graph_svg(self, max_nodes: int = 60) -> str:
        """Inline SVG graph visualization (the reference's web graph-viz
        handler role): a sampled circular layout of nodes and edges."""
        import math

        g = self.router.graph
        nodes = g.find_nodes(limit=max_nodes)
        ids = [n["id"] for n in nodes]
        pos = {}
        r, cx, cy = 220, 300, 260
        for i, nid in enumerate(ids):
            a = 2 * math.pi * i / max(len(ids), 1)
            pos[nid] = (cx + r * math.cos(a), cy + r * math.sin(a))
        lines = []
        shown = set(ids)
        for nid in ids:
            for eid in g._out.get(nid, [])[:20]:
                e = g._edges.get(eid)
                if e and e["dst"] in shown:
                    x1, y1 = pos[nid]
                    x2, y2 = pos[e["dst"]]
                    lines.append(
                        f'<line x1="{x1:.0f}" y1="{y1:.0f}" '
                        f'x2="{x2:.0f}" y2="{y2:.0f}" '
                        f'stroke="#33404f" stroke-width="1"/>')
        dots = []
        for n in nodes:
            x, y = pos[n["id"]]
            label = (n.get("label") or "")[:10]
            dots.append(
                f'<circle cx="{x:.0f}" cy="{y:.0f}" r="7" '
                f'fill="#7dd3fc"/>'
                f'<text x="{x + 9:.0f}" y="{y + 4:.0f}" fill="#94a3b8" '
                f'font-size="10">{n["id"]}:{label}</text>')
        return (
            '<svg xmlns="http://www.w3.org/2000/svg" width="620" '
            'height="540" style="background:#101418;font-family:'
            'monospace">'
            f'<text x="12" y="20" fill="#7dd3fc" font-size="14">graph '
            f'({g.node_count()} nodes / {g.edge_count()} edges, showing '
            f'{len(nodes)})</text>'
            + "".join(lines) + "".join(dots) + "</svg>")

    def _dashboard(self) -> str:
        """Web admin status page (the reference's axum dashboard role)."""
        r = self.router
        vec_count = sum(
            c.count() for by_dim in r.vector._corpora.values()
            for c in by_dim.values())
        rows = "".join(
            f"<tr><td>{n}</td><td>{st['count']}</td>"
            f"<td>{st['dimension']}</td><td>{st['metric']}</td>"
            f"<td>{st['quantization']}</td></tr>"
            for n, st in ((n, r.vector.collection_stats(n))
                          for n in r.vector.list_collections()))
        metrics = "".join(
            f"<tr><td>{k}</td><td>{v['count']}</td><td>{v['errors']}</td>"
            f"<td>{v['avg_ms']}</td><td>{v['max_ms']}</td></tr>"
            for k, v in sorted(r.metrics.snapshot().items()))
        slow = "".join(
            f"<li><code>{q['ms']} ms</code> {q['query'][:120]}</li>"
            for q in r.metrics.slow_queries()[-10:])
        prog = self.tracker.snapshot()
        tier_color = {"bronze": "#cd7f32", "silver": "#c0c0c0",
                      "gold": "#fbbf24", "platinum": "#7dd3fc"}
        badges = " ".join(
            f'<span title="{a["description"]}" style="border:1px solid '
            f'{tier_color[a["tier"]]};border-radius:4px;padding:2px 6px;'
            f'color:{tier_color[a["tier"]]}">{a["name"]}</span>'
            for a in prog["achievements"] if a["unlocked"])
        dev = r.vector.device.type
        return f"""<!doctype html><html><head><title>neumann-tpu</title>
<style>body{{font-family:monospace;margin:2em;background:#101418;
color:#d7e0ea}}table{{border-collapse:collapse;margin:1em 0}}
td,th{{border:1px solid #33404f;padding:4px 10px}}h1{{color:#7dd3fc}}
h2{{color:#94a3b8}}code{{color:#fbbf24}}</style></head><body>
<h1>neumann-tpu</h1>
<p>device: <code>{dev}</code> · store entries:
<code>{len(r.store)}</code> · embeddings: <code>{vec_count}</code> ·
graph: <code>{r.graph.node_count()}</code> nodes /
<code>{r.graph.edge_count()}</code> edges · tables:
<code>{len(r.relational.list_tables())}</code></p>
<h2>collections</h2>
<table><tr><th>name</th><th>count</th><th>dim</th><th>metric</th>
<th>quant</th></tr>{rows or '<tr><td colspan=5>none</td></tr>'}</table>
<h2>statement metrics</h2>
<table><tr><th>kind</th><th>count</th><th>errors</th><th>avg ms</th>
<th>max ms</th></tr>{metrics or '<tr><td colspan=5>none</td></tr>'}
</table>
<h2>slow queries</h2><ul>{slow or '<li>none</li>'}</ul>
<h2>progress</h2>
<p>level <code>{prog['level']}</code> · {prog['xp']} XP ·
{len(prog['unlocked'])} achievements · streak
<code>{prog['streak_days']}d</code></p>
<p>{badges or 'no achievements yet — run a query'}</p>
<h2>graph</h2>{self._graph_svg(40)}
<p>admin: <a href="/relational" style="color:#7dd3fc">relational</a> ·
<a href="/vector" style="color:#7dd3fc">vector</a> ·
<a href="/graph" style="color:#7dd3fc">graph</a> ·
<a href="/graph/algorithms" style="color:#7dd3fc">algorithms</a> ·
<a href="/metrics/dashboard" style="color:#7dd3fc">metrics</a> ·
<a href="/achievements/page" style="color:#7dd3fc">achievements</a></p>
<p>JSON API: <a href="/health" style="color:#7dd3fc">/health</a> ·
<a href="/metrics" style="color:#7dd3fc">/metrics</a> ·
<a href="/collections" style="color:#7dd3fc">/collections</a> ·
<a href="/achievements" style="color:#7dd3fc">/achievements</a> ·
<a href="/api/metrics" style="color:#7dd3fc">/api/metrics</a> ·
<a href="/api/graph/subgraph" style="color:#7dd3fc">subgraph</a> ·
<a href="/graph/viz" style="color:#7dd3fc">/graph/viz</a></p>
</body></html>"""

    def _collection_vector(self, name: str, pid: str):
        data = self.router.store.get(f"col:{name}:{pid}")
        emb = data.get("embedding") if data else None
        return emb.to_dense().tolist() if emb is not None else None

    def _collections(self, method: str, parts, body: dict):
        from neumann_tpu_torch.engines.vector import VectorCollectionConfig
        from neumann_tpu_torch.server.server import _filter_from_json

        vec = self.router.vector
        if method == "GET" and not parts:
            return {"collections": [vec.collection_stats(n)
                                    for n in vec.list_collections()]}
        name = parts[0] if parts else None
        if method == "GET" and len(parts) == 1:
            if name not in vec.list_collections():
                raise NeumannError(f"no collection '{name}'")
            return {"result": vec.collection_stats(name)}
        if method == "PUT" and len(parts) == 1:
            # accept both our flat shape and Qdrant's nested one
            # ({"vectors": {"size": N, "distance": "Cosine"}})
            qv = body.get("vectors")
            if not isinstance(qv, dict):
                qv = {}
            dim = body.get("dimension", qv.get("size"))
            if dim is not None and (isinstance(dim, bool)
                                    or not isinstance(dim, int)):
                raise NeumannError("'dimension' must be an integer")
            metric = body.get(
                "metric", str(qv.get("distance", "cosine")).lower())
            if not isinstance(metric, str):
                raise NeumannError("'metric' must be a string")
            # Qdrant distance aliases; our own ten names pass through
            # and VectorCollectionConfig rejects unknowns with a 400
            metric = {"euclid": "euclidean",
                      "dot_product": "dot"}.get(metric.lower(),
                                                metric.lower())
            quant = body.get("quantization", "none")
            if not isinstance(quant, str):
                raise NeumannError("'quantization' must be a string")
            vec.create_collection(name, VectorCollectionConfig(
                dimension=dim, metric=metric, quantization=quant))
            return {"ok": True}
        if method == "DELETE" and len(parts) == 1:
            return {"ok": vec.drop_collection(name)}
        if len(parts) >= 2 and parts[1] == "points":
            if method == "PUT":
                pts = body.get("points", [])
                if not isinstance(pts, list):
                    raise NeumannError("'points' must be a list")
                for p in pts:
                    if not isinstance(p, dict) or "id" not in p:
                        raise NeumannError(
                            "each point needs an 'id' field")
                    v = p.get("vector")
                    if not isinstance(v, (list, tuple)) or not all(
                            isinstance(x, (int, float)) for x in v):
                        raise NeumannError(
                            f"point {p['id']!r} needs a numeric "
                            "'vector' list")
                if name not in vec.list_collections():
                    vec.create_collection(name)
                for p in pts:
                    vec.store_in_collection(name, str(p["id"]),
                                            p["vector"],
                                            p.get("payload"))
                return {"upserted": len(pts)}
            if method == "POST" and len(parts) == 3 and \
                    parts[2] == "query":
                qv = body.get("vector")
                if not isinstance(qv, (list, tuple)) or not all(
                        isinstance(x, (int, float)) for x in qv):
                    raise NeumannError(
                        "points query requires a numeric 'vector' "
                        "list")
                filt = None
                if body.get("filter"):
                    filt = _filter_from_json(body["filter"])
                if filt is not None:
                    hits = vec.search_filtered_in_collection(
                        name, body["vector"], body.get("limit", 10),
                        filt)
                else:
                    hits = vec.search_in_collection(
                        name, body["vector"], body.get("limit", 10))
                return {"result": [{"id": h.key, "score": h.score}
                                   for h in hits]}
            if method == "POST" and len(parts) == 3 and \
                    parts[2] == "delete":
                n = sum(1 for pid in body.get("ids", [])
                        if vec.delete_from_collection(name, str(pid)))
                return {"deleted": n}
            if method == "POST" and len(parts) == 3 and \
                    parts[2] == "get":
                out = []
                for pid in body.get("ids", []):
                    v = self._collection_vector(name, str(pid))
                    if v is not None:
                        out.append({"id": str(pid), "vector": v})
                return {"points": out}
            if method == "POST" and len(parts) == 3 and \
                    parts[2] == "scroll":
                prefix = f"col:{name}:"
                keys = sorted(k[len(prefix):]
                              for k in self.router.store.scan(prefix))
                offset = body.get("offset")
                if offset:
                    keys = [k for k in keys if k > str(offset)]
                try:
                    limit = max(0, int(body.get("limit", 100)))
                except (TypeError, ValueError):
                    raise NeumannError(
                        "'limit' must be an integer") from None
                page = keys[:limit]
                pts = [{"id": pid,
                        "vector": self._collection_vector(name, pid)
                        or []} for pid in page]
                return {"points": pts,
                        "next_offset": (page[-1]
                                        if page and len(keys) > limit
                                        else None)}
        raise NeumannError(f"no route {method} /{'/'.join(parts)}")

    # ------------------------------------------------------------------
    def serve(self) -> int:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

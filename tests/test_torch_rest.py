"""The port's REST server against the JAX package's: one script of HTTP
requests to a JAX ``RestServer`` and a port ``RestServer`` (CPU router),
each on 127.0.0.1:0.

Every step gets the same status code from both. JSON bodies are equal
apart from timing fields (scores and other floats within 1e-5; the
metrics' milliseconds and what depends on them — the ``sub_ms``
achievement and the XP it brings — are left out). HTML pages are equal
text (numbers within 1e-4) where they hold no timings, else the same
status and content type. The script covers /health, /metrics,
/achievements, /query with SQL, graph, SIMILAR and hybrid statements,
the Qdrant-style collection and points routes with and without a
filter, the admin pages, bad bodies (400) and a bad route.
"""

import http.client
import json
import re

import numpy as np
import pytest

from neumann_tpu.router import QueryRouter as JRouter
from neumann_tpu.server.rest import RestServer as JRest
from neumann_tpu_torch.router import QueryRouter as TRouter
from neumann_tpu_torch.server import RestServer as TRest
from neumann_tpu_torch.utils.errors import NeumannError

D = 8
_VECS = np.random.default_rng(11).standard_normal((12, D)).round(4)


def _lit(v):
    return "[" + ", ".join(f"{x:.4f}" for x in v) + "]"


@pytest.fixture(scope="module")
def servers():
    jr = JRouter()
    jr.vector.config.mesh_auto = False
    out = []
    for srv in (JRest(jr), TRest(TRouter(device="cpu"))):
        srv.serve()
        out.append(srv)
    yield out
    for srv in out:
        srv.stop()


def _call(port, method, path, body=None, raw=None, ctype=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    headers = {"Content-Type": ctype or "application/json"} if data else {}
    conn.request(method, path, body=data, headers=headers)
    resp = conn.getresponse()
    out = resp.status, resp.getheader("Content-Type"), resp.read().decode()
    conn.close()
    return out


def _close(a, b, path="$", atol=1e-5):
    if isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, (int, float)) and isinstance(b, (int, float)), \
            (path, a, b)
        assert abs(a - b) <= atol, (path, a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            _close(a[k], b[k], f"{path}.{k}", atol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]", atol)
    else:
        assert a == b, (path, a, b)


_NUM = re.compile(r"(-?\d+\.\d+(?:[eE][-+]?\d+)?)")


def _html_close(a, b):
    pa, pb = _NUM.split(a), _NUM.split(b)
    assert len(pa) == len(pb), (a, b)
    for i, (x, y) in enumerate(zip(pa, pb)):
        if i % 2:
            assert abs(float(x) - float(y)) <= 1e-4 * max(1.0, abs(float(y)))
        else:
            assert x == y, (x, y)


def _untimed_metrics(snap):
    # which queries were slow is timing too: only that the list is there
    return {"statements": {k: {f: v[f] for f in ("count", "errors")}
                           for k, v in snap["statements"].items()},
            "slow_queries": type(snap["slow_queries"]).__name__}


def _untimed_achievements(snap):
    keep = {k: v for k, v in snap.items()
            if k in ("queries", "streak_days", "unlocked", "achievements")}
    keep["unlocked"] = [a for a in keep["unlocked"] if a != "sub_ms"]
    keep["achievements"] = [a for a in keep["achievements"]
                            if a["id"] != "sub_ms"]
    return keep


# (method, path, body, how to compare): "json" equal JSON, "html" equal
# text, "status" status and content type only; a body of bytes is sent
# as is (bad bodies). "json_self" is a euclidean query for a stored row:
# its own distance is the square root of an f32 cancellation residual
# (about sqrt(2^-24 * |q|^2) ~ 7e-4 at |q|^2 ~ 8, and int8 rows add their
# rounding), which neither package computes to better than ~1e-3, so
# those scores agree within 1e-3
SCRIPT = [
    ("GET", "/health", None, "json"),
    ("POST", "/query", {"query": "CREATE TABLE users (id INT PRIMARY KEY, "
                                 "name TEXT, age INT)"}, "json"),
    ("POST", "/query", {"query": "INSERT INTO users VALUES (1, 'alice', 30),"
                                 " (2, 'bob', 25), (3, 'carol', 41)"}, "json"),
    ("POST", "/query", {"query": "SELECT name, age FROM users WHERE age > 26 "
                                 "ORDER BY age DESC"}, "json"),
    ("POST", "/query", {"query": "SELECT COUNT(*) FROM users"}, "json"),
    ("POST", "/query", {"query": "UPDATE users SET age = 31 WHERE id = 1"},
     "json"),
    ("POST", "/query", {"query": "NODE CREATE person {name: 'ada'}"}, "json"),
    ("POST", "/query", {"query": "NODE CREATE person {name: 'alan'}"},
     "json"),
    ("POST", "/query", {"query": "NODE CREATE city {name: 'rome'}"}, "json"),
    ("POST", "/query", {"query": "EDGE CREATE 0 -> 1 : knows"}, "json"),
    ("POST", "/query", {"query": "EDGE CREATE 1 -> 2 : lives_in"}, "json"),
    ("POST", "/query", {"query": "NEIGHBORS 0 OUTGOING : knows"}, "json"),
    ("POST", "/query", {"query": "PATH SHORTEST 0 TO 2"}, "json"),
    ("POST", "/query", {"query": "MATCH (a)-[:knows]->(b) RETURN b.name"},
     "json"),
] + [
    ("POST", "/query", {"query": f"EMBED STORE 'v{i}' {_lit(_VECS[i])}"},
     "json") for i in range(6)
] + [
    ("POST", "/query", {"query": f"SIMILAR {_lit(_VECS[2])} TOP 3"}, "json"),
    ("POST", "/query", {"query": "SIMILAR 'v4' TOP 2 METRIC euclidean"},
     "json_self"),
    ("POST", "/query", {"query": "COUNT EMBEDDINGS"}, "json"),
    ("POST", "/query", {"query": f"ENTITY CREATE 'e0' {{ tier: 1 }} "
                                 f"EMBEDDING {_lit(_VECS[6])}"}, "json"),
    ("POST", "/query", {"query": f"ENTITY CREATE 'e1' {{ tier: 2 }} "
                                 f"EMBEDDING {_lit(_VECS[7])}"}, "json"),
    ("POST", "/query", {"query": f"ENTITY CREATE 'e2' {{ tier: 1 }} "
                                 f"EMBEDDING {_lit(_VECS[8])}"}, "json"),
    ("POST", "/query", {"query": "ENTITY CONNECT 'e0' -> 'e1' : rel"},
     "json"),
    ("POST", "/query", {"query": "ENTITY CONNECT 'e0' -> 'e2' : rel"},
     "json"),
    ("POST", "/query", {"query": f"SIMILAR {_lit(_VECS[8])} TOP 2 "
                                 "CONNECTED TO 'e0'"}, "json"),
    ("POST", "/query", {"query": "FIND ENTITY WHERE tier = 1"}, "json"),
    ("PUT", "/collections/docs", {"dimension": D, "metric": "cosine"},
     "json"),
    ("PUT", "/collections/q8", {"vectors": {"size": D, "distance": "Euclid"},
                                "quantization": "int8"}, "json"),
    ("GET", "/collections", None, "json"),
    ("GET", "/collections/docs", None, "json"),
    ("PUT", "/collections/docs/points", {"points": [
        {"id": f"p{i}", "vector": _VECS[i].tolist(),
         "payload": {"grp": i % 3, "tag": f"t{i}"}} for i in range(12)]},
     "json"),
    ("PUT", "/collections/q8/points", {"points": [
        {"id": i, "vector": _VECS[i].tolist()} for i in range(12)]}, "json"),
    ("POST", "/collections/docs/points/query",
     {"vector": _VECS[3].tolist(), "limit": 4}, "json"),
    ("POST", "/collections/docs/points/query",
     {"vector": _VECS[3].tolist(), "limit": 4,
      "filter": {"op": "eq", "field": "grp", "value": 1}}, "json"),
    ("POST", "/collections/docs/points/query",
     {"vector": _VECS[5].tolist(), "limit": 5,
      "filter": {"op": "or", "left": {"op": "eq", "field": "grp",
                                      "value": 2},
                 "right": {"op": "exists", "field": "nope"}}}, "json"),
    ("POST", "/collections/q8/points/query",
     {"vector": _VECS[9].tolist(), "limit": 3}, "json_self"),
    ("POST", "/collections/docs/points/get", {"ids": ["p1", "p7", "zz"]},
     "json"),
    ("POST", "/collections/docs/points/scroll", {"limit": 5}, "json"),
    ("POST", "/collections/docs/points/scroll",
     {"limit": 5, "offset": "p3"}, "json"),
    ("POST", "/collections/docs/points/delete", {"ids": ["p0", "p11", "x"]},
     "json"),
    ("POST", "/collections/docs/points/query",
     {"vector": _VECS[0].tolist(), "limit": 3}, "json"),
    ("DELETE", "/collections/q8", None, "json"),
    ("GET", "/collections", None, "json"),
    ("GET", "/metrics", None, "metrics"),
    ("GET", "/achievements", None, "achievements"),
    ("GET", "/", None, "status"),
    ("GET", "/relational", None, "html"),
    ("GET", "/relational/users", None, "html"),
    ("GET", "/relational/users/rows?limit=2&offset=1", None, "html"),
    ("GET", "/vector", None, "html"),
    ("GET", "/vector/docs", None, "html"),
    ("GET", "/vector/docs/points", None, "html"),
    ("GET", "/vector/docs/points/p2", None, "html"),
    ("GET", "/vector/docs/points/nope", None, "html"),
    ("POST", "/vector/docs/search", b"vector=0.1,0.2,0.3,0.4,0.5,0.6,0.7,0.8"
     b"&limit=3", "html"),
    ("GET", "/graph", None, "html"),
    ("GET", "/graph/nodes?label=person", None, "html"),
    ("GET", "/graph/edges", None, "html"),
    ("POST", "/graph/path", b"src=0&dst=2", "html"),
    ("GET", "/graph/algorithms", None, "html"),
    ("POST", "/graph/algorithms", b"algo=pagerank", "html"),
    ("GET", "/graph/viz", None, "html"),
    ("GET", "/api/graph/subgraph?center=0&depth=2", None, "json"),
    ("GET", "/api/metrics", None, "metrics"),
    ("GET", "/metrics/dashboard", None, "status"),
    ("GET", "/achievements/page", None, "status"),
    # bad bodies and routes
    ("POST", "/query", b"{not json", "json"),
    ("POST", "/query", b"[1, 2]", "json"),
    ("POST", "/query", {"nothing": 1}, "json"),
    ("POST", "/query", {"query": "SELEC * FROM users"}, "json"),
    ("POST", "/query", {"query": "SELECT * FROM missing"}, "json"),
    ("PUT", "/collections/bad", {"dimension": "eight"}, "json"),
    ("PUT", "/collections/bad", {"dimension": 4, "metric": "nope"}, "json"),
    ("PUT", "/collections/docs/points", {"points": [{"vector": [1.0]}]},
     "json"),
    ("POST", "/collections/docs/points/query", {"vector": "abc"}, "json"),
    ("POST", "/collections/docs/points/scroll", {"limit": "x"}, "json"),
    ("GET", "/no/such/route", None, "json"),
    ("DELETE", "/health", None, "json"),
]


@pytest.fixture(scope="module")
def answers(servers):
    """SCRIPT run in order against both servers: per step the (status,
    content type, body) of the JAX server and of the port's."""
    out = []
    for method, path, body, _ in SCRIPT:
        got = []
        for srv in servers:
            if isinstance(body, bytes):
                form = path.startswith(("/vector/", "/graph/"))
                got.append(_call(srv.port, method, path, raw=body, ctype=(
                    "application/x-www-form-urlencoded" if form else None)))
            else:
                got.append(_call(srv.port, method, path, body))
        out.append(got)
    return out


@pytest.mark.parametrize("step", range(len(SCRIPT)))
def test_same_answers(answers, step):
    """Step ``step`` of SCRIPT answers alike on both servers."""
    _, path, _, how = SCRIPT[step]
    (js, jt, jb), (ts, tt, tb) = answers[step]
    assert ts == js, (path, jb, tb)
    assert tt == jt
    if how == "status":
        assert "<html" in tb
        return
    if how == "html":
        _html_close(tb, jb)
        return
    jv, tv = json.loads(jb), json.loads(tb)
    if how == "metrics":
        jv, tv = _untimed_metrics(jv), _untimed_metrics(tv)
    elif how == "achievements":
        jv, tv = _untimed_achievements(jv), _untimed_achievements(tv)
    _close(tv, jv, atol=1e-3 if how == "json_self" else 1e-5)


def test_dashboard_and_health_report_the_torch_device(servers):
    _, port_srv = servers
    _, _, body = _call(port_srv.port, "GET", "/health")
    assert json.loads(body)["device"] == "cpu"
    _, _, html = _call(port_srv.port, "GET", "/")
    assert "device: <code>cpu</code>" in html



def test_json_of_port_results_takes_torch_values():
    """Port results may hold tensors, dtypes and devices; ``in`` filters
    from JSON carry tuples, so a batcher can key cohorts by them."""
    import torch

    from neumann_tpu_torch.server.server import _filter_from_json, dumps

    assert json.loads(dumps({"t": torch.arange(3), "s": torch.tensor(2.5),
                             "d": torch.float32, "v": torch.device("cpu"),
                             "n": np.int64(4)})) == {
        "t": [0, 1, 2], "s": 2.5, "d": "torch.float32", "v": "cpu", "n": 4}
    f = _filter_from_json({"op": "in", "field": "grp", "value": [1, 2]})
    assert f.value == (1, 2) and hash(f)
    with pytest.raises(NeumannError):
        _filter_from_json({"op": "in", "field": "grp", "value": 3})

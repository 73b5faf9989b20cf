"""The port's gRPC server (``neumann_tpu_torch.server.server``), its
gRPC-web gateway, memory budget, entry points and OTLP export, on the
CPU.

The JAX package's own tests of these run on the port as its twins
(``twin_tests(..., packages=("port",))``: the JAX side runs in its own
files): all of tests/test_server.py, test_grpc_web.py and the C++ and
TypeScript client conformance files, the memory-budget tests of
test_memory_temporal.py, the server tests of test_entrypoints.py and the
OTLP tests of test_tiered_observability.py. The twin loader asks the
port's card-default entry points for the CPU (``NeumannServer``,
``RestServer``, ``NeumannClient.embedded``, ``main``).

Then a JAX and a port ``NeumannServer`` answer the same Execute scripts
and Points queries alike (kind, rows and hits; keys and scores within
1e-5 on the pooled route, exact on the flat scan), a port client talks
to a JAX server and a JAX client to a port server, and a port
``RestServer(grpc_web=NeumannServer(...))`` serves an Execute.
"""

import http.client

import numpy as np
import pytest

from tests.torch_twins import twin_tests

_PORT = ("port",)

globals().update(twin_tests("test_server", packages=_PORT))
globals().update(twin_tests("test_grpc_web", packages=_PORT))
globals().update(twin_tests("test_cpp_client_conformance", packages=_PORT))
globals().update(twin_tests("test_ts_client_conformance", packages=_PORT))
globals().update(twin_tests("test_memory_temporal", (
    "TestMemoryTracker.test_accounting",
    "TestMemoryTracker.test_shedding_disabled_tracks_anyway",
    "TestMemoryTracker.test_reservation_context",
    "TestMemoryTracker.test_server_sheds_over_budget",
    "TestMutationKills.test_budget_defaults_and_boundaries",
    "TestMutationKills.test_reservation_propagates_exceptions",
), packages=_PORT))
globals().update(twin_tests("test_entrypoints", (
    "test_server_main_module", "test_server_main_flags",
    "test_server_main_help"), packages=_PORT))
globals().update(twin_tests("test_tiered_observability", (
    "test_otlp_metrics_json_shape", "test_otlp_http_push_and_span_recorder",
    "test_otlp_file_endpoint_and_collector_down"), packages=_PORT))


# ------------------------------------------------ the JAX server beside


N, D = 4096, 64


def _vec(v):
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


@pytest.fixture(scope="module")
def pair():
    """A JAX and a port ``NeumannServer`` on the same rows, batched
    serving on: 4,096 x 64 clustered rows in the default namespace and in
    an int8 (``q8``) and a binary (``bits``) collection, 256 of them in a
    flat collection under the pooled gate (``flat``); metadata cat =
    i % 4. With the pooled gate lowered (as tests/test_torch_collections
    .py does) the default namespace and ``q8`` take the pooled routes."""
    from neumann_tpu.engines.vector import VectorCollectionConfig as JColl
    from neumann_tpu.engines.vector import VectorEngineConfig as JConfig
    from neumann_tpu.router import QueryRouter as JRouter
    from neumann_tpu.server.server import NeumannServer as JServer
    from neumann_tpu_torch.engines.vector import \
        VectorCollectionConfig as TColl
    from neumann_tpu_torch.server.server import NeumannServer as TServer

    rng = np.random.default_rng(15)
    cents = rng.standard_normal((32, D)).astype(np.float32) * 2
    v = (cents[rng.integers(0, 32, N)]
         + 0.4 * rng.standard_normal((N, D))).astype(np.float32)
    qs = (v[rng.choice(N, 16)]
          + 0.05 * rng.standard_normal((16, D))).astype(np.float32)
    jr = JRouter()
    jr.vector.config = JConfig(mesh_auto=False)
    servers = {"jax": JServer(jr), "port": TServer(device="cpu")}
    colls = {"jax": JColl, "port": TColl}
    for pkg, srv in servers.items():
        eng = srv.router.vector
        eng.batch_store_embeddings([(f"e{i}", v[i]) for i in range(N)])
        for name, quant, n in (("q8", "int8", N), ("bits", "binary", N),
                               ("flat", "none", 256)):
            eng.create_collection(name, colls[pkg](
                dimension=D, quantization=quant))
            with eng.bulk_ingest():
                for i in range(n):
                    eng.store_in_collection(name, f"k{i}", v[i],
                                            {"cat": i % 4})
        srv.serve(warmup=False)
    yield servers, v, qs
    for srv in servers.values():
        srv.stop()


@pytest.fixture
def pooled_env(monkeypatch):
    monkeypatch.setenv("NEUMANN_POOLED_MIN_ROWS", "1024")
    monkeypatch.setenv("NEUMANN_POOLED_MIN_POOLS", "64")


def _clients():
    from neumann_tpu.server.client import NeumannClient as JClient
    from neumann_tpu_torch.server.client import NeumannClient as TClient

    return {"jax": JClient, "port": TClient}


def _hits_alike(got, want, route):
    """Keys and scores alike. ``"bits"`` (hamming distances): equal, in
    order. ``"flat"`` (the exact f32 scan): keys equal in order, scores
    within 1e-6 (XLA and torch sum the dot products in different orders:
    a few ulps). ``"pooled"``: scores within 1e-5 and keys equal wherever
    no other score is within 2e-5."""
    key = "key" if want and "key" in want[0] else "id"
    assert len(got) == len(want)
    if route != "pooled":
        assert [h[key] for h in got] == [h[key] for h in want]
        np.testing.assert_allclose([h["score"] for h in got],
                                   [h["score"] for h in want], rtol=0,
                                   atol=0 if route == "bits" else 1e-6)
        return
    tol = 1e-5
    s_w = np.array([h["score"] for h in want])
    np.testing.assert_allclose([h["score"] for h in got], s_w, rtol=0,
                               atol=tol)
    for j, h in enumerate(want):
        if (np.abs(s_w - s_w[j]) <= 2 * tol).sum() == 1:
            assert got[j][key] == h[key], j


_ROUTE = {"flat": "flat", "bits": "bits", "q8": "pooled", "": "pooled"}


def test_jax_and_port_servers_answer_execute_alike(pair, pooled_env):
    """The same Execute script through each package's client to its own
    server: kind, message, rows, count, value and hits alike, errors
    alike."""
    from neumann_tpu_torch.utils.errors import NeumannError as TError
    from neumann_tpu.utils.errors import NeumannError as JError

    servers, v, qs = pair
    clients = {pkg: cls.connect(f"127.0.0.1:{servers[pkg].port}")
               for pkg, cls in _clients().items()}
    script = [
        "CREATE TABLE users (id INT PRIMARY KEY, name TEXT, age INT)",
        "INSERT INTO users VALUES (1, 'Alice', 30), (2, 'Bob', 25)",
        "SELECT * FROM users WHERE age > 26",
        "SELECT COUNT(*) FROM users",
        "NODE CREATE city {name: 'berlin'}",
        "NODE LIST city",
        f"EMBED STORE 'extra' {_vec(qs[0])}",
        "SHOW COLLECTIONS",
        "SELECT * FROM missing",
    ]
    try:
        for stmt in script:
            try:
                want = clients["jax"].execute(stmt)
            except JError as e:
                with pytest.raises(TError) as got:
                    clients["port"].execute(stmt)
                assert str(got.value) == str(e), stmt
                continue
            got = clients["port"].execute(stmt)
            for f in ("kind", "message", "rows", "count", "value",
                      "hits"):
                assert getattr(got, f) == getattr(want, f), (stmt, f)
        for ns, route in _ROUTE.items():
            where = f" IN {ns}" if ns else ""
            for q in qs[:4]:
                stmt = f"SIMILAR {_vec(q)}{where} TOP 10"
                want = clients["jax"].execute(stmt)
                got = clients["port"].execute(stmt)
                assert got.kind == want.kind and len(got.hits) == 10
                _hits_alike(got.hits, want.hits, route)
    finally:
        for c in clients.values():
            c.close()


def test_jax_and_port_servers_answer_points_alike(pair, pooled_env):
    """Points Query (payloads, a filter, a metric), QueryBatch and a
    QueryStream pipeline through each package's client to its own
    server: ids and scores alike, payloads equal."""
    servers, v, qs = pair
    clients = {pkg: cls.connect(f"127.0.0.1:{servers[pkg].port}")
               for pkg, cls in _clients().items()}
    try:
        out = {pkg: [] for pkg in clients}
        for pkg, c in clients.items():
            for ns in _ROUTE:
                out[pkg].append(
                    [c.query_points(ns, q, 10, with_payload=bool(ns))
                     for q in qs[:4]])
                out[pkg].append(c.query_points_batch(qs, 10, ns))
            out[pkg].append([c.query_points(
                "q8", q, 10, filter_json={"op": "eq", "field": "cat",
                                          "value": 3})
                for q in qs[:4]])
            out[pkg].append([c.query_points("flat", q, 5,
                                            metric="euclidean")
                             for q in qs[:4]])
            with c.points_pipeline() as pipe:
                futs = [pipe.search(q, 10, "q8") for q in qs]
                out[pkg].append([f.result(timeout=60) for f in futs])
        routes = [*(r for r in _ROUTE.values() for _ in range(2)),
                  "pooled", "flat", "pooled"]
        assert len(out["jax"]) == len(routes) == len(out["port"])
        for route, want, got in zip(routes, out["jax"], out["port"]):
            for w, g in zip(want, got, strict=True):
                _hits_alike(g, w, route)
                assert [h.get("payload") for h in g] == \
                    [h.get("payload") for h in w]
        assert all(h["payload"]["cat"] == 3 for hits in out["port"][-3]
                   for h in hits)
    finally:
        for c in clients.values():
            c.close()


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
def test_clients_work_across_packages(pair, client_pkg):
    """A port client against the JAX server, and a JAX client against
    the port server: the answers equal those of the server's own
    client."""
    servers, v, qs = pair
    server_pkg = "port" if client_pkg == "jax" else "jax"
    classes = _clients()
    addr = f"127.0.0.1:{servers[server_pkg].port}"
    cross, own = classes[client_pkg].connect(addr), \
        classes[server_pkg].connect(addr)
    try:
        for c in (cross, own):
            assert c.health()["ok"]
        assert cross.health() == own.health()
        stmt = f"SIMILAR {_vec(qs[1])} IN flat TOP 5"
        assert cross.execute(stmt).hits == own.execute(stmt).hits
        assert cross.execute_batch(["SHOW COLLECTIONS", "BOGUS"])[0].rows \
            == own.execute_batch(["SHOW COLLECTIONS", "BOGUS"])[0].rows
        assert cross.query_points("flat", qs[2], 5, with_payload=True) == \
            own.query_points("flat", qs[2], 5, with_payload=True)
        assert cross.query_points_batch(qs[:8], 5, "flat") == \
            own.query_points_batch(qs[:8], 5, "flat")
        with cross.points_pipeline() as pipe:
            got = [f.result(timeout=60)
                   for f in [pipe.search(q, 5, "bits") for q in qs[:8]]]
        assert got == [own.query_points("bits", q, 5, with_payload=False)
                       for q in qs[:8]]
        assert cross.get_collection("q8") == own.get_collection("q8")
    finally:
        cross.close()
        own.close()


def test_rest_server_mounts_the_grpc_web_gateway():
    """``RestServer(grpc_web=NeumannServer(...))`` on the port serves an
    Execute as a gRPC-web call."""
    from neumann_tpu_torch.server import neumann_pb2 as pb
    from neumann_tpu_torch.server.grpc_web import (
        decode_frames,
        encode_frame,
    )
    from neumann_tpu_torch.server.rest import RestServer
    from neumann_tpu_torch.server.server import NeumannServer

    srv = NeumannServer(device="cpu")
    rest = RestServer(router=srv.router, grpc_web=srv)
    rest.serve()
    try:
        srv.router.execute("EMBED STORE 'a' [1.0, 0.0]")
        srv.router.execute("EMBED STORE 'b' [0.0, 1.0]")
        conn = http.client.HTTPConnection("127.0.0.1", rest.port, timeout=10)
        conn.request("POST", "/neumann.QueryService/Execute",
                     encode_frame(0x00, pb.QueryRequest(
                         query="SIMILAR [0.9, 0.1] TOP 1")
                         .SerializeToString()),
                     {"Content-Type": "application/grpc-web+proto"})
        resp = conn.getresponse()
        frames = decode_frames(resp.read())
        conn.close()
        assert resp.status == 200 and [f for f, _ in frames] == [0x00, 0x80]
        msg = pb.QueryResponse.FromString(frames[0][1])
        assert [(h.key, round(h.score, 4)) for h in msg.hits] == \
            [("a", round(0.9 / np.hypot(0.9, 0.1), 4))]
        assert srv.metrics["requests"] == 1
    finally:
        rest.stop()
        srv.stop()

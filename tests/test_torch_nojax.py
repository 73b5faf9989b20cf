"""The port stands alone: it imports and runs on a machine without JAX
and loads nothing of the JAX package; and (on a card) its CUDA kernels
agree with their plain PyTorch versions.

The first test runs in a subprocess where ``import jax`` fails and the
JAX package (``neumann_tpu``) is on the path: it imports every module of
neumann_tpu_torch, drives EMBED and SIMILAR through the router on the
CPU, a WAL-backed ``ingest_matrix`` replayed into a new store, one
collection per storage mode (none, int8, binary, pq, tt), the HNSW and
legacy IVF index APIs, SQL, graph and Cypher
statements, ``SIMILAR … CONNECTED TO`` and FIND, one REST ``/query``
through ``neumann_tpu_torch.server.RestServer`` (batched serving on),
one shell statement, a checkpoint and rollback, a blob, the LLM cache,
EXPLAIN SIMILAR and the vault, with the native lexer and parser loaded,
and fails if any module named ``neumann_tpu`` or ``neumann_tpu.*`` was
loaded. A second subprocess blocks ``cryptography`` as well, as on the
card's machine: the router and the shell import and run, and only
``init_vault`` fails. A scan of the sources (the server, the shell, the
native loaders and the extended modules included) checks the same
statically. The ``cuda`` tests need an
NVIDIA card with ``nvcc`` (the kernels build from csrc/ at first use);
they skip elsewhere. Run them on the card with
``python -m pytest --noconftest tests/test_torch_nojax.py
tests/test_torch_kernel_edges.py -m cuda``.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_NOJAX = textwrap.dedent("""
    import sys
    for name in [m for m in sys.modules if m == "jax" or m.startswith("jax.")]:
        del sys.modules[name]           # e.g. pre-imported by a site hook
    sys.modules["jax"] = None           # any `import jax` now fails
    import importlib, pkgutil
    import numpy as np
    import neumann_tpu_torch
    for m in pkgutil.walk_packages(neumann_tpu_torch.__path__,
                                   "neumann_tpu_torch."):
        importlib.import_module(m.name)
    from neumann_tpu_torch.router import QueryRouter
    from neumann_tpu_torch.lang import parse
    parse("SELECT a + 1 FROM t WHERE b > 2")
    r = QueryRouter(device="cpu")
    v = np.random.default_rng(0).standard_normal((20, 8))
    for i in range(20):
        r.execute(f"EMBED STORE 'k{i}' [{', '.join(map(str, v[i]))}]")
    hits = r.execute(f"SIMILAR [{', '.join(map(str, v[4]))}] TOP 3").results
    assert hits[0]["key"] == "k4", hits
    for quant in ("none", "int8", "binary", "pq", "tt"):
        r.execute(f"CREATE COLLECTION c_{quant} DIM 8 QUANTIZATION {quant}")
        for i in range(20):
            r.execute(f"EMBED STORE 'k{i}' [{', '.join(map(str, v[i]))}] "
                      f"IN c_{quant}")
        hits = r.execute(f"SIMILAR [{', '.join(map(str, v[6]))}] IN "
                         f"c_{quant} TOP 3").results
        assert hits[0]["key"] == "k6", (quant, hits)
    assert len(r.execute("SHOW COLLECTIONS").rows) == 5
    assert r.vector.build_hnsw_index() == 20
    assert r.vector.search_with_hnsw(v[4], 3)[0].key == "k4"
    assert r.vector.build_ivf_index(4, 2) == 20
    assert r.vector.search_with_ivf_nprobe(v[4], 3, 4)[0].key == "k4"
    from neumann_tpu_torch.ops.ivf import DeviceIVFInt8
    w = np.random.default_rng(1).standard_normal((2048, 8)).astype("f4")
    ix = DeviceIVFInt8(8, n_clusters=4, nprobe=4, device="cpu")
    ix.build(*ix._quant_rows(w[:1792])[:2], fixed_window=256)
    assert ix.add(w[1792:]).tolist() == list(range(1792, 2048))
    assert ix.delete([0, 1800]) == 2
    s, ids = ix.search_batched(w[[3, 1801]], 130, fast=False)
    assert ids[:, 0].tolist() == [3, 1801] and 0 not in ids, ids[:, :3]
    assert ix.compact() == 2046 and ix.search(w[5], 1)[1][0, 0] == 5
    r.execute("CREATE TABLE t (id INT PRIMARY KEY, v INT)")
    r.execute("INSERT INTO t VALUES (1, 10), (2, 20), (3, 30)")
    assert r.execute("SELECT id FROM t WHERE v > 15").rows == [
        {"id": 2}, {"id": 3}]
    for i in range(6):
        r.execute(f"ENTITY CREATE 'e{i}' {{ tier: {i % 2} }} EMBEDDING "
                  f"[{', '.join(map(str, v[i]))}]")
    for i in (1, 2, 4):
        r.execute(f"ENTITY CONNECT 'e0' -> 'e{i}' : rel")
    assert r.execute("NEIGHBORS 0 OUTGOING : rel").rows == [
        {"id": 1}, {"id": 2}, {"id": 4}]
    assert r.execute("PATH SHORTEST 0 TO 4").value == [0, 4]
    assert r.graph.pagerank() and r.graph.connected_components()[4] == 0
    hits = r.execute(f"SIMILAR [{', '.join(map(str, v[2]))}] TOP 2 "
                     f"CONNECTED TO 'e0'").results
    assert [h["key"] for h in hits][0] == "e2", hits
    rows = r.execute(f"FIND NODE entity WHERE tier = 0 SIMILAR TO "
                     f"[{', '.join(map(str, v[4]))}] LIMIT 2").rows
    assert rows[0]["key"] == "e4", rows
    assert r.execute("MATCH (a)-[:rel]->(b) RETURN COUNT(*) AS n").rows \
        == [{"n": 3}]
    import tempfile
    from pathlib import Path
    from neumann_tpu_torch.engines.vector import VectorEngine
    from neumann_tpu_torch.store.tensor_store import TensorStore
    with tempfile.TemporaryDirectory() as tmp:
        wal = Path(tmp) / "wal.bin"
        store = TensorStore()
        store.open_durable(wal)
        eng = VectorEngine(store, device="cpu")
        eng.ingest_matrix([f"w{i}" for i in range(20)], v.astype("f4"))
        store.wal_flush()
        assert eng.search_similar(v[9], 1)[0].key == "w9"
        fresh = TensorStore()
        eng2 = VectorEngine(fresh, device="cpu")
        fresh.recover(wal)
        assert eng2.search_similar(v[9], 1)[0].key == "w9"
    import neumann_tpu_torch.native as native
    from neumann_tpu_torch.native import pycodec, pylexer, pyparser
    assert native.available() and pycodec.load() is not None
    assert pylexer.load() is not None and pyparser.load() is not None
    from neumann_tpu_torch.lang import parser as lang_parser
    lang_parser._native()
    assert lang_parser.parse.__name__ == "parse_full"
    import http.client, io, json
    from neumann_tpu_torch.server import RestServer
    from neumann_tpu_torch.shell import Shell
    r.warmup(buckets=(1, 4), top_ks=(3,))
    r.enable_batched_serving(max_wait_ms=1.0)
    srv = RestServer(r)
    conn = http.client.HTTPConnection("127.0.0.1", srv.serve())
    conn.request("POST", "/query", json.dumps({"query": (
        f"SIMILAR [{', '.join(map(str, v[5]))}] TOP 3")}))
    resp = conn.getresponse()
    hits = json.loads(resp.read())["hits"]
    assert resp.status == 200 and hits[0]["key"] == "k5", hits
    assert r._batchers[("", 8, "cosine")].queries_served == 1
    srv.stop()
    r.disable_batched_serving()
    sh = Shell(router=r, stdout=io.StringIO(), theme="plain")
    assert "(3 row(s))" in sh.execute("SELECT * FROM t"), sh.execute(
        "SELECT * FROM t")
    with tempfile.TemporaryDirectory() as tmp:
        r.init_checkpoints(tmp)
        r.execute("CHECKPOINT 'pre'")
        r.execute("DELETE FROM t WHERE id = 1")
        r.execute("ROLLBACK TO 'pre'")
        assert len(r.execute("SELECT * FROM t").rows) == 3
    r.execute("BLOB INIT")
    aid = r.execute("BLOB PUT 'a.txt' 'hello'").value
    assert r.execute(f"BLOB GET '{aid}'").value == b"hello"
    r.execute("CACHE INIT")
    r.execute("CACHE PUT 'q' 'a'")
    assert r.execute("CACHE GET 'q'").value == "a"
    plan = r.execute(f"EXPLAIN SIMILAR [{', '.join(map(str, v[5]))}] "
                     f"IN c_binary TOP 3").rows
    assert plan[0]["detail"].startswith("route binary"), plan
    r.init_vault("pw")
    r.execute("VAULT SET 's' 'v'")
    assert r.execute("VAULT GET 's'").value == "v"
    bad = [m for m, mod in sys.modules.items()
           if mod is not None and (m == "jax" or m.startswith("jax.")
               or m == "neumann_tpu" or m.startswith("neumann_tpu."))]
    assert not bad, bad
    print("OK")
""")


def test_port_runs_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", _NOJAX], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


_NOCRYPTO = textwrap.dedent("""
    import sys
    for name in [m for m in sys.modules if m.split(".")[0] in (
            "jax", "cryptography")]:
        del sys.modules[name]
    sys.modules["jax"] = None
    sys.modules["cryptography"] = None  # the card's machine has neither
    import tempfile
    from neumann_tpu_torch.router import QueryRouter
    from neumann_tpu_torch.shell import Shell
    r = QueryRouter(device="cpu")
    r.execute("CREATE TABLE t (id INT PRIMARY KEY)")
    r.execute("INSERT INTO t VALUES (1), (2)")
    with tempfile.TemporaryDirectory() as tmp:
        r.init_checkpoints(tmp)
        r.execute("CHECKPOINT 'pre'")
        r.execute("DELETE FROM t WHERE id = 1")
        r.execute("ROLLBACK TO 'pre'")
    assert len(r.execute("SELECT * FROM t").rows) == 2
    r.execute("BLOB INIT")
    r.execute("CACHE INIT")
    assert r.execute("EXPLAIN SELECT * FROM t").rows
    Shell(router=r)
    loaded = [m for m in sys.modules if m.startswith(
        ("neumann_tpu_torch.vault", "cryptography", "jax"))
        and sys.modules[m] is not None]
    assert not loaded, loaded
    try:
        r.init_vault("pw")
    except ImportError:
        pass
    else:
        raise AssertionError("the vault imported without cryptography")
    print("OK")
""")


def test_router_imports_without_cryptography():
    """The card's machine has no ``cryptography``: the router, the shell
    and every module but the vault import and run there; only
    ``init_vault`` needs it."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    proc = subprocess.run([sys.executable, "-c", _NOCRYPTO], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


def _imported_roots(path: Path) -> set:
    """Top-level packages a module imports, from its syntax tree."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _port_sources() -> list:
    srcs = list((ROOT / "neumann_tpu_torch").rglob("*.py"))
    srcs.append(ROOT / "chip_smoke.py")
    names = {str(p.relative_to(ROOT)) for p in srcs}
    assert {"neumann_tpu_torch/native/pylexer.py",
            "neumann_tpu_torch/native/pyparser.py",
            "neumann_tpu_torch/server/rest.py",
            "neumann_tpu_torch/server/batcher.py",
            "neumann_tpu_torch/shell/shell.py",
            "neumann_tpu_torch/checkpoint/manager.py",
            "neumann_tpu_torch/blob/blob_store.py",
            "neumann_tpu_torch/cache/llm_cache.py",
            "neumann_tpu_torch/vault/vault.py",
            "neumann_tpu_torch/vault/scoped.py",
            "neumann_tpu_torch/docs_cli.py"} <= names
    return srcs


def test_port_source_has_no_jax_import():
    assert not [str(p) for p in _port_sources()
                if "jax" in _imported_roots(p)]


def test_port_source_has_no_jax_package_import():
    assert not [str(p) for p in _port_sources()
                if "neumann_tpu" in _imported_roots(p)]


def test_ingest_matrix_native_codec_stores_the_ports_classes():
    """The port's C codec is its own image, initialised with the port's
    TensorData / TensorValue, so the columnar ingest's C loop fills the
    store with the port's objects even when the JAX package's codec is
    loaded in the same process."""
    from neumann_tpu.native import pycodec as jax_pycodec
    from neumann_tpu_torch.engines.vector import VectorEngine
    from neumann_tpu_torch.native import pycodec
    from neumann_tpu_torch.store.tensor_store import TensorData, TensorValue

    jax_pycodec.load()
    ext = pycodec.load()
    assert ext is not None and hasattr(ext, "bulk_embed_entries")
    assert ext is not jax_pycodec.load()
    eng = VectorEngine(device="cpu")
    v = np.random.default_rng(1).standard_normal((50, 16)).astype(np.float32)
    assert eng.ingest_matrix([f"k{i}" for i in range(50)], v) == 50
    data = eng.store.get("emb:k7")
    assert type(data) is TensorData
    assert type(data.get("embedding")) is TensorValue
    np.testing.assert_array_equal(data.get("embedding").to_dense(), v[7])
    assert eng.search_similar(v[7], 1)[0].key == "k7"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode; their plain versions are tested above)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_probe_kernel_matches_plain(cuda):
    from neumann_tpu_torch.ops import kernels as tk

    g = torch.Generator(device=cuda).manual_seed(0)
    n, d, window, q, nprobe = 64 * 1024, 768, 1024, 4, 8
    buf = torch.randint(-127, 128, (n, d), generator=g, device=cuda,
                        dtype=torch.int8)
    rm = torch.rand(n, generator=g, device=cuda) * 1e-3
    rm[::37] = 0.0
    sb = torch.randint(0, n // 128 - window // 128 + 1, (q, nprobe),
                       generator=g, device=cuda, dtype=torch.int32)
    qs = torch.randn(q, d, generator=g, device=cuda)
    qs /= qs.norm(dim=1, keepdim=True)
    before = tk.LAUNCHES["ivf_probe"]
    got = tk.ivf_probe_scores(buf, rm, sb, qs, window)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["ivf_probe"] == before + 1
    want = tk.ivf_probe_scores_plain(buf, rm, sb, qs, window)
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    live = torch.isfinite(want)
    torch.testing.assert_close(got[live], want[live], rtol=0, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("top2", [False, True])
def test_batched_kernel_bit_exact(cuda, top2):
    from neumann_tpu_torch.ops import kernels as tk

    g = torch.Generator(device=cuda).manual_seed(1)
    n_win, q_cap, d, window = 64, 40, 768, 1024
    buf = torch.randint(-127, 128, (n_win * window, d), generator=g,
                        device=cuda, dtype=torch.int8)
    qsel = torch.randint(-127, 128, (n_win, q_cap, d), generator=g,
                         device=cuda, dtype=torch.int8)
    rm = torch.rand(n_win, window, generator=g, device=cuda) * 1e-3
    rm[:, ::41] = 0.0
    scm = torch.rand(n_win, q_cap, generator=g, device=cuda) * 1e-2
    scm[:, 20:] = 0.0                          # empty slots / tiles
    got = tk.batched_probe(buf, rm, qsel, scm, window, top2=top2)
    torch.cuda.synchronize()
    want = tk.batched_probe_plain(buf, rm, qsel, scm, window, top2=top2)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q", [(64 * 1024, 64), (5000, 37), (4096, 5)])
def test_int8_scores_kernel_bit_exact(cuda, n, q):
    """Ragged N (not a multiple of the 128-row tile) and ragged Q, both
    query-tile widths."""
    from neumann_tpu_torch.ops import kernels as tk

    g = torch.Generator(device=cuda).manual_seed(2)
    d = 768
    cq = torch.randint(-127, 128, (n, d), generator=g, device=cuda,
                       dtype=torch.int8)
    qq = torch.randint(-127, 128, (q, d), generator=g, device=cuda,
                       dtype=torch.int8)
    rm = torch.rand(n, generator=g, device=cuda) * 1e-3
    qm = torch.rand(q, generator=g, device=cuda) * 1e-2
    before = tk.LAUNCHES["int8_dot_scores"]
    got = tk.int8_dot_scores(cq, rm, qq, qm)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["int8_dot_scores"] == before + 1
    assert torch.equal(got, tk.int8_dot_scores_plain(cq, rm, qq, qm))


def _pooled_inputs(cuda, n, q, d, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=cuda)
    qs = x[torch.randint(0, n, (q,), generator=g, device=cuda)] \
        + 0.1 * torch.randn(q, d, generator=g, device=cuda)
    rm = torch.rsqrt((x * x).sum(1))
    bias = torch.where(torch.rand(n, generator=g, device=cuda) < 0.9,
                       torch.full((n,), 2.0, device=cuda),
                       torch.full((n,), -1e30, device=cuda))
    return x, qs, rm, bias


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,pool", [(8 * 1001, 40, 8), (1 << 18, 8, 512),
                                      (1 << 16, 70, 4096)])
def test_int8_pooled_kernel_bit_exact(cuda, n, q, pool):
    from neumann_tpu_torch.ops import kernels as tk
    from neumann_tpu_torch.ops.quant import scalar_quantize

    x, qs, _, bias = _pooled_inputs(cuda, n, q, 768, 3)
    cq, cs = scalar_quantize(x)
    rm = cs * torch.rsqrt((cq.float() ** 2).sum(1) * cs ** 2)
    qq, qsc = scalar_quantize(qs)
    qm = qsc / torch.sqrt(((qq.float() * qsc[:, None]) ** 2).sum(1))
    got = tk.int8_pooled_bits(cq, rm, bias, qq, qm, pool)
    torch.cuda.synchronize()
    want = tk.int8_pooled_bits_plain(cq, rm, bias, qq, qm, pool)
    assert got.shape == (q, n // pool)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,pool", [(8 * 1001, 40, 8), (1 << 18, 8, 512)])
def test_f32_pooled_kernel_within_tolerance(cuda, n, q, pool):
    """Dots summed in another order: decoded winner scores within one
    packed-mantissa step (pool * 2^-22 in [1, 4)) plus 1e-6, winning
    rows equal on 99 % of the pools, dead pools identical."""
    from neumann_tpu_torch.ops import kernels as tk

    x, qs, rm, bias = _pooled_inputs(cuda, n, q, 768, 4)
    qm = torch.rsqrt((qs * qs).sum(1))
    got = tk.f32_pooled_bits(x, rm, bias, qs, qm, pool)
    torch.cuda.synchronize()
    want = tk.f32_pooled_bits_plain(x, rm, bias, qs, qm, pool)
    live = want > 0
    assert torch.equal(got > 0, live)
    dec = lambda b: (b & ~(pool - 1)).view(torch.float32).double()
    err = (dec(got) - dec(want)).abs()[live].max().item()
    assert err <= pool * 2.0 ** -22 + 1e-6
    same = ((got & (pool - 1)) == (want & (pool - 1)))[live]
    assert same.float().mean().item() >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,w", [
    (3001, 70, 24), (1 << 16, 5, 64), (3001, 1, 8), (1 << 16, 1, 96),
    (1 << 16, 1025, 8), (4099, 1025, 96), (1 << 16, 33, 256),
    (3001, 1025, 256)])
def test_hamming_kernel_bit_exact(cuda, n, q, w):
    from neumann_tpu_torch.ops import kernels as tk

    g = torch.Generator(device=cuda).manual_seed(5)
    cb = torch.randint(-(1 << 31), 1 << 31, (n, w), generator=g,
                       device=cuda, dtype=torch.int64).int()
    qb = torch.randint(-(1 << 31), 1 << 31, (q, w), generator=g,
                       device=cuda, dtype=torch.int64).int()
    got = tk.hamming_scores(cb, qb)
    torch.cuda.synchronize()
    assert torch.equal(got, tk.hamming_scores_plain(cb, qb))

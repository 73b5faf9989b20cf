"""The port's chain (neumann_tpu_torch/chain/, copies of the JAX
package's modules with only their import lines changed, but for
``consensus.py``'s device function in torch, ``node.py``'s ``device``
and snapshot collection configs, and the statement bound of
``message_validation.py``) against the JAX package's, on the CPU.

Every scenario of tests/test_chain.py runs on both packages as one test
parametrised over ``package`` (tests/torch_twins.py; the port's node
routers and pairwise classification asked for the CPU). Then:
``classify_pairwise_codes`` of the port against JAX's on the same seeded
inputs (codes equal but for pairs whose cosine or Jaccard lies within
1e-5 of a threshold, both held to float64 too); ``wire`` frames and
JSON messages the same bytes both ways; CHAIN and CLUSTER statement
scripts through a JAX and a port router (``run_both``, with the block
clock pinned so block hashes agree; CLUSTER CONNECT against a JAX and a
port three-node TCP cluster); ``convert.chain_from_jax``; and a
cluster_query carrying a 768-float statement, which the port accepts
and the JAX package's validation drops.
"""

import types

import numpy as np
import pytest

from neumann_tpu.chain import block as jblock
from neumann_tpu.chain import consensus as jcons
from neumann_tpu.chain import wire as jwire
from neumann_tpu.chain.transport import Message as JMessage
from neumann_tpu_torch import convert
from neumann_tpu_torch.chain import block as tblock
from neumann_tpu_torch.chain import consensus as tcons
from neumann_tpu_torch.chain import wire as twire
from neumann_tpu_torch.chain.message_validation import validate
from neumann_tpu_torch.chain.transport import Message as TMessage
from tests.test_torch_relational import routers, run_both
from tests.torch_twins import twin_tests

# The in-process TCP clusters of test_chain.py (replication, leader
# failover, the CLUSTER CONNECT gateway) elect in 3-6 ticks of 10 ms, with
# RaftConfig's default heartbeat of every 3 ticks: a follower whose
# timeout is 3 ticks then times out against a live leader whenever the
# leader's loop runs a little slower than its own, about 3 elections a
# second with no load at all, and a write proposed or forwarded across
# one is lost. Their twins run with a heartbeat every tick (elections
# still 3-6 ticks), where the same three nodes hold one leader. And they
# wait until every node knows that leader, not only until one node leads:
# a follower that has not yet heard from a leader elected a moment ago
# refuses a write (``propose_put`` returns False: it knows no leader to
# forward to), which failed test_tcp_cluster_node_replication_and_client
# under load (1 run in 20 with the CPU's cores all busy).
_STEADY_LEADER = {
    "RaftConfig(election_timeout_min=3, election_timeout_max=6)":
    "RaftConfig(election_timeout_min=3, election_timeout_max=6, "
    "heartbeat_interval=1)",
    """        while time.time() < deadline and not any(
                n.is_leader() for n in nodes.values()):""":
    """        while time.time() < deadline and not (
                any(n.is_leader() for n in nodes.values())
                and len({n.raft.leader_id for n in nodes.values()}) == 1
                and all(n.raft.leader_id for n in nodes.values())):"""}

globals().update(twin_tests("test_chain", patch=_STEADY_LEADER))

MARGIN = 1e-5


def _deltas(n, dim, seed):
    """Deltas in groups of four around a base vector (near copies with
    equal key sets, noisy ones, free ones), every fifth zero; key sets
    of 0-3 keys from 12, so every class occurs."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n // 4 + 1, dim)).astype(np.float32)
    noise = rng.standard_normal((n, dim)).astype(np.float32)
    j = np.arange(n) % 4
    scale = np.where(j == 1, 0.02, 1.0).astype(np.float32)[:, None]
    d = np.where(j[:, None] < 3, base[np.arange(n) // 4] + scale * noise,
                 noise).astype(np.float32)
    d[::5] = 0.0
    keys = []
    for i in range(n):
        if j[i] == 1:
            keys.append(set(keys[-1]))
        else:
            keys.append({f"k{x}" for x in rng.choice(
                12, int(rng.integers(0, 4)), replace=False)})
    return d, keys


def _f64_codes(d, keys, cfg):
    """(codes, pairs within MARGIN of a threshold) in float64."""
    d = d.astype(np.float64)
    norms = np.linalg.norm(d, axis=1, keepdims=True)
    dn = np.where(norms > 0, d / np.maximum(norms, 1e-300), 0.0)
    cos = dn @ dn.T
    n = len(keys)
    inter = np.array([[len(a & b) for b in keys] for a in keys], float)
    union = np.array([[len(a | b) for b in keys] for a in keys], float)
    jac = np.where(union > 0, inter / np.maximum(union, 1.0), 1.0)
    eq = np.array([[a == b for b in keys] for a in keys])
    codes = np.where(
        jac > cfg.jaccard_conflict,
        np.where(eq & (cos >= cfg.identical_threshold), 0,
                 np.where(cos >= cfg.similar_threshold, 1, 3)),
        np.where(np.abs(cos) <= cfg.orthogonal_threshold, 2,
                 np.where(cos >= cfg.similar_threshold, 1, 2)))
    near = np.zeros((n, n), bool)
    for t in (cfg.identical_threshold, cfg.similar_threshold):
        near |= np.abs(cos - t) < MARGIN
    near |= np.abs(np.abs(cos) - cfg.orthogonal_threshold) < MARGIN
    near |= (np.abs(jac - cfg.jaccard_conflict) < MARGIN) & \
        (jac != cfg.jaccard_conflict)
    return codes.astype(np.int8), near


@pytest.mark.parametrize("n", [1, 2, 3, 17, 64, 257])
@pytest.mark.parametrize("dim", [8, 96])
def test_classify_pairwise_codes_matches_jax(n, dim):
    d, keys = _deltas(n, dim, seed=n * 1000 + dim)
    cfg = tcons.ConsensusConfig()
    got = tcons.classify_pairwise_codes(d, keys, cfg, device="cpu")
    want = jcons.classify_pairwise_codes(d, keys, jcons.ConsensusConfig())
    ref, near = _f64_codes(d, keys, cfg)
    assert got.dtype == np.int8 and got.shape == (n, n)
    assert not ((got != want) & ~near).any()
    assert not ((got != ref) & ~near).any()
    # near copies of one base vector with equal key sets are identical
    if n >= 2 and d[1].any() and d[0].any():
        assert got[0, 1] == 0


def test_classify_pairwise_tuples_and_config():
    d, keys = _deltas(40, 16, seed=3)
    cfg = dict(orthogonal_threshold=0.3, identical_threshold=0.9,
               similar_threshold=0.4, jaccard_conflict=0.2)
    got = tcons.classify_pairwise(d, keys, tcons.ConsensusConfig(**cfg),
                                  device="cpu")
    want = jcons.classify_pairwise(d, keys, jcons.ConsensusConfig(**cfg))
    ref, near = _f64_codes(d, keys, tcons.ConsensusConfig(**cfg))
    assert [(i, j) for i, j, _ in got] == [(i, j) for i, j, _ in want]
    for (i, j, a), (_, _, b) in zip(got, want):
        assert a.value == b.value or near[i, j]
    assert tcons.classify_pairwise(d[:1], keys[:1], device="cpu") == []


def test_pairwise_codes_kernel_runs_on_the_tensors_device():
    import torch

    d, keys = _deltas(9, 8, seed=1)
    inc = np.zeros((9, 12), np.float32)
    for i, ks in enumerate(keys):
        inc[i, [int(k[1:]) for k in ks]] = 1.0
    out = tcons.pairwise_codes_kernel(torch.from_numpy(d),
                                      torch.from_numpy(inc), 0.98, 0.5,
                                      0.1, 0.0)
    assert out.dtype == torch.int8 and out.device.type == "cpu"
    np.testing.assert_array_equal(
        out.numpy(), tcons.classify_pairwise_codes(d, keys, device="cpu"))


_PAYLOADS = [
    {"term": 7, "leader": "n1", "prev_index": 41,
     "entries": [{"index": 42, "term": 7,
                  "emb": [0.125 * i for i in range(768)],
                  "ids": list(range(100)), "blob": b"\x00\x01\xff",
                  "mixed": [1, "x", None, True, 2.5],
                  "nested": {"a": {"b": [1.5, 2.5]}}, "bigint": 1 << 100,
                  "empty_list": [], "empty_dict": {}}],
     "commit": 41, "none": None, "flag": False},
    {"q": "EMBED STORE 'k' [0.1, -2.5e-07, 3]", "op": "stmt"},
    {"members": {"n0": {"status": "alive", "inc": 0, "v": 3}}},
]


@pytest.mark.parametrize("payload", _PAYLOADS)
def test_wire_and_json_frames_are_the_same_bytes(payload):
    jb = jwire.encode_message("append_entries", "n1", "n2", payload)
    tb = twire.encode_message("append_entries", "n1", "n2", payload)
    assert jb == tb
    assert twire.decode_message(jb) == jwire.decode_message(tb)
    jm = JMessage("gossip", "a", "b", payload)
    tm = TMessage("gossip", "a", "b", payload)
    assert jm.encode() == tm.encode()
    assert jm.encode_binary() == tm.encode_binary()
    back = TMessage.decode(jm.encode_binary())
    assert (back.kind, back.src, back.dst, back.payload) == \
        ("gossip", "a", "b", payload)


@pytest.fixture
def pinned_clock(monkeypatch):
    """Both packages' blocks take one timestamp, so their hashes and
    signatures agree."""
    clock = types.SimpleNamespace(time=lambda: 1_700_000_000.5)
    monkeypatch.setattr(jblock, "time", clock)
    monkeypatch.setattr(tblock, "time", clock)


def _vec(i, dim=4):
    v = np.zeros(dim, np.float32)
    v[i % dim] = 1.0 + i / 8
    v[(i + 1) % dim] = -0.5
    return "[" + ", ".join(f"{x:g}" for x in v) + "]"


def _rtol(stmt):
    """SIMILAR scores are f32 sums in another order: within 1e-5."""
    return 1e-5 if stmt.startswith("SIMILAR") else 0.0


CHAIN_SCRIPT = [
    "CHAIN HEIGHT",                      # no chain yet: both raise
    "COMMIT CHAIN",
    "BEGIN CHAIN TRANSACTION",
    "EMBED STORE 'a' " + _vec(0),
    "EMBED STORE 'b' " + _vec(1),
    "CREATE TABLE t (id INT PRIMARY KEY, x INT)",
    "INSERT INTO t VALUES (1, 10), (2, 20)",
    "COMMIT CHAIN",
    "CHAIN HEIGHT", "CHAIN TIP", "CHAIN BLOCK 0", "CHAIN BLOCK 7",
    "CHAIN VERIFY", "CHAIN HISTORY 'emb:a'", "CHAIN HISTORY 'nope'",
    "CHAIN SIMILAR " + _vec(0) + " LIMIT 3", "CHAIN DRIFT FROM 0 TO 5",
    "SHOW CODEBOOK GLOBAL", "SHOW CODEBOOK LOCAL 'default'",
    "ANALYZE CODEBOOK TRANSITIONS",
    "BEGIN CHAIN",
    "EMBED STORE 'a' " + _vec(2),
    "EMBED DELETE 'b'",
    "UPDATE t SET x = 99 WHERE id = 1",
    "DELETE FROM t WHERE id = 2",
    "SIMILAR " + _vec(2) + " TOP 2",
    "ROLLBACK CHAIN",
    "SIMILAR " + _vec(0) + " TOP 2",
    "SELECT * FROM t",
    "CHAIN HEIGHT",
    "ROLLBACK CHAIN",                    # nothing open: both raise
    *[s for i in range(18) for s in (
        "BEGIN CHAIN TRANSACTION", f"EMBED STORE 'k{i}' " + _vec(i),
        f"INSERT INTO t VALUES ({10 + i}, {i})", "COMMIT CHAIN")],
    "CHAIN HEIGHT", "CHAIN TIP", "CHAIN VERIFY", "CHAIN HISTORY 'emb:k3'",
    "CHAIN DRIFT FROM 0 TO 19", "SHOW CODEBOOK GLOBAL",
    "SHOW CODEBOOK LOCAL 'default'", "ANALYZE CODEBOOK TRANSITIONS",
    "ROLLBACK CHAIN TO 5", "CHAIN HEIGHT", "CHAIN VERIFY",
    "ROLLBACK CHAIN TO 9",
    "CHAIN BLOCK 4",
]


@pytest.mark.parametrize("dim", [None, 4])
def test_chain_statements_through_both_routers(pinned_clock, dim):
    """The script through a JAX and a port router: on a chain that the
    first BEGIN makes (64 dimensions: every 4-d delta is zero) or one
    that ``init_chain(embedding_dim=4)`` made."""
    jr, tr = routers()
    if dim is not None:
        jr.init_chain(embedding_dim=dim)
        tr.init_chain(embedding_dim=dim)
    for stmt in CHAIN_SCRIPT:
        run_both(jr, tr, stmt, rtol=_rtol(stmt))
    # the counters agree; the timings are each host's own
    js, ts = (r.execute("CHAIN STATS").rows[0] for r in (jr, tr))
    for key in ("commits", "rollbacks", "conflicts_rejected",
                "auto_merges", "blocks"):
        assert js[key] == ts[key], key
    assert js["commit_timing"]["count"] == ts["commit_timing"]["count"]
    assert jr.chain._state_root() == tr.chain._state_root()


def test_cluster_statements_without_a_cluster():
    jr, tr = routers()
    for stmt in ("CLUSTER STATUS", "CLUSTER NODES", "CLUSTER LEADER",
                 "CLUSTER DISCONNECT", "CLUSTER CONNECT 'nowhere'",
                 "CLUSTER CONNECT 'n0@127.0.0.1:1'", "CLUSTER STATUS"):
        run_both(jr, tr, stmt)


def _orchestrated(pkg):
    """A five-node in-process cluster of ``pkg``'s chain, elected."""
    from importlib import import_module

    cl = import_module(f"{pkg}.chain.cluster")
    tr = import_module(f"{pkg}.chain.transport")
    gs = import_module(f"{pkg}.chain.gossip")
    hub = tr.TransportHub(seed=4)
    ids = [f"n{i}" for i in range(5)]
    nodes = {nid: cl.ClusterNode(
        nid, ids, hub, seed=4 + i,
        gossip_config=gs.GossipConfig(probe_interval=2, ack_timeout=2,
                                      suspect_timeout=4))
        for i, nid in enumerate(ids)}
    for _ in range(400):
        for n in nodes.values():
            n.pump()
        if any(n.is_leader() and n.raft.commit_index > 0
               for n in nodes.values()):
            break
    return types.SimpleNamespace(
        nodes=nodes, leader=lambda: next(
            (nid for nid, n in nodes.items() if n.is_leader()), None))


def test_cluster_statements_on_an_attached_cluster():
    """CLUSTER STATUS / NODES / LEADER read a cluster a caller attaches:
    the same seeded five-node cluster in each package."""
    jr, tr = routers()
    jr.cluster = _orchestrated("neumann_tpu")
    tr.cluster = _orchestrated("neumann_tpu_torch")
    for stmt in ("CLUSTER STATUS", "CLUSTER NODES", "CLUSTER LEADER",
                 "CLUSTER DISCONNECT", "CLUSTER STATUS"):
        run_both(jr, tr, stmt)


def _tcp_cluster(pkg):
    """Three ``pkg`` TcpClusterNodes on localhost (the port's routers on
    the CPU), elected; Raft timeouts of 300-600 ms."""
    import time
    from importlib import import_module

    node_mod = import_module(f"{pkg}.chain.node")
    raft = import_module(f"{pkg}.chain.raft")
    cfg = raft.RaftConfig(election_timeout_min=30, election_timeout_max=60)
    kw = {} if pkg == "neumann_tpu" else {"device": "cpu"}
    nodes = {nid: node_mod.TcpClusterNode(nid, {}, port=0, config=cfg,
                                          seed=i, **kw)
             for i, nid in enumerate(("n0", "n1", "n2"))}
    addrs = {nid: n.address for nid, n in nodes.items()}
    for nid, n in nodes.items():
        n._peer_addrs = {p: addrs[p] for p in addrs if p != nid}
        n.raft.voters = set(addrs)
        n.start(tick_interval_s=0.01)
    deadline = time.time() + 30
    while time.time() < deadline and not any(
            n.is_leader() for n in nodes.values()):
        time.sleep(0.05)
    return nodes


GATEWAY_SCRIPT = [
    "CREATE TABLE gw (id INT PRIMARY KEY, x INT)",
    "INSERT INTO gw VALUES (1, 7), (2, 8)",
    "SELECT * FROM gw",
    "UPDATE gw SET x = 9 WHERE id = 2",
    "SELECT * FROM gw WHERE x > 7",
    "CREATE COLLECTION c DIM 4 QUANTIZATION int8",
    "EMBED BATCH [('r0', [1, 0, 0, 0]), ('r1', [0, 1, 0, 0.5])] IN c",
    "EMBED STORE 'e' [0.5, 0.5, 0, 0]",
    "SIMILAR [1, 0, 0, 0] IN c TOP 2",
    "SIMILAR [0.5, 0.5, 0, 0] TOP 1",
    "SHOW COLLECTIONS",
    "SELECT * FROM missing",
]


def test_cluster_connect_gateway_through_both_routers():
    """CLUSTER CONNECT turns each router into a gateway to its own
    package's three-node TCP cluster: the statements answer alike, the
    gateways' stores stay empty, every node applies the writes."""
    import time

    jn = _tcp_cluster("neumann_tpu")
    tn = _tcp_cluster("neumann_tpu_torch")
    try:
        jr, tr = routers()
        for r, nodes in ((jr, jn), (tr, tn)):
            host, port = nodes["n1"].address
            assert "connected" in r.execute(
                f"CLUSTER CONNECT 'n1@{host}:{port}'").message
        for stmt in GATEWAY_SCRIPT:
            run_both(jr, tr, stmt, rtol=_rtol(stmt))
        assert len(jr.store) == 0 and len(tr.store) == 0
        deadline = time.time() + 20
        while time.time() < deadline and not all(
                n.store.get("table:gw:1") is not None
                and n.router.vector.collection_stats("c")["count"] == 2
                for n in tn.values()):
            time.sleep(0.05)
        for n in tn.values():
            assert n.router.execute("SELECT * FROM gw").rows == \
                [{"_id": 0, "id": 1, "x": 7}, {"_id": 1, "id": 2, "x": 9}]
        run_both(jr, tr, "CLUSTER DISCONNECT")
        run_both(jr, tr, "CREATE TABLE local_t (y INT)")
        assert len(jr.store) > 0 and len(tr.store) > 0
    finally:
        for n in (*jn.values(), *tn.values()):
            n.stop()


def test_chain_from_jax(pinned_clock):
    """A JAX chain of 20 blocks (its global codebook trained after 16)
    carried into a port chain over a port store holding the same rows:
    the chain statements answer alike, and the next transaction on each
    appends the same block."""
    jr, tr = routers()
    jr.init_chain(embedding_dim=4)
    for i in range(20):
        for stmt in ("BEGIN CHAIN TRANSACTION",
                     f"EMBED STORE 'k{i}' " + _vec(i), "COMMIT CHAIN"):
            jr.execute(stmt)
        tr.execute(f"EMBED STORE 'k{i}' " + _vec(i))
    # deltas of statement-level transactions are zero: give the chain's
    # own commit path (TensorChain.commit) non-zero ones too
    from neumann_tpu.store.tensor_store import TensorData, TensorValue

    for i in range(3):
        tx = jr.chain.begin()
        tx.put(f"emb:k{i}", TensorData().set("embedding", TensorValue.vector(
            np.full(4, i + 2.0, np.float32))))
        jr.chain.commit(tx)
        tr.execute(f"EMBED STORE 'k{i}' [{i + 2}, {i + 2}, {i + 2}, "
                   f"{i + 2}]")
    tr.chain = convert.chain_from_jax(jr.chain, tr.store, tr.device)
    assert tr.chain._state_root() == jr.chain._state_root()
    assert tr.chain.codebooks.global_book is not None
    for stmt in ("CHAIN HEIGHT", "CHAIN VERIFY", "CHAIN TIP",
                 "CHAIN BLOCK 3", "CHAIN HISTORY 'emb:k2'",
                 "CHAIN SIMILAR [1, 1, 1, 1] LIMIT 4",
                 "CHAIN DRIFT FROM 0 TO 23", "SHOW CODEBOOK GLOBAL",
                 "SHOW CODEBOOK LOCAL 'default'",
                 "ANALYZE CODEBOOK TRANSITIONS",
                 "BEGIN CHAIN TRANSACTION", "EMBED STORE 'z' " + _vec(5),
                 "COMMIT CHAIN", "CHAIN TIP", "CHAIN VERIFY"):
        run_both(jr, tr, stmt)
    js, ts = (r.execute("CHAIN STATS").rows[0] for r in (jr, tr))
    assert js["commits"] == ts["commits"] and js["blocks"] == ts["blocks"]


def test_a_cluster_query_of_a_768_float_statement_is_accepted():
    """The port bounds a cluster_query's statement like a blob: a
    SIMILAR of 768 floats (the JAX bound of 4,096 characters drops it)
    validates, and one over the blob bound does not."""
    from neumann_tpu.chain.message_validation import validate as jvalidate

    stmt = "SIMILAR [" + ", ".join(["-0.1234567"] * 768) + "] TOP 10"
    ok, _ = validate(TMessage("cluster_query", "c", "n", {"query": stmt}))
    assert ok and len(stmt) > 4096
    ok, reason = jvalidate(JMessage("cluster_query", "c", "n",
                                    {"query": stmt}))
    assert not ok and "short string" in reason
    ok, _ = validate(TMessage("cluster_query", "c", "n",
                              {"query": "x" * (2 * 1024 * 1024 + 1)}))
    assert not ok
    for bad in (7, None, ["SIMILAR"]):
        assert not validate(TMessage("cluster_query", "c", "n",
                                     {"query": bad}))[0]


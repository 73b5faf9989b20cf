"""The port's cluster across processes and real sockets, on the CPU.

tests/test_multiprocess_cluster.py runs on the port alone
(tests/torch_twins.py with ``packages=("port",)``; its nodes are
``python -m neumann_tpu_torch.chain.node --device cpu`` processes of
this checkout; the JAX side runs in that file): three node processes,
acknowledged writes, the leader or a follower SIGKILLed, every
acknowledged write on the survivors, the killed node back from its WAL
directory. Then CAS through TcpClusterNodes over real sockets with
election timeouts of 300-600 ms (tests/test_integration_parity.py's
case takes 30-60 ms, which the parallel test load has broken), and a
768-float EMBED and SIMILAR through a ClusterClient.
"""

import time

import numpy as np

from neumann_tpu_torch.chain.node import ClusterClient, TcpClusterNode
from neumann_tpu_torch.chain.raft import RaftConfig
from neumann_tpu_torch.store.tensor_store import TensorData
from tests.torch_twins import twin_tests

globals().update(twin_tests("test_multiprocess_cluster",
                            packages=("port",)))


def _cluster():
    cfg = RaftConfig(election_timeout_min=30, election_timeout_max=60)
    nodes = {nid: TcpClusterNode(nid, {}, port=0, config=cfg, seed=i,
                                 device="cpu")
             for i, nid in enumerate(("n0", "n1", "n2"))}
    addrs = {nid: n.address for nid, n in nodes.items()}
    for nid, n in nodes.items():
        n._peer_addrs = {p: addrs[p] for p in addrs if p != nid}
        n.raft.voters = set(addrs)
        n.start(tick_interval_s=0.01)
    return nodes


def _wait(cond, what, timeout=30.0):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, what
        time.sleep(0.05)


def test_tcp_node_cas_over_real_sockets_slow_elections():
    """Follower-forwarded conditional writes resolve identically on
    every node over real TCP."""
    nodes = _cluster()
    try:
        _wait(lambda: any(n.is_leader() for n in nodes.values()),
              "no leader")
        leader = next(n for n in nodes.values() if n.is_leader())
        follower = next(n for n in nodes.values() if not n.is_leader())
        assert leader.propose_put("reg", TensorData.with_values(v=1))
        _wait(lambda: leader.store.get("reg") is not None, "no put")
        r1 = leader.propose_cas("reg", "v", 1, TensorData.with_values(v=2))
        assert r1 is not None
        _wait(lambda: leader.cas_result(r1) is not None, "no CAS result")
        assert leader.cas_result(r1) is True
        # stale expected value: loses (the value is now 2)
        r2 = leader.propose_cas("reg", "v", 1, TensorData.with_values(v=9))
        _wait(lambda: leader.cas_result(r2) is not None, "no CAS result")
        assert leader.cas_result(r2) is False
        _wait(lambda: all(n.store.get("reg") is not None
                          and n.store.get("reg").get("v").value == 2
                          for n in nodes.values()), "replicas differ")
        # a follower's CAS goes through the leader; its outcome applies
        # on the follower's own replica
        r3 = follower.propose_cas("reg", "v", 2,
                                  TensorData.with_values(v=3))
        assert r3 is not None
        _wait(lambda: follower.cas_result(r3) is not None,
              "no follower CAS result")
        assert follower.cas_result(r3) is True
        _wait(lambda: all(n.store.get("reg").get("v").value == 3
                          for n in nodes.values()), "replicas differ")
    finally:
        for n in nodes.values():
            n.stop()


def test_768_float_statements_through_a_cluster_client():
    """An EMBED of 768 floats (over the reference's 4,096-character
    statement bound) replicates to every node through a follower, and a
    SIMILAR of it through another node finds it first."""
    nodes = _cluster()
    try:
        _wait(lambda: any(n.is_leader() for n in nodes.values()),
              "no leader")
        follower = next(n for n in nodes.values() if not n.is_leader())
        rng = np.random.default_rng(7)
        vecs = rng.standard_normal((3, 768)).astype(np.float32)
        lit = ["[" + ", ".join(f"{x:.7g}" for x in v) + "]" for v in vecs]
        c = ClusterClient(follower.address)
        try:
            for i, v in enumerate(lit):
                assert c.execute(f"EMBED STORE 'v{i}' {v}",
                                 timeout=20.0)["message"]
        finally:
            c.close()
        _wait(lambda: all(n.router.vector.count_embeddings() == 3
                          for n in nodes.values()), "not replicated")
        for n in nodes.values():
            c = ClusterClient(n.address)
            try:
                hits = c.execute(f"SIMILAR {lit[1]} TOP 2",
                                 timeout=20.0)["hits"]
            finally:
                c.close()
            assert hits[0]["key"] == "v1"
            assert abs(hits[0]["score"] - 1.0) < 1e-5
    finally:
        for n in nodes.values():
            n.stop()

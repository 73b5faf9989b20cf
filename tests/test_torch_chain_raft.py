"""The port's Raft layer, 2PC and cluster integration (copies in
neumann_tpu_torch/chain/) against the JAX package's, on the CPU.

Every scenario of tests/test_raft_wal.py, test_two_phase_hardening.py
and test_cluster_integration.py, and the chain cases that
tests/test_integration_parity.py holds (per-link partitions, the bridge
topology, minority commit, merge offers from both minorities, the
archetype registry, the TCP transport's dead peers and timeouts, the
reorder buffer and DST, membership callbacks, jepsen and the
linearizability checkers, CAS on replicas), runs on both packages as one
test parametrised over ``package`` (tests/torch_twins.py). The CAS over
real sockets with 30-60 ms election timeouts is left out: it has failed
under the parallel test load (tests/test_torch_chain_cluster.py holds
the port's CAS over sockets with 300 ms timeouts). Then the Raft WAL is
the same bytes in both packages, each loads the other's, and a node
restarts from the other package's WAL directory with the same answers.
"""

import time

import numpy as np

from neumann_tpu.chain import node as jnode
from neumann_tpu.chain import raft as jraft
from neumann_tpu.chain import raft_wal as jwal
from neumann_tpu_torch.chain import node as tnode
from neumann_tpu_torch.chain import raft as traft
from neumann_tpu_torch.chain import raft_wal as twal
from tests.torch_twins import twin_tests

globals().update(twin_tests("test_raft_wal"))
globals().update(twin_tests("test_two_phase_hardening"))
globals().update(twin_tests("test_cluster_integration"))
globals().update(twin_tests("test_integration_parity", (
    "test_one_way_partition_link", "test_link_quality_degradation",
    "test_heal_clears_link_faults",
    "test_bridge_topology_still_elects_and_commits",
    "test_minority_partition_cannot_commit",
    "test_simultaneous_merge_offers_from_both_minority_nodes",
    "test_archetype_registry_snapshot_roundtrip",
    "test_tcp_send_to_dead_peer_bounded",
    "test_tcp_recv_timeout_returns_none",
    "test_reorder_buffer_delays_and_releases",
    "test_dst_raft_safe_under_reordering_and_drops",
    "test_membership_health_callbacks",
    "test_jepsen_linearizable_under_reorder_and_partial_partition",
    "test_linearizability_checker_reductions_preserve_violations",
    "test_linearizability_checker_cas_semantics",
    "test_jepsen_cas_workload_linearizable",
    "test_cluster_cas_resolves_identically_on_all_replicas",
    "test_jepsen_multikey_workload_linearizable",
    "test_check_kv_isolates_violations_per_key")))

PACKAGES = {"jax": (jraft, jwal, jnode), "port": (traft, twal, tnode)}


def _write_wal(pkg, path):
    """A single-voter node of ``pkg`` with a WAL: elected, 30 entries (a
    vote, an overwritten suffix never reaches a single voter), compacted
    with snapshot data, then 5 entries more."""
    raft, wal, _ = PACKAGES[pkg]
    n = raft.RaftNode("solo", ["solo"], raft.RaftConfig(), seed=3,
                      wal=wal.RaftWal(path))
    for _ in range(30):
        n.tick()
    for i in range(30):
        n.propose({"op": "put", "key": f"k{i}", "v": [0.5 * i, -i],
                   "blob": "ab" * i})
    n.take_committed()
    n.compact(upto=20, snapshot_data={"store": "c25hcHNob3Q=", "n": 20})
    for i in range(5):
        n.propose({"after": i})
    n.take_committed()
    n._wal.close()
    return n


def test_raft_wal_files_are_the_same_bytes(tmp_path):
    """The same node history writes the same WAL file in both packages,
    and each package recovers the other's file to the same state."""
    a = _write_wal("jax", tmp_path / "jax.wal")
    b = _write_wal("port", tmp_path / "port.wal")
    assert (tmp_path / "jax.wal").read_bytes() == \
        (tmp_path / "port.wal").read_bytes()
    assert a.last_index() == b.last_index() == 36
    for reader, path in (("port", "jax.wal"), ("jax", "port.wal")):
        raft, wal, _ = PACKAGES[reader]
        st = wal.RaftWal(tmp_path / path).load()
        n = raft.RaftNode("solo", ["solo"], raft.RaftConfig(), seed=3,
                          wal=wal.RaftWal(tmp_path / path))
        assert (st.term, st.voted_for, st.snapshot_index) == \
            (a.term, a.voted_for, 20)
        assert n.snapshot_data == {"store": "c25hcHNob3Q=", "n": 20}
        assert [e.payload for e in n.log] == [e.payload for e in a.log]
        assert n.last_index() == 36


def _solo(pkg, wal_dir):
    _, _, node = PACKAGES[pkg]
    kw = {} if pkg == "jax" else {"device": "cpu"}
    n = node.TcpClusterNode("solo", {}, wal_dir=wal_dir, **kw)
    n.start(tick_interval_s=0.01)
    deadline = time.time() + 15
    while time.time() < deadline and not n.is_leader():
        time.sleep(0.05)
    assert n.is_leader()
    return n


RESTART_WRITES = (
    ["CREATE TABLE t (id INT PRIMARY KEY, x INT)",
     "CREATE COLLECTION c DIM 4 QUANTIZATION int8"]
    + [f"INSERT INTO t VALUES ({i}, {i * i})" for i in range(12)]
    + [f"EMBED BATCH [('r{i}', [{i}, 1, {-i % 3}, 0.5]), "
       f"('s{i}', [0, {i}, 1, -1])] IN c" for i in range(6)]
    + [f"EMBED STORE 'e{i}' [{i + 1}, 0, 1, {i % 2}]" for i in range(4)])
RESTART_READS = (
    "SELECT * FROM t WHERE x > 20", "SHOW COLLECTIONS",
    "SIMILAR [3, 1, 0, 0.5] IN c TOP 3", "SIMILAR [2, 0, 1, 0] TOP 2",
    "COUNT EMBEDDINGS")


def _answers(node_addr, pkg):
    _, _, node = PACKAGES[pkg]
    c = node.ClusterClient(node_addr)
    try:
        return [c.execute(q, timeout=10.0) for q in RESTART_READS]
    finally:
        c.close()


def _write_node(pkg, wal_dir):
    """A single-voter ``pkg`` node takes RESTART_WRITES (a compaction
    snapshot among them) and stops; returns its answers to
    RESTART_READS."""
    a = _solo(pkg, wal_dir)
    a.compact_threshold = 8
    try:
        _, _, node = PACKAGES[pkg]
        c = node.ClusterClient(a.address)
        try:
            for q in RESTART_WRITES:
                c.execute(q, timeout=10.0)
        finally:
            c.close()
        deadline = time.time() + 10
        while time.time() < deadline and a.raft.snapshot_index == 0:
            time.sleep(0.05)
        assert a.raft.snapshot_index > 0
        return _answers(a.address, pkg)
    finally:
        a.stop()


def _restarted(pkg, wal_dir, count):
    """Answers of a ``pkg`` node restarted from ``wal_dir`` once it has
    replayed ``count`` embeddings (the log's last writes, so the replay
    is whole). The node replays between two statements of one read, so
    it is polled by COUNT EMBEDDINGS alone (a statement about a
    collection not created yet fails meanwhile) and read after."""
    _, _, node = PACKAGES[pkg]
    b = _solo(pkg, wal_dir)
    try:
        c = node.ClusterClient(b.address)
        try:
            deadline = time.time() + 20
            while c.execute("COUNT EMBEDDINGS", timeout=10.0)["count"] \
                    != count and time.time() < deadline:
                time.sleep(0.1)
        finally:
            c.close()
        return _answers(b.address, pkg)
    finally:
        b.stop()


def _same_answers(want, got, skip=()):
    for q, w, g in zip(RESTART_READS, want, got):
        if q in skip:
            continue
        assert w.keys() == g.keys()
        for k in w:
            if k == "hits":
                assert [h["key"] for h in w[k]] == [h["key"] for h in g[k]]
                np.testing.assert_allclose([h["score"] for h in w[k]],
                                           [h["score"] for h in g[k]],
                                           rtol=1e-5)
            else:
                assert w[k] == g[k], (q, k)


def test_port_node_restarts_from_a_jax_nodes_wal_dir(tmp_path):
    """A JAX node's WAL directory (a compaction snapshot and the log
    after it): a port node restarted from it answers as a JAX node
    restarted from a copy of it does."""
    import shutil

    _write_node("jax", str(tmp_path / "a"))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    want = _restarted("jax", str(tmp_path / "a"), 4)
    got = _restarted("port", str(tmp_path / "b"), 4)
    assert want[-1]["count"] == 4
    _same_answers(want, got)


def test_a_restarted_port_node_keeps_its_collections(tmp_path):
    """A port node restarted from its own WAL directory answers as
    before the restart, its int8 collection still int8 (the snapshot
    carries the collection configs); a JAX node restarted from the same
    directory has the same rows."""
    import shutil

    want = _write_node("port", str(tmp_path / "a"))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    got = _restarted("port", str(tmp_path / "a"), 4)
    _same_answers(want, got)
    assert got[1]["rows"][0]["quantization"] == "int8"
    jgot = _restarted("jax", str(tmp_path / "b"), 4)
    _same_answers(want, jgot, skip=("SHOW COLLECTIONS",
                                    "SIMILAR [3, 1, 0, 0.5] IN c TOP 3"))
    assert jgot[1]["rows"][0]["count"] == 12

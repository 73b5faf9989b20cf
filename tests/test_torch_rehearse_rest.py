"""chip_smoke.py's phases on data of their own, rehearsed on the CPU at a
toy size (tests/torch_rehearsal.py): the 3,072-d binary collection (10),
the hybrid query (11), the shell on two routers (13), and the consensus
classification and the clusters of phase 18 (18b-d)."""

import chip_smoke
from tests.torch_rehearsal import rehearse


def test_chip_smoke_rehearses_wide_hybrid_shell_cluster(monkeypatch):
    rep = rehearse(monkeypatch, ("wide", "hybrid", "shell", "cluster"))
    assert rep["wide_mismatches"] == 0
    assert len(rep["wide_single_ms"]) == chip_smoke.N_WIDE_SINGLE - 1
    # phase 11 at 8,192 entities: FIND's tier mask opens the pooled gate
    # (pool 16, one tier-3 row in each), the hubs' masks do not
    assert rep["hybrid_find_pool"] == 16
    assert rep["hybrid_find_recall"] >= 0.95
    assert len(rep["hybrid_ms"]) == chip_smoke.N_HYBRID - 1
    assert rep["hybrid_bfs_reached"] > 1
    assert rep["hybrid_pagerank_max_rel_err"] <= chip_smoke.PAGERANK_RTOL
    # phase 13: the shell on two routers
    assert rep["shell_errors"] == 0 and rep["shell_max_rel_diff"] == 0
    assert rep["shell_doctor_devices"] == ["[OK ] devices         1 x cpu"]
    # phase 18: the consensus codes equal float64 off the thresholds,
    # every class present; every acknowledged row is read back first on
    # each replica, after the leader's SIGKILL too, through the int8 scan
    assert rep["consensus_mismatches"] == 0
    assert min(rep["consensus_class_counts"]) > 0
    assert rep["cluster_acked_rows"] == chip_smoke.CLUSTER_ROWS
    assert all(not p["lost"] and p["kernel"] == "int8_dot_scores"
               for p in rep["cluster_replicas"].values())
    assert rep["cluster_kill_acked_rows"] == chip_smoke.CLUSTER_ROWS
    assert all(r["lost"] == 0 and r["kernel"] == "int8_dot_scores"
               for r in rep["cluster_kill_reads"].values())
    assert len(rep["cluster_kill_reads"]) == 3

"""chip_smoke.py's brute-force phases rehearsed on the CPU at a toy size
(tests/torch_rehearsal.py): the pooled, int8 and binary routes of
phases 7-9 with their checks, served over HTTP (12b) and over gRPC
(19b), SIMILAR scattered over three shard-server processes (20), and
the same rows on a mesh of four logical devices (21)."""

import os

import chip_smoke
from tests.torch_rehearsal import rehearse


def test_chip_smoke_rehearses_brute_routes(monkeypatch):
    rep = rehearse(monkeypatch, ("brute", "mesh"))
    for key in ("pooled_recall_single", "pooled_recall_batch",
                "pooled_recall_filtered", "int8_recall_single",
                "int8_recall_batch"):
        assert rep[key] >= 0.95, key
    assert rep["int8_euclid_mismatches"] == 0
    assert len(rep["binary_single_ms"]) == chip_smoke.N_SINGLE - 1
    assert rep["binary_mismatches"] == 0
    # phase 12b: served over HTTP with batching on
    for part in ("pooled", "int8"):
        assert rep[f"served_{part}_recall"] >= 0.95, part
    for part in ("pooled", "int8", "binary"):
        assert rep[f"served_{part}_mean_cohort"] > 1, part
    assert rep["served_binary_mismatches"] == 0
    assert rep["served_filtered_recall"] >= 0.95
    assert rep["served_in_filter_ok"] and rep["points_query_mismatches"] == 0
    # phase 19b: the same routers served over gRPC: Execute, the Points
    # QueryStream / filtered queries, gRPC-web
    assert rep["grpc_pooled_recall"] >= 0.95
    assert rep["grpc_pooled_mean_cohort"] > 1
    assert rep["grpc_stream_recall"] >= 0.95
    assert rep["grpc_filtered_recall"] >= 0.95
    assert rep["grpc_bits_mismatches"] == rep["grpc_web_mismatches"] == 0
    assert rep["points_codec_native"]
    # phase 20: B's rows on three shard-server processes; every merge is
    # the shards' own, nprobe 3 equals the full fan-out, COUNT adds up,
    # and after a SIGKILL the answers are the live shards' merge
    assert sum(rep["sharded_sizes"]) == rep["sharded_count"] == 4096
    assert rep["sharded_mismatches"] == 0
    assert rep["sharded_nprobe_all_mismatches"] == 0
    assert rep["sharded_degraded_mismatches"] == 0
    assert min(rep["sharded_recall"], rep["sharded_nprobe3_recall"],
               rep["sharded_served_recall"]) >= 0.95
    assert set(rep["sharded_launches"]) == {"s0", "s1", "s2"}
    assert rep["launches_sharded"]["f32_pooled_bits"] == 0
    # phase 21: the same rows on a mesh of four logical devices; the f32
    # placement is the exact scan, the merge the shards' own, re-embedded
    # keys first on both placements without a rebuild
    assert rep["mesh_shards"] == {"f32": 4, "int8": 4, "ivf": 4}
    assert rep["mesh_f32_mismatches"] == rep["mesh_merge_mismatches"] == 0
    assert rep["mesh_fresh_not_first"] == {"ivf": 0, "f32": 0}
    assert rep["mesh_ivf_batched_top1_mismatches"] == {
        "search_self": 0, "fast_plain": 0, "fast": 0, "non_fast": 0}
    assert min(rep["mesh_ivf_recall_own_single"],
               rep["mesh_ivf_recall_own_batch"]) >= 0.95
    assert min(rep["mesh_int8_recall_batch"], rep["mesh_euclid_recall"],
               rep["mesh_filtered_recall"]) >= 0.95
    assert rep["mesh_ivf_recall_batch"] >= 0.85
    assert rep["launches_mesh"]["int8_pooled_bits"] == 0
    assert "NEUMANN_MESH_DEVICES" not in os.environ

"""chip_smoke.py's phases on phases 7-9's rows without their routers,
rehearsed on the CPU at a toy size (tests/torch_rehearsal.py): the pq
and tt collections (14), the ANN index APIs (15), the extended modules
(16) with the chain transactions of 18a, and equal scores on the pooled
routes (22)."""

import chip_smoke
from tests.torch_rehearsal import rehearse


def test_chip_smoke_rehearses_stores(monkeypatch):
    rep = rehearse(monkeypatch, ("quantized", "ann", "extended", "ties"))
    # phases 14-15: pq hits equal the plain ADC's, tt hits the exact scan
    # of the reconstruction, IVF hits an exact scan of the probed lists;
    # saved indexes load with the same hits
    assert rep["pq_mismatches"] == 0 and rep["tt_mismatches"] == 0
    assert rep["tt_sample_max_rel_err"] <= chip_smoke.TT_RTOL
    assert rep["pq_subspaces"] == chip_smoke.PQ_M
    assert rep["ivf_nprobe32_recall"] >= rep["ivf_nprobe8_recall"] > 0.5
    assert rep["hnsw_dense_recall"] > 0.5 and rep["saved_index_ok"]
    # the launch counts are kept per route; on the CPU nothing launches
    assert rep["launches_pq"]["pq_adc"] == rep["launches_ann"]["pq_adc"] == 0
    # phase 22: 4,096 rows x 4 take the pooled f32 and int8 routes, every
    # single top-10 holds copies, the store of copies in a row takes the
    # exact scan and meets ties across the 10th place, and every order is
    # the plain version's
    assert rep["ties_routes"] == {"default": "f32_pooled",
                                  "col/tq8": "int8_pooled",
                                  "run_euclidean": "exact"}
    assert rep["ties_lists_with_copies"] == 2 * chip_smoke.N_SINGLE
    assert rep["ties_run_straddles"] > 0
    assert rep["ties_mismatches"] == 0
    # phase 16: the rollback restores every route's hits and the events
    # table; EXPLAIN names each route's kernel; the blob comes back with
    # equal bytes; the query cache serves a repeat and not across a write
    assert rep["rollback_mismatches"] == 0
    assert rep["rollback_events_rows"] == chip_smoke.N_EVENTS
    assert rep["checkpoints_after"] == 3
    assert rep["explain_kernels"]["pooled"] == "f32_pooled_bits"
    assert rep["blob_checks"] == [True, "OK", "OK", True]
    assert rep["cache_entries"] == 256
    assert rep["cache_exact_hit_rate"] == 0.5
    assert rep["launches_rollback"]["f32_pooled_bits"] == 0
    # phase 18a: ROLLBACK CHAIN restores the hits
    assert rep["chain_rollback_mismatches"] == 0
    assert rep["chain_views"]["verify"] == "chain OK"

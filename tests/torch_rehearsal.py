"""chip_smoke.py's phases rehearsed on the CPU at a toy size, a group of
phases at a time (``chip_smoke.run(..., phases=...)``): each group runs
on the data it has in the whole run, so the tests that call ``rehearse``
hold the phases as one rehearsal of the whole script did, in files of
their own that the test workers take apart.

The sizes: 8 mixture centres instead of 4,096, so that 20,480 rows are
clustered like the real corpus (each row's neighbours come from its own
centre); the pooled gate lowered so that 4,096 rows take the pooled
routes; the auto-IVF threshold 10,000, 16 clusters, nprobe 8; and the
phases' own cuts below. The kernel phase, the launch checks and the
profiles need the card.
"""

import types


def rehearse(monkeypatch, phases) -> dict:
    """``chip_smoke.run`` on the CPU at the toy size for ``phases``."""
    import torch

    import chip_smoke
    from neumann_tpu_torch.engines.vector import VectorEngineConfig

    monkeypatch.setattr(chip_smoke, "N_CENTRES", 8)
    monkeypatch.setattr(chip_smoke, "HUB_DEGREE", 40)
    monkeypatch.setattr(chip_smoke, "HYBRID_ROWS", 8192)
    monkeypatch.setattr(chip_smoke, "HYBRID_EDGES", 32_768)
    monkeypatch.setattr(chip_smoke, "N_SERVED", 256)
    # phases 14-15 at a toy size: the legacy IVF index and IVFIndex with
    # 16 clusters, HNSW graphs of a few hundred rows, 1,024 tt rows
    monkeypatch.setattr(chip_smoke, "IVF_CLUSTERS", 16)
    monkeypatch.setattr(chip_smoke, "IVF_INDEX_CLUSTERS", 16)
    monkeypatch.setattr(chip_smoke, "TT_ROWS", 1024)
    monkeypatch.setattr(chip_smoke, "HNSW_ROWS", 512)
    monkeypatch.setattr(chip_smoke, "HNSW_QUANT_ROWS", 512)
    monkeypatch.setattr(chip_smoke, "HNSW_BINARY_ROWS", 256)
    # phase 16 at a toy size: collections of 2,048 rows, a 1 MiB blob,
    # 256 cache prompts
    monkeypatch.setattr(chip_smoke, "ROLLBACK_SUB_ROWS", 2048)
    monkeypatch.setattr(chip_smoke, "BLOB_BYTES", 1 << 20)
    monkeypatch.setattr(chip_smoke, "CACHE_PROMPTS", 256)
    monkeypatch.setattr(chip_smoke, "CACHE_MIX", 100)
    # phase 17's TOP 65 and delta batches: 256 queries
    monkeypatch.setattr(chip_smoke, "PHASE17_BATCH", 256)
    # phase 18: 256 chain keys, 512 deltas, clusters of 32 rows
    monkeypatch.setattr(chip_smoke, "N_CHAIN_KEYS", 256)
    monkeypatch.setattr(chip_smoke, "N_DELTAS", 512)
    monkeypatch.setattr(chip_smoke, "CLUSTER_ROWS", 32)
    # phase 21's batches: 256 queries
    monkeypatch.setattr(chip_smoke, "MESH_BATCH", 256)
    monkeypatch.setenv("NEUMANN_POOLED_MIN_ROWS", "1024")
    monkeypatch.setenv("NEUMANN_POOLED_MIN_POOLS", "64")
    cfg = VectorEngineConfig(ivf_auto_threshold=10_000, ivf_auto_clusters=16,
                             ivf_auto_nprobe=8)
    rep = chip_smoke.run(
        types.SimpleNamespace(seed=0, rows=20_480, pooled_rows=4096,
                              wide_rows=2048),
        torch.device("cpu"), config=cfg, on_card=False, phases=phases)
    assert "kernels" not in rep and "profile" not in rep
    assert set(rep["launches"]) == set(chip_smoke.KERNELS)
    return rep

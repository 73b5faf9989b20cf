"""The port's host modules of ROADMAP item 15 (copies of the JAX
package's, import lines changed): the tiered store
(``store/tiered.py``), Voronoi-sorted regional runs
(``store/regional.py``), the lock-order tracker
(``utils/lockcheck.py``) and the coverage-guided fuzzer
(``utils/covfuzz.py``), against the JAX package's, on the CPU.

Their JAX tests run on both packages (tests/torch_twins.py): the tiered
and observability tests of tests/test_tiered_observability.py (its OTLP
tests run on the port in tests/test_torch_server.py), the regional tests
of tests/test_store.py, the lock-order tests of tests/test_stress.py
(the port's routers built inside the tracker, on the CPU) and all of
tests/test_coverage_fuzz.py (the port's targets and the port's
coverage). Then the same inputs through both packages: regional runs
and their compaction are the same bytes on disk, and each package reads
the other's directory; a tiered store's cold segment is the same bytes,
and each package's store reads the other's segment back.
"""

import os

import numpy as np

from neumann_tpu.parallel.partitioner import VoronoiPartitioner as JVor
from neumann_tpu.store.regional import RegionalStore as JRegional
from neumann_tpu.store.tensor_store import TensorData as JData
from neumann_tpu.store.tiered import TieredStore as JTiered
from neumann_tpu_torch.parallel.partitioner import VoronoiPartitioner as TVor
from neumann_tpu_torch.store.regional import RegionalStore as TRegional
from neumann_tpu_torch.store.tensor_store import TensorData as TData
from neumann_tpu_torch.store.tiered import TieredStore as TTiered
from tests.torch_twins import twin_tests

globals().update(twin_tests("test_tiered_observability", (
    "test_tiered_put_get_migrate", "test_tiered_preload_delete_compact",
    "test_tiered_overwrite_cold", "test_query_metrics_and_slow_log",
    "test_router_records_metrics", "test_index_tracker", "test_span_logs",
    "test_hot_cold_shards"),
    # the port's spans log under the reference's logger name, as its copy
    # of utils/observability.py does
    port_patch={'logger="neumann_tpu_torch"': 'logger="neumann_tpu"'}))
globals().update(twin_tests("test_store", (
    "test_regional_store_locality_reads",
    "test_regional_store_compaction_and_reopen")))
globals().update(twin_tests("test_stress", (
    "test_lock_order_tracker_detects_inversion",
    "test_engines_have_no_lock_order_inversions",
    "test_new_paths_have_no_lock_order_inversions")))
globals().update(twin_tests("test_coverage_fuzz"))

_REGIONAL = {"jax": (JRegional, JVor), "port": (TRegional, TVor)}


def _regional_writes(pkg, directory):
    """Three flushes of 3 regions' vectors (one key written twice), then
    ``close``; returns the run files' names and bytes."""
    store_cls, vor = _REGIONAL[pkg]
    rng = np.random.default_rng(17)
    seeds = rng.standard_normal((3, 6)).astype(np.float32) * 5
    rs = store_cls(str(directory), vor(seeds), flush_threshold=7)
    for i in range(30):
        v = seeds[i % 3] + 0.2 * rng.standard_normal(6).astype(np.float32)
        rs.put(f"k{i}", v, f"payload-{i}".encode() * (1 + i % 4))
    rs.put("k4", seeds[2], b"rewritten")
    rs.close()
    return {n: (directory / n).read_bytes()
            for n in sorted(os.listdir(directory))}, seeds


def test_regional_runs_are_the_same_bytes(tmp_path):
    runs = {pkg: _regional_writes(pkg, tmp_path / pkg)
            for pkg in _REGIONAL}
    assert len(runs["port"][0]) >= 4
    assert runs["port"][0] == runs["jax"][0]
    seeds = runs["port"][1]
    # each package reads the other's runs as the JAX package reads its own
    rs = JRegional(str(tmp_path / "jax"), JVor(seeds))
    want = [rs.load_region(r) for r in range(3)]
    rs.close()
    for reader, writer in (("port", "jax"), ("jax", "port")):
        store_cls, vor = _REGIONAL[reader]
        rs = store_cls(str(tmp_path / writer), vor(seeds))
        assert [rs.load_region(r) for r in range(3)] == want
        second = rs.nearest_regions(seeds[1], 2)[1]
        assert rs.knn_candidates(seeds[1], nprobe=2) == \
            want[1] + want[second]
        rs.close()
    # then each compacts its own runs to the same single run
    for pkg in _REGIONAL:
        store_cls, vor = _REGIONAL[pkg]
        rs = store_cls(str(tmp_path / pkg), vor(seeds))
        assert rs.compact() == len(runs[pkg][0])
        rs.close()
    compacted = {pkg: {n: (tmp_path / pkg / n).read_bytes()
                       for n in os.listdir(tmp_path / pkg)}
                 for pkg in _REGIONAL}
    assert len(compacted["port"]) == 1
    assert compacted["port"] == compacted["jax"]


def _tiered_writes(store_cls, data_cls, directory):
    ts = store_cls(str(directory))
    for i in range(24):
        ts.put(f"k{i}", data_cls.with_values(v=i, name=f"n{i}",
                                             f=float(i) / 3))
    for _ in range(3):
        ts.get("k2")
    assert ts.migrate_cold(max_items=20) == 20
    ts.delete("k7")
    ts.close()
    return (directory / "cold.seg").read_bytes()


def test_tiered_cold_segment_is_the_same_bytes(tmp_path):
    segs = {pkg: _tiered_writes(store_cls, data_cls, tmp_path / pkg)
            for pkg, store_cls, data_cls in (("jax", JTiered, JData),
                                             ("port", TTiered, TData))}
    assert segs["port"] == segs["jax"] and len(segs["port"]) > 0
    # the port's store opens the JAX segment and appends after it
    ts = TTiered(str(tmp_path / "jax"))
    assert ts._segment._size == len(segs["jax"])
    ts.put("new", TData.with_values(v=-1))
    ts.migrate_cold()
    assert ts.get("new").get("v").value == -1
    ts.close()
    assert (tmp_path / "jax" / "cold.seg").read_bytes()[:len(segs["jax"])] \
        == segs["jax"]

"""The port's partitioners (``neumann_tpu_torch/parallel/partitioner.py``)
and its distributed planner against the JAX package's, on the CPU.

The partitioner and planner tests of tests/test_parallel.py run on both
packages (tests/torch_twins.py); its mesh tests are twinned in
tests/test_torch_mesh.py. Then the same numpy inputs go to both
packages: a ``SemanticPartitioner`` trained from one sample (below and
above ``kmeans``'s device threshold: centroids within 1e-5,
``assign_batch`` and ``query_shards`` equal), the consistent-hash ring
and Voronoi seeds (assignments equal, through ``add_shard`` /
``remove_shard`` too), and each JAX partitioner carried to the port by
``convert.partitioner_from_jax`` (both assign alike). The port's
package exports the JAX package's mesh names.
"""

import numpy as np
import pytest

from neumann_tpu.parallel import partitioner as jp
from neumann_tpu_torch import convert
from neumann_tpu_torch.parallel import partitioner as tp
from tests.torch_twins import twin_tests

globals().update(twin_tests("test_parallel", (
    "test_consistent_hash", "test_semantic_partitioner",
    "test_voronoi_partitioner", "test_scatter_gather_topk",
    "test_aggregate_and_first_non_empty", "test_concat_merge",
    "test_semantic_routing", "test_shard_failure_degrades")))


def _mixture(seed, n, d, k, spread=6.0):
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((k, d)).astype(np.float32) * spread
    return (centres[rng.integers(0, k, n)]
            + rng.standard_normal((n, d))).astype(np.float32)


# n * d below and at kmeans's device threshold (262,144 elements): the
# numpy Lloyd steps in both packages, then JAX's jitted steps against
# the port's torch steps on the CPU
@pytest.mark.parametrize("n,d", [(600, 16), (4096, 64)])
def test_semantic_partitioner_trains_alike(n, d):
    sample = _mixture(3, n, d, 5)
    j = jp.SemanticPartitioner(5)
    t = tp.SemanticPartitioner(5, device="cpu")
    j.train(sample, iters=12)
    t.train(sample, iters=12)
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=0, atol=1e-5)
    probe = _mixture(4, 512, d, 5)
    np.testing.assert_array_equal(t.assign_batch(probe),
                                  j.assign_batch(probe))
    for q in probe[:32]:
        for nprobe in (1, 2, 5):
            assert t.query_shards(q, nprobe) == j.query_shards(q, nprobe)
        assert t.assign(q) == j.assign(q)


def test_semantic_partitioner_needs_training():
    for p in (jp.SemanticPartitioner(2), tp.SemanticPartitioner(2)):
        with pytest.raises(ValueError, match="not trained"):
            p.assign_batch(np.ones((1, 4), np.float32))
        with pytest.raises(ValueError, match="not trained"):
            p.query_shards(np.ones(4, np.float32))


def test_consistent_hash_assigns_alike():
    shards = [f"s{i}" for i in range(5)]
    j = jp.ConsistentHashPartitioner(shards, virtual_nodes=32)
    t = tp.ConsistentHashPartitioner(shards, virtual_nodes=32)
    keys = [f"user:{i}" for i in range(3000)] + ["", "é", "k" * 300]
    assert [t.assign(k) for k in keys] == [j.assign(k) for k in keys]
    assert t._ring == j._ring and t.shards == j.shards
    for p in (j, t):
        p.add_shard("s5")
        p.remove_shard("s1")
    assert [t.assign(k) for k in keys] == [j.assign(k) for k in keys]
    assert t.shards == j.shards
    for mod in (jp, tp):
        with pytest.raises(ValueError):
            mod.ConsistentHashPartitioner([])


def test_voronoi_assigns_alike():
    rng = np.random.default_rng(5)
    seeds = rng.standard_normal((7, 12)).astype(np.float32)
    pts = rng.standard_normal((2000, 12)).astype(np.float32) * 1.5
    j, t = jp.VoronoiPartitioner(seeds), tp.VoronoiPartitioner(seeds)
    np.testing.assert_array_equal(t.assign_batch(pts), j.assign_batch(pts))
    assert [t.assign(p) for p in pts[:200]] == \
        [j.assign(p) for p in pts[:200]]
    np.testing.assert_array_equal(t.region_of(3), j.region_of(3))
    for mod in (jp, tp):
        with pytest.raises(ValueError, match=r"\[k, d\]"):
            mod.VoronoiPartitioner(np.zeros((0, 3), np.float32))


def test_partitioners_carried_from_jax():
    """``convert.partitioner_from_jax``: a trained JAX semantic
    partitioner, Voronoi seeds and a hash ring (after a shard was added
    and one removed) assign alike on the port, without training."""
    sample = _mixture(6, 900, 24, 4)
    sem = jp.SemanticPartitioner(4)
    sem.train(sample)
    ring = jp.ConsistentHashPartitioner(["a", "b", "c"], virtual_nodes=16)
    ring.add_shard("d")
    ring.remove_shard("a")
    vor = jp.VoronoiPartitioner(sample[:6])
    got = {name: convert.partitioner_from_jax(p, device="cpu")
           for name, p in (("sem", sem), ("ring", ring), ("vor", vor))}
    assert isinstance(got["sem"], tp.SemanticPartitioner)
    assert got["sem"].device == "cpu"
    probe = _mixture(7, 300, 24, 4)
    np.testing.assert_array_equal(got["sem"].assign_batch(probe),
                                  sem.assign_batch(probe))
    assert [got["sem"].query_shards(q, 2) for q in probe[:20]] == \
        [sem.query_shards(q, 2) for q in probe[:20]]
    np.testing.assert_array_equal(got["vor"].assign_batch(probe),
                                  vor.assign_batch(probe))
    keys = [f"k{i}" for i in range(1000)]
    assert [got["ring"].assign(k) for k in keys] == \
        [ring.assign(k) for k in keys]
    assert got["ring"].shards == ["b", "c", "d"]
    untrained = convert.partitioner_from_jax(jp.SemanticPartitioner(2))
    assert untrained.centroids is None and untrained.device == "cuda"
    with pytest.raises(TypeError):
        convert.partitioner_from_jax(object())


@pytest.mark.parametrize("name", ["make_mesh", "ShardedCorpus",
                                  "ShardedIVFCorpus", "make_sharded_topk"])
def test_mesh_names_import(name):
    import neumann_tpu.parallel as jpar
    import neumann_tpu_torch.parallel as par

    assert callable(getattr(par, name))
    assert getattr(par, name).__name__ == getattr(jpar, name).__name__
    with pytest.raises(AttributeError):
        par.no_such_name  # noqa: B018

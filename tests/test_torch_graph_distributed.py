"""The port's distributed graph engine
(``neumann_tpu_torch/engines/graph_distributed.py``, a copy of the JAX
module whose ``DistributedGraphEngine`` takes ``device``) against the
JAX package's, on the CPU.

Every test of tests/test_graph_distributed.py runs on both packages
(tests/torch_twins.py): the hash / modular / range partitioners and
pinned assignments, cross-shard edges, the standalone engine's writes,
reads, statistics and analytics, transactions, the cross-shard query,
and graph writes replicated through a three-node Raft cluster onto the
followers' graph mirrors, leader gating and lost quorum. The port's
graph engines are asked for the CPU. Then the engines' names, exported
lazily by ``neumann_tpu_torch.engines`` as the JAX package exports them,
and the same writes through both packages' standalone engines give the
same shards, nodes, edges and statistics.
"""

import pytest

from tests.torch_twins import twin_tests

globals().update(twin_tests("test_graph_distributed"))


def test_engines_package_exports_the_distributed_names():
    import neumann_tpu.engines as jeng
    import neumann_tpu_torch.engines as teng
    from neumann_tpu_torch.engines import graph_distributed

    for name in ("CrossShardQuery", "DistributedConfig",
                 "DistributedGraphEngine", "GraphPartitioner",
                 "PartitionConfig", "PartitionStrategy"):
        assert hasattr(jeng, name)
        assert getattr(teng, name) is getattr(graph_distributed, name)
    with pytest.raises(AttributeError):
        teng.NoSuchEngine  # noqa: B018


def test_standalone_engines_write_alike():
    from neumann_tpu.engines import graph_distributed as jgd
    from neumann_tpu_torch.engines import graph_distributed as tgd

    engines = {}
    for pkg, mod, kw in (("jax", jgd, {}), ("port", tgd, {"device": "cpu"})):
        cfg = mod.DistributedConfig(partition_config=mod.PartitionConfig(
            num_shards=4))
        eng = mod.DistributedGraphEngine(cfg, **kw)
        ids = [eng.create_node("P", {"i": i}) for i in range(40)]
        for i in range(39):
            eng.create_edge(ids[i], ids[(i * 7 + 3) % 40], "R", {"w": i})
        with eng.begin_transaction() as tx:
            tx.create_node("Q", {"i": 99})
        engines[pkg] = (eng, ids)
    (je, jids), (te, tids) = engines["jax"], engines["port"]
    assert tids == jids
    assert [te.shard_for_node(i) for i in tids] == \
        [je.shard_for_node(i) for i in jids]
    assert [te.get_node(i) for i in tids] == [je.get_node(i) for i in jids]
    assert [sorted(te.neighbors(i)) for i in tids] == \
        [sorted(je.neighbors(i)) for i in jids]
    assert vars(te.stats) == vars(je.stats)
    assert vars(te.partition_stats()) == vars(je.partition_stats())
    assert te.local_engine().device.type == "cpu"

"""Scaling out: partitioners and the distributed planner.

``partitioner.py``: consistent-hash, semantic and Voronoi partitioners,
and k-means. ``distributed.py``: the query planner, the shard-result
merger and the scatter-gather executor, over routers in the process or
shard servers reached through ``NeumannClient``
(``QueryRouter.attach_planner`` wires them into ``execute``).

The mesh (``make_mesh``, ``ShardedCorpus``, ``ShardedIVFCorpus``,
``make_sharded_topk``) is not ported yet: importing one of those names
from here raises ``NeumannError`` naming its ROADMAP item.
"""

from neumann_tpu_torch.parallel.partitioner import (  # noqa: F401
    ConsistentHashPartitioner,
    SemanticPartitioner,
    VoronoiPartitioner,
)

_MESH = ("make_mesh", "ShardedCorpus", "ShardedIVFCorpus",
         "make_sharded_topk")


def __getattr__(name):
    if name in _MESH:
        from neumann_tpu_torch.utils.errors import NeumannError

        raise NeumannError(f"{name} (the mesh) is not ported to the PyTorch "
                           f"package yet (ROADMAP: item 12b)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

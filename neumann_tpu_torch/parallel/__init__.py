"""Scaling out: the mesh, sharded corpora, partitioners and the
distributed planner.

``mesh.py``: ``make_mesh``, a device mesh that this process drives
(in tests ``NEUMANN_MESH_DEVICES`` gives it logical devices, as XLA's
host device count flag does for JAX). ``sharded_search.py``: ``ShardedCorpus`` and
``ShardedIVFCorpus``, corpora sharded over a mesh, each shard searched on
its device and the shards' top-k merged (``make_sharded_topk``).
``partitioner.py``: consistent-hash, semantic and Voronoi partitioners,
and k-means. ``distributed.py``: the query planner, the shard-result
merger and the scatter-gather executor, over routers in the process or
shard servers reached through ``NeumannClient``
(``QueryRouter.attach_planner`` wires them into ``execute``).
"""

from neumann_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from neumann_tpu_torch.parallel.partitioner import (  # noqa: F401
    ConsistentHashPartitioner,
    SemanticPartitioner,
    VoronoiPartitioner,
)
from neumann_tpu_torch.parallel.sharded_search import (  # noqa: F401
    ShardedCorpus,
    ShardedIVFCorpus,
    make_sharded_topk,
)

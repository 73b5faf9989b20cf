"""Query engines: vector (``vector.py``), relational
(``relational.py``), graph (``graph.py`` with ``graph_algorithms.py``),
the distributed graph engine (``graph_distributed.py``), unified
(``unified.py``) and the shared condition tree (``condition.py``).

Nothing is imported eagerly here: ``condition`` must stay importable
without torch-side state, and a user of the parser should not pay for
the vector engine's imports.
"""

_VECTOR = ("FilterCondition", "SearchResult", "VectorCollectionConfig",
           "VectorEngine", "VectorEngineConfig")
_GRAPH_DISTRIBUTED = ("CrossShardQuery", "DistributedConfig",
                      "DistributedGraphEngine", "GraphPartitioner",
                      "PartitionConfig", "PartitionStrategy")


def __getattr__(name):
    """The vector and distributed graph engines' names, as the reference
    exports them here, imported at first use."""
    if name in _VECTOR:
        from neumann_tpu_torch.engines import vector

        return getattr(vector, name)
    if name in _GRAPH_DISTRIBUTED:
        from neumann_tpu_torch.engines import graph_distributed

        return getattr(graph_distributed, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

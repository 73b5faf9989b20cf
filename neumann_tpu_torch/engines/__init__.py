"""Query engines: vector (``vector.py``), relational
(``relational.py``), graph (``graph.py`` with ``graph_algorithms.py``),
unified (``unified.py``) and the shared condition tree
(``condition.py``).

Nothing is imported eagerly here: ``condition`` must stay importable
without torch-side state, and a user of the parser should not pay for
the vector engine's imports.
"""

_VECTOR = ("FilterCondition", "SearchResult", "VectorCollectionConfig",
           "VectorEngine", "VectorEngineConfig")


def __getattr__(name):
    """The vector engine's names, as the reference exports them here,
    imported at first use."""
    if name in _VECTOR:
        from neumann_tpu_torch.engines import vector

        return getattr(vector, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

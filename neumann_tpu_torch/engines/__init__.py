"""Query engines: vector (``vector.py``), relational
(``relational.py``), graph (``graph.py`` with ``graph_algorithms.py``),
unified (``unified.py``) and the shared condition tree
(``condition.py``).

Nothing is imported eagerly here: ``condition`` must stay importable
without torch-side state, and a user of the parser should not pay for
the vector engine's imports.
"""

"""Query engines. The port has the vector engine's auto-IVF slice
(``vector.py``) and the shared condition tree (``condition.py``).

Nothing is imported eagerly here: ``condition`` must stay importable
without torch-side state, and a user of the parser should not pay for
the vector engine's imports.
"""

"""Error types, shape padding and query metrics: the port's copies of
``neumann_tpu/utils/errors.py``, ``shapes.py`` and
``observability.py``."""

"""Error types, shape padding, query metrics, OTLP export, the
lock-order tracker and the coverage-guided fuzzer: the port's copies of
``neumann_tpu/utils/errors.py``, ``shapes.py``, ``observability.py``,
``otlp.py``, ``lockcheck.py`` and ``covfuzz.py``."""

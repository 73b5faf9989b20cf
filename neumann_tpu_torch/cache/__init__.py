"""tensor_cache parity: 3-layer LLM response cache.

The port's copy of ``neumann_tpu/cache/__init__.py``:
only its import lines differ.
"""

from neumann_tpu_torch.cache.llm_cache import LLMCache, CacheStats  # noqa: F401

"""Storage of the port: the host store, entity index, codec, WAL,
snapshots, the tiered store (``tiered.py``) and the region-sorted runs
(``regional.py``) (copies of the JAX package's modules, import lines
changed) and the embedding slab with torch device views
(``embedding_slab.py``). The package exports the JAX package's names."""

from neumann_tpu_torch.store.sparse import SparseVector  # noqa: F401
from neumann_tpu_torch.store.tensor_store import (  # noqa: F401
    ScalarValue,
    TensorData,
    TensorStore,
    TensorValue,
)
from neumann_tpu_torch.store.entity_index import EntityIndex  # noqa: F401
from neumann_tpu_torch.store.embedding_slab import EmbeddingSlab  # noqa: F401

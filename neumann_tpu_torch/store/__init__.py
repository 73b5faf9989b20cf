"""Storage of the port: the host store, entity index, codec, WAL and
snapshots (copies of the JAX package's modules, import lines changed)
and the embedding slab with torch device views
(``embedding_slab.py``)."""

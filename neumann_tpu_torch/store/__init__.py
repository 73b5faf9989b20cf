"""The embedding slab with torch device views (``embedding_slab.py``);
the host store and entity index are the JAX package's, reused."""

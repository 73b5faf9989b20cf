"""k-means for the IVF build (``partitioner.py``). Mesh placement and
sharded search are not ported yet."""

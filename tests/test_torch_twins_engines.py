"""The JAX package's vector-engine, unified-engine, ingest and index tests
run on the port: tests/test_vector_engine.py, test_unified.py,
test_auto_ivf.py, test_batched_serving.py, test_bulk_ingest.py,
test_ingest_matrix.py, test_host_pull.py, test_hnsw.py,
test_compress_ivf.py and test_scaling_comparison.py.

Port side only (``twin_tests(..., packages=("port",))``): the JAX side
runs in the files themselves. The loader (tests/torch_twins.py) asks the
port's card-default entry points for the CPU and hands numpy inputs of
``ops/`` over as CPU tensors.

test_compress_ivf.py's PQ tests read the codes, decodes and hits back
to the host: the port's ``PQCodebook`` keeps them on its device."""

from tests.torch_twins import twin_tests

_PORT = ("port",)

globals().update(twin_tests("test_vector_engine", packages=_PORT))
globals().update(twin_tests("test_unified", packages=_PORT))
globals().update(twin_tests("test_auto_ivf", packages=_PORT))
globals().update(twin_tests("test_batched_serving", packages=_PORT))
globals().update(twin_tests("test_bulk_ingest", packages=_PORT))
globals().update(twin_tests("test_ingest_matrix", packages=_PORT))
globals().update(twin_tests("test_host_pull", packages=_PORT, torch_jnp=True))
globals().update(twin_tests("test_hnsw", packages=_PORT))
# the port's PQ codebook keeps codes, decodes and hits on its device (as
# tensors); the JAX package's returns host arrays
globals().update(twin_tests(
    "test_compress_ivf", packages=_PORT, torch_jnp=True, port_patch={
    "codes = pq.encode(data)": "codes = pq.encode(data).numpy()",
    "back = pq.decode(codes)": "back = pq.decode(codes).numpy()",
    "pq.decode(codes[7:8])[0]": "pq.decode(codes[7:8])[0].numpy()",
    "s, i = pq_topk(pq, codes, queries, 10)":
        "s, i = (t.numpy() for t in pq_topk(pq, codes, queries, 10))",
    "s2, i2 = pq_topk(pq, codes, queries, 5, mask)":
        "s2, i2 = (t.numpy() for t in pq_topk(pq, codes, queries, 5, mask))",
}))
globals().update(twin_tests("test_scaling_comparison", packages=_PORT))

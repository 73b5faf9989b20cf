"""The JAX package's graph, relational and router tests run on the port:
tests/test_graph.py, test_graph_differential.py, test_relational.py,
test_relational_streaming.py and test_router.py.

Port side only (``twin_tests(..., packages=("port",))``): the JAX side
runs in the files themselves. The loader (tests/torch_twins.py) asks the
port's card-default entry points for the CPU and hands numpy inputs of
``ops/`` over as CPU tensors.

Patched: EXPLAIN SIMILAR ... CONNECTED TO names the port's route
("unified engine") where the JAX router names the TPU's MXU. Left out:
test_router.py::test_query_result_cache, whose JAX query cache goes
through the LLM cache (``semantic_threshold``, its hit count); the port
replaced it by a dict of the router's that every write empties, a
reference fault repaired (tests/test_torch_llm_cache.py)."""

from tests.torch_twins import twin_tests

_PORT = ("port",)

globals().update(twin_tests("test_graph", packages=_PORT))
globals().update(twin_tests("test_graph_differential", packages=_PORT))
globals().update(twin_tests("test_relational", packages=_PORT))
globals().update(twin_tests("test_relational_streaming", packages=_PORT))
# EXPLAIN names the port's route where the JAX router names the TPU's MXU;
# test_query_result_cache is left out: the JAX query cache goes through the
# LLM cache (semantic_threshold, its hit count), which the port replaced by
# a dict of the router's that a write empties (a reference fault repaired,
# tests/test_torch_llm_cache.py)
globals().update(twin_tests("test_router", packages=_PORT, port_patch={
    'assert "MXU matmul" in sim[0]["detail"]':
        'assert "unified engine" in sim[0]["detail"]'},
    leave_out=("test_query_result_cache",)))

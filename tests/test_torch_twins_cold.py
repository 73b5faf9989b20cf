"""The JAX package's cold-branch tests run on the port:
tests/test_cold_branches_r4.py and test_cold_branches_r4b.py to
test_cold_branches_r4e.py.

Port side only (``twin_tests(..., packages=("port",))``): the JAX side
runs in the files themselves. The loader (tests/torch_twins.py) asks the
port's card-default entry points for the CPU and hands numpy inputs of
``ops/`` over as CPU tensors."""

from tests.torch_twins import twin_tests

_PORT = ("port",)

globals().update(twin_tests("test_cold_branches_r4", packages=_PORT))
globals().update(twin_tests("test_cold_branches_r4b", packages=_PORT))
globals().update(twin_tests("test_cold_branches_r4c", packages=_PORT))
globals().update(twin_tests("test_cold_branches_r4d", packages=_PORT))
globals().update(twin_tests(
    "test_cold_branches_r4e", packages=_PORT, torch_jnp=True))

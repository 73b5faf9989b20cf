"""The JAX package's fuzz tests run on the port: tests/test_fuzz.py and
test_fuzz_targets.py to test_fuzz_targets5.py.

Port side only (``twin_tests(..., packages=("port",))``): the JAX side
runs in the files themselves. The loader (tests/torch_twins.py) asks the
port's card-default entry points for the CPU and hands numpy inputs of
``ops/`` over as CPU tensors."""

from tests.torch_twins import twin_tests

_PORT = ("port",)

globals().update(twin_tests("test_fuzz", packages=_PORT))
globals().update(twin_tests(
    "test_fuzz_targets", packages=_PORT, torch_jnp=True))
globals().update(twin_tests("test_fuzz_targets2", packages=_PORT))
globals().update(twin_tests("test_fuzz_targets3", packages=_PORT))
globals().update(twin_tests("test_fuzz_targets4", packages=_PORT))
globals().update(twin_tests("test_fuzz_targets5", packages=_PORT))

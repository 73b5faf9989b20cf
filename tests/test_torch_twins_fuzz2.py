"""The JAX package's remaining fuzz, property and stress tests run on the
port: tests/test_fuzz_targets6.py to test_fuzz_targets9.py,
test_mutation_gaps.py, test_property.py, test_stress2.py and
test_deep_sweeps.py.

Port side only (``twin_tests(..., packages=("port",))``): the JAX side
runs in the files themselves. The loader (tests/torch_twins.py) asks the
port's card-default entry points for the CPU and hands numpy inputs of
``ops/`` over as CPU tensors."""

from tests.torch_twins import twin_tests

_PORT = ("port",)

globals().update(twin_tests("test_fuzz_targets6", packages=_PORT))
globals().update(twin_tests("test_fuzz_targets7", packages=_PORT))
globals().update(twin_tests(
    "test_fuzz_targets8", packages=_PORT, torch_jnp=True))
globals().update(twin_tests("test_fuzz_targets9", packages=_PORT))
globals().update(twin_tests("test_mutation_gaps", packages=_PORT))
globals().update(twin_tests("test_property", packages=_PORT))
globals().update(twin_tests("test_stress2", packages=_PORT))
globals().update(twin_tests("test_deep_sweeps", packages=_PORT))

"""The port's composed deterministic simulation (neumann_tpu_torch/chain/
``dst.py``, ``model_check.py``, ``cluster.py``, copies of the JAX
package's modules with only their import lines changed), on the CPU.

The scenarios of tests/test_dst_composed.py run on the port alone
(tests/torch_twins.py with ``packages=("port",)``): the JAX side runs in
that file already. Its membership model check, the longest, is in
tests/test_torch_chain_model_check.py, so no file holds more than one
of the two long checks.
"""

from tests.torch_twins import twin_tests

globals().update(twin_tests("test_dst_composed", (
    "test_composed_fault_schedule", "test_model_check_two_phase_bounded",
    "test_model_check_two_phase_three_parts",
    "test_jepsen_compose_topologies_valid",
    "test_composed_with_auto_membership"), packages=("port",)))

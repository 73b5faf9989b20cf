"""The port's membership model check (neumann_tpu_torch/chain/
``model_check.py``, a copy of the JAX package's module with only its
import lines changed), on the CPU: tests/test_dst_composed.py's
``test_model_check_membership_bounded`` on the port alone
(tests/torch_twins.py with ``packages=("port",)``; the JAX side runs in
that file). It is the longest of the chain's checks, so it has a file of
its own.
"""

from tests.torch_twins import twin_tests

globals().update(twin_tests("test_dst_composed", (
    "test_model_check_membership_bounded",), packages=("port",)))

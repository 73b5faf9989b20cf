"""The port's Python SDK (``neumann_tpu_torch.server``: ``NeumannClient``
remote and embedded, ``AsyncNeumannClient``, ``Transaction``,
``RetryConfig`` and the numpy / pandas integrations), on the CPU.

tests/test_sdk.py runs on the port as its twin (the JAX side runs in its
own file), the embedded client and the server asked for the CPU. Each
package's client against the other's server: tests/test_torch_server.py.
"""

from tests.torch_twins import twin_tests

globals().update(twin_tests("test_sdk", packages=("port",)))

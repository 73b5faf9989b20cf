"""Serving on the PyTorch port (port of ``neumann_tpu/server``): the gRPC
server and its Python SDK client (remote and embedded), the query
batcher, the REST facade with its gRPC-web gateway, web admin and
gamification pages, and the JSON helpers they share.
"""

from neumann_tpu_torch.server.batcher import (  # noqa: F401
    BatcherClosed,
    QueryBatcher,
)
from neumann_tpu_torch.server.client import NeumannClient  # noqa: F401
from neumann_tpu_torch.server.rest import RestServer  # noqa: F401
from neumann_tpu_torch.server.retry import RetryConfig  # noqa: F401
from neumann_tpu_torch.server.server import NeumannServer  # noqa: F401
from neumann_tpu_torch.server.transaction import Transaction  # noqa: F401

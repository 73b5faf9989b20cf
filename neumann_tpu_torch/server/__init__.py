"""Serving on the PyTorch port (port of ``neumann_tpu/server``): the
query batcher, the REST facade with its web admin and gamification
pages, and the JSON helpers they share.

``NeumannServer`` (gRPC) is a stub that raises ``NeumannError``: the
gRPC server, its clients, the gRPC-web gateway and the Points plane
need ``grpcio`` or ``protobuf`` and are ROADMAP item 4's next half.
"""

from neumann_tpu_torch.server.batcher import (  # noqa: F401
    BatcherClosed,
    QueryBatcher,
)
from neumann_tpu_torch.server.rest import RestServer  # noqa: F401
from neumann_tpu_torch.server.server import NeumannServer  # noqa: F401

"""The transport-free part of ``neumann_tpu/server/server.py``: the JSON
encoding of results and the JSON filter syntax, which the REST facade
(``server/rest.py``) shares with the gRPC server.

The gRPC server itself (``NeumannServer``, ``main``) needs ``grpcio``
and ``protobuf`` and is not ported yet: both raise ``NeumannError``
naming ROADMAP item 4's gRPC half.
"""

from __future__ import annotations

import base64
import json

import numpy as np
import torch

from neumann_tpu_torch.utils.errors import NeumannError

VERSION = "0.1.0"

_GRPC_ITEM = "4, the gRPC server and its clients"


def _json_default(v):
    if isinstance(v, bytes):
        return {"__b64__": base64.b64encode(v).decode()}
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return v.tolist()
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (torch.dtype, torch.device)):
        return str(v)
    raise TypeError(f"unserializable {type(v)}")


def dumps(obj) -> str:
    return json.dumps(obj, default=_json_default)


def _filter_from_json(obj) -> "FilterCondition":
    from neumann_tpu_torch.engines.vector import FilterCondition as F

    op = obj["op"]
    if op in ("and", "or"):
        left = _filter_from_json(obj["left"])
        right = _filter_from_json(obj["right"])
        return left.and_(right) if op == "and" else left.or_(right)
    if op == "true":
        return F.true()
    if op == "exists":
        return F.exists(obj["field"])
    if op == "in":
        # values as a tuple (FilterCondition.in_), so the filter hashes
        values = obj.get("value")
        if not isinstance(values, (list, tuple)):
            raise NeumannError("an 'in' filter needs a list 'value'")
        return F.in_(obj["field"], values)
    return F(op, obj["field"], obj.get("value"))


class NeumannServer:
    """Not ported yet: the gRPC server needs grpcio and protobuf."""

    def __init__(self, *args, **kwargs):
        raise NeumannError("the gRPC server is not ported to the PyTorch "
                           f"package yet (ROADMAP: {_GRPC_ITEM})")


def main(argv=None) -> int:
    raise NeumannError("the gRPC server is not ported to the PyTorch "
                       f"package yet (ROADMAP: {_GRPC_ITEM}); serve over "
                       "REST with neumann_tpu_torch.server.RestServer")

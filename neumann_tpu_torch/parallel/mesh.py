"""Mesh helpers (port of ``neumann_tpu/parallel/mesh.py``).

A ``Mesh`` is driven by one process, as JAX's single-controller
``jax.sharding.Mesh`` is: ``devices`` is a numpy object array of
``torch.device`` shaped like the mesh, ``axis_names`` names its axes and
``shape`` maps each axis to its size (an ``OrderedDict``, as JAX's
``Mesh.shape`` is). A sharded corpus keeps one shard's tensors on each
device along its axis, and the process launches every shard's work
itself; no ``torch.distributed`` process group is involved.

``make_mesh(n_devices, axis_names, device)`` follows JAX's rules over
``mesh_devices(device)``: the first n devices (all by default), a
``ValueError`` past their count, and the same reshape for more than one
axis name. The devices of "cuda" are every CUDA device of the machine,
those of "cpu" the one CPU device.

``NEUMANN_MESH_DEVICES=n`` (read at each call) is the counterpart of
XLA's ``--xla_force_host_platform_device_count`` and nothing more: it
makes the list n logical devices, dealt round-robin over the physical
ones. It is for tests and the chip smoke only (an 8-device mesh on the
CPU, a mesh of logical shards on one card), not a deployment setting:
logical shards of one card run one after another and serve no query
faster than the one-card routes. Without it a machine with one GPU has
a one-device mesh, and the vector engine places nothing on a mesh, as
the JAX engine does on one chip.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np
import torch

MESH_DEVICES_ENV = "NEUMANN_MESH_DEVICES"


class Mesh:
    """Devices in an array of named axes, driven by this process."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        self.shape = OrderedDict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` (the first along every other axis):
        where a corpus sharded over ``axis`` keeps its shards, in order."""
        i = self.axis_names.index(axis)
        along = np.moveaxis(self.devices, i, 0).reshape(
            self.devices.shape[i], -1)
        return list(along[:, 0])

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def mesh_devices(device="cuda") -> List[torch.device]:
    """The devices a mesh of ``device``'s type may take: the physical
    ones, or (tests only) ``NEUMANN_MESH_DEVICES`` logical ones dealt
    round-robin over them."""
    kind = torch.device(device).type
    if kind == "cuda":
        physical = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    else:
        physical = [torch.device(kind)]
    want = os.environ.get(MESH_DEVICES_ENV)
    if not want or not physical:
        return physical
    return [physical[i % len(physical)] for i in range(int(want))]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("shard",),
              device="cuda") -> Mesh:
    """1-D (or reshaped) device mesh over the first n devices."""
    devs = mesh_devices(device)
    n = n_devices or len(devs)
    if not devs:
        raise ValueError(f"no {torch.device(device).type} devices")
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    if len(axis_names) > 1:
        per = round(n ** (1 / len(axis_names)))
        shape = [per] * len(axis_names)
        shape[-1] = n // int(np.prod(shape[:-1]))
        arr = arr.reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))

"""Meshes.

``make_local_mesh`` lays the initialized ``torch.distributed`` world out
as a ``("data", "model")`` ``DeviceMesh``: the caller's process group,
whatever its backend.  ``make_production_mesh`` is the reference's TPU
pod meshes as a device-less ``{axis: size}`` description, for counting
and for resolving the sharding rules (``dist.MeshContext`` takes it).
Both are functions, so importing this module touches no process group.
"""
from __future__ import annotations

from typing import Dict, Optional


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """Single pod: (16, 16) = 256 chips ("data", "model").
    Multi-pod: (2, 16, 16) = 512 chips ("pod", "data", "model")."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_local_mesh(model_axis: int = 1, data_axis: Optional[int] = None):
    """The initialized world as a ("data", "model") ``DeviceMesh`` of
    (world / model_axis, model_axis) ranks, consecutive ranks along
    "model".  With ``data_axis`` the mesh is (data_axis, model_axis) and
    the world holds world / (data_axis * model_axis) such meshes over
    consecutive ranks: this rank's is returned (every rank builds them
    all, in order, as new process groups require).  The mesh's device
    type, which only DTensors read, is the CPU's: the port's collectives
    take tensors on any device the backend does."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialized torch.distributed "
                           "process group")
    n = dist.get_world_size()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the world of {n}")
    data_axis = n // model_axis if data_axis is None else data_axis
    size = data_axis * model_axis
    if data_axis < 1 or n % size:
        raise ValueError(f"a ({data_axis}, {model_axis}) mesh does not divide the world of {n}")
    meshes = [DeviceMesh("cpu", torch.arange(r, r + size).reshape(data_axis, model_axis),
                         mesh_dim_names=("data", "model")) for r in range(0, n, size)]
    return meshes[dist.get_rank() // size]

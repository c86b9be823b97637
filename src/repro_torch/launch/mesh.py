"""Mesh construction: the production shapes and a mesh over the host.

Functions, not module-level constants: importing this module touches no
process group.  Each builds a ``DeviceMesh`` over the current default
process group's world (``torch.distributed`` must be initialised), on
``device_type`` — the card's ``"cuda"`` unless the caller asks for
``"cpu"``, as the gloo tests do.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _mesh(shape, axes, device_type: str) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks; the world has {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(model_axis: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """Small mesh over whatever world exists (1x1 on one card)."""
    n = dist.get_world_size()
    model_axis = max(1, min(model_axis, n))
    return _mesh((n // model_axis, model_axis), ("data", "model"),
                 device_type)


def mesh_chips(mesh) -> int:
    return mesh.size()

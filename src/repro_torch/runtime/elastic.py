"""Elastic scaling: rebuild the mesh when the healthy-rank set changes.

The checkpoint format stores global (unsharded) arrays, so a job restored
on a different rank count just needs (1) a new mesh over the surviving
ranks, (2) re-derived layouts, (3) placement — all of which
``CheckpointManager.restore(shardings=...)`` performs.  This module decides
the new mesh shape and validates that the run configuration still divides.
``ElasticDecision`` and ``plan_mesh`` are the JAX package's, unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ElasticDecision:
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    dropped: int
    note: str


def plan_mesh(n_devices: int, *, model_parallel: int = 16,
              prefer_pods: bool = True) -> ElasticDecision:
    """Choose a (pod, data, model) factorisation for ``n_devices``.

    Keeps the model axis fixed (changing TP degree would change parameter
    sharding layout and kernel tuning); absorbs device loss into the data
    axis, dropping stragglers to the largest usable multiple.
    """
    if n_devices < model_parallel:
        # degraded mode: shrink model axis to the largest power-of-2 fit
        mp = 1 << (n_devices.bit_length() - 1)
        return ElasticDecision((1, mp), ("data", "model"),
                               n_devices - mp,
                               f"degraded: model axis {mp}")
    data = n_devices // model_parallel
    used = data * model_parallel
    dropped = n_devices - used
    if prefer_pods and data % 2 == 0 and data >= 32:
        return ElasticDecision((2, data // 2, model_parallel),
                               ("pod", "data", "model"), dropped,
                               "multi-pod layout")
    return ElasticDecision((data, model_parallel), ("data", "model"),
                           dropped, "single-pod layout")


def make_elastic_mesh(world_size: Optional[int] = None,
                      model_parallel: int = 16, device_type: str = "cuda"):
    """(a ``DeviceMesh`` over the first ``used`` ranks of the world,
    the decision).  ``world_size`` defaults to the default process
    group's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size() if world_size is None else int(world_size)
    decision = plan_mesh(n, model_parallel=model_parallel)
    used = 1
    for s in decision.mesh_shape:
        used *= s
    ranks = torch.arange(used).reshape(decision.mesh_shape)
    return DeviceMesh(device_type, ranks,
                      mesh_dim_names=decision.axis_names), decision


def validate_batch(global_batch: int, mesh) -> bool:
    """Global batch must divide the batch-sharding axes."""
    n = 1
    for ax, size in zip(mesh.mesh_dim_names, tuple(mesh.shape)):
        if ax in ("pod", "data"):
            n *= size
    return global_batch % n == 0

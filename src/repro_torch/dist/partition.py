"""Layout trees for every step boundary: params, optimizer, batch, decode
cache — and :func:`distribute`, which places a tree on them.

All trees are derived from the same source of truth the initialisers use —
the ``ParamDef`` trees and their logical axes — so a parameter can never be
initialised with one layout and stepped with another.  A leaf is a
:class:`Layout`: a ``DeviceMesh`` and one DTensor placement per mesh
dimension (the port's ``NamedSharding``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from .sharding import local_shape, merged_rules, placements, spec_for


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a tensor lives: its mesh and its placements (one per mesh
    dimension)."""

    mesh: Any
    placements: Tuple[Any, ...]


def layout_for(shape, axes, mesh, rules: Mapping[str, Any]) -> Layout:
    spec = spec_for(shape, axes, rules, mesh)
    return Layout(mesh, placements(spec, len(shape), mesh))


def _def_tree_layouts(defs: Any, mesh, rules: Mapping[str, Any]) -> Any:
    from ..models.params import _unflatten, tree_paths
    return _unflatten({path: layout_for(d.shape, d.axes, mesh, rules)
                       for path, d in tree_paths(defs).items()})


def model_shardings(cfg, mesh, rules: Optional[Mapping[str, Any]] = None
                    ) -> Any:
    """Layout tree mirroring ``model_defs(cfg)``."""
    from ..models.model import model_defs
    return _def_tree_layouts(model_defs(cfg), mesh, merged_rules(rules))


def cache_shardings(cfg, batch: int, max_len: int, mesh,
                    rules: Optional[Mapping[str, Any]] = None) -> Any:
    """Layout tree mirroring ``cache_defs`` (decode KV/SSM state)."""
    from ..models.model import cache_defs
    return _def_tree_layouts(cache_defs(cfg, batch, max_len), mesh,
                             merged_rules(rules))


def opt_shardings(param_shardings: Any, mesh):
    """Optimizer state layouts: moments mirror the parameters (fully
    sharded optimizer), the step counter is replicated."""
    from ..models.params import tree_map
    from ..optim.adamw import OptState
    rep = Layout(mesh, tuple(Replicate() for _ in mesh.mesh_dim_names))
    copy = lambda tree: tree_map(lambda s: s, tree)
    return OptState(m=copy(param_shardings), v=copy(param_shardings),
                    count=rep)


def batch_shardings(cfg, shape, mesh,
                    rules: Optional[Mapping[str, Any]] = None
                    ) -> Dict[str, Layout]:
    """Layouts for the input batch of one (model, shape) cell, keyed like
    ``repro_torch.configs.input_specs``: train/prefill get tokens-or-embeds
    (+ labels), decode gets the single-token ``inputs``."""
    if isinstance(shape, str):
        from ..models.config import SHAPES
        shape = SHAPES[shape]
    merged = merged_rules(rules)
    B, S = shape.global_batch, shape.seq_len
    mk = lambda shp, axes: layout_for(shp, axes, mesh, merged)

    if shape.kind == "decode":
        if cfg.input_mode == "embeddings":
            return {"inputs": mk((B, 1, cfg.d_model), ("batch", None, None))}
        return {"inputs": mk((B, 1), ("batch", None))}
    out: Dict[str, Layout] = {}
    if cfg.input_mode == "embeddings":
        out["embeds"] = mk((B, S, cfg.d_model), ("batch", "seq", None))
    else:
        out["tokens"] = mk((B, S), ("batch", "seq"))
    if shape.kind == "train":
        out["labels"] = mk((B, S), ("batch", "seq"))
    return out


def place(t: torch.Tensor, layout: Layout) -> DTensor:
    """One tensor on ``layout``: the port's ``device_put``.

    A ``meta`` tensor (a shape, no values) becomes a DTensor whose local
    shard is a ``meta`` tensor of the shard's shape: the dry-run's
    parameters.  A DTensor is redistributed; any other tensor is
    distributed from rank 0's values (every rank must pass the same
    global tensor, as the JAX package's global arrays are one value)."""
    mesh, places = layout.mesh, tuple(layout.placements)
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == places else \
            t.redistribute(mesh, places)
    if t.device.type == "meta":
        local = torch.empty(local_shape(t.shape, places, mesh),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, places, run_check=False,
                                  shape=t.shape, stride=t.stride())
    dev = mesh.device_type
    if t.device.type != dev:
        t = t.to(dev)
    return distribute_tensor(t, mesh, places)


def map_with(fn: Callable[[Any, Any], Any], tree: Any, layouts: Any) -> Any:
    """``fn(leaf, layout)`` over a tree of nested dicts and NamedTuples
    (``OptState``) and the layout tree of the same structure."""
    if isinstance(tree, Mapping):
        return {k: map_with(fn, tree[k], layouts[k]) for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_with(fn, a, b)
                            for a, b in zip(tree, layouts)))
    return fn(tree, layouts)


def distribute(tree: Any, shardings: Any) -> Any:
    """``tree`` placed leaf by leaf on the layout tree ``shardings``."""
    return map_with(place, tree, shardings)


def gather(tree: Any) -> Any:
    """Every DTensor of ``tree`` as its global tensor (``full_tensor()``);
    other leaves as they are."""
    def one(t):
        return t.full_tensor() if isinstance(t, DTensor) else t
    if isinstance(tree, Mapping):
        return {k: gather(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(gather(v) for v in tree))
    return one(tree)

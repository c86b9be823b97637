"""Parameter definitions: one tree, three views (init / shapes / axes).

Each model builds a tree of :class:`ParamDef` — the single source of truth
for parameter shapes, initialisers and *logical sharding axes*.  From it we
derive:

  * ``init_params``     — concrete tensors, drawn from a ``torch.Generator``
                          on the target device,
  * ``abstract_params`` — tensors on the ``meta`` device (shapes and dtypes,
                          no storage),
  * ``param_axes``      — the logical axes (``repro_torch.dist``).

The JAX package draws each leaf from ``fold_in(key, i)``, a stream torch
cannot reproduce; :func:`params_from_numpy` carries a JAX parameter tree
over instead, path for path, so both packages can run the same weights.

Logical axis vocabulary (as the JAX package's ``repro.dist.sharding``):
  layers, embed, vocab, heads, kv_heads, head_dim, mlp, experts, expert_mlp,
  q_lora, kv_lora, ssm_inner, ssm_state, ssm_heads, conv_dim, none
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axes, len == ndim
    init: str = "fan_in"                      # fan_in | normal | zeros | ones
    scale: float = 1.0
    dtype: Optional[str] = None               # override model param dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"axes {self.axes} do not match shape {self.shape}")


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a dtype name (``"bfloat16"`` -> torch.bfloat16)."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def resolve_device(device: "torch.device | str | None") -> torch.device:
    """``device``, or the card when None.  Asking for a CUDA device on a
    host without one raises: an entry point never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is available for {dev}; pass device='cpu' "
            f"to run on the CPU")
    return dev


def _fan_in(defn: "ParamDef") -> int:
    # all dims except the last are inputs for projection matrices; stacked
    # layer dims (axis == "layers") do not contribute to fan-in
    dims = [d for d, a in zip(defn.shape[:-1], defn.axes[:-1])
            if a != "layers"]
    if not dims:
        return max(1, defn.shape[0] if defn.shape else 1)
    return int(np.prod(dims))


def stack_defs(tree: Any, n: int) -> Any:
    """Prepend a stacked 'layers' dimension to every ParamDef in a tree."""
    if _is_def(tree):
        return dataclasses.replace(tree, shape=(n,) + tree.shape,
                                   axes=("layers",) + tree.axes)
    return {k: stack_defs(v, n) for k, v in tree.items()}


def init_one(defn: ParamDef, generator: Optional[torch.Generator],
             dtype: str, device: torch.device) -> torch.Tensor:
    dt = torch_dtype(defn.dtype or dtype)
    if defn.init == "zeros":
        return torch.zeros(defn.shape, dtype=dt, device=device)
    if defn.init == "ones":
        return torch.ones(defn.shape, dtype=dt, device=device)
    if defn.init in ("normal", "fan_in"):
        std = (defn.scale if defn.init == "normal"
               else defn.scale / np.sqrt(_fan_in(defn)))
        z = torch.randn(defn.shape, generator=generator,
                        dtype=torch.float32, device=device)
        return (z.mul_(float(std))).to(dt)
    raise ValueError(f"unknown init {defn.init!r}")


def _is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_paths(defs: Any, prefix: str = "") -> Dict[str, ParamDef]:
    """Flatten a ParamDef tree into {'a/b/c': def} (stable order)."""
    out: Dict[str, ParamDef] = {}
    if _is_def(defs):
        out[prefix or "param"] = defs
        return out
    if isinstance(defs, dict):
        for k in sorted(defs):
            out.update(tree_paths(defs[k], f"{prefix}/{k}" if prefix else k))
        return out
    raise TypeError(f"unexpected node {type(defs)} at {prefix!r}")


def make_generator(generator: Union[torch.Generator, int, None],
                   device: torch.device) -> torch.Generator:
    """``generator`` itself, or a new one on ``device`` seeded with it."""
    if isinstance(generator, torch.Generator):
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(int(generator or 0))
    return g


def init_params(defs: Any, generator: Union[torch.Generator, int, None],
                dtype: str, device: "torch.device | str | None" = None) -> Any:
    """Materialise the full parameter tree on ``device`` (default: the
    card), drawing the leaves in :func:`tree_paths` order from one
    generator (or a generator on ``device`` seeded with an int)."""
    dev = resolve_device(device)
    g = make_generator(generator, dev)
    flat = {path: init_one(d, g, dtype, dev)
            for path, d in tree_paths(defs).items()}
    return _unflatten(flat)


def abstract_params(defs: Any, dtype: str) -> Any:
    """Tensors on the ``meta`` device — shapes and dtypes, no storage."""
    flat = tree_paths(defs)
    out = {p: torch.empty(d.shape, dtype=torch_dtype(d.dtype or dtype),
                          device="meta")
           for p, d in flat.items()}
    return _unflatten(out)


def param_axes(defs: Any) -> Any:
    """Tree of logical-axis tuples, mirroring the param tree."""
    flat = tree_paths(defs)
    return _unflatten({p: d.axes for p, d in flat.items()})


def count_params(defs: Any) -> int:
    return sum(int(np.prod(d.shape)) for d in tree_paths(defs).values())


def param_bytes(defs: Any, dtype: str) -> int:
    flat = tree_paths(defs)
    return sum(int(np.prod(d.shape)) * torch_dtype(d.dtype or dtype).itemsize
               for d in flat.values())


def tree_leaves(tree: Any) -> list:
    """The tensors of a nested-dict tree in ``jax.tree_util``'s order
    (dict keys sorted), so sums over leaves add in the JAX package's
    order."""
    if isinstance(tree, Mapping):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested-dict trees of one structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A tensor that owns a copy of ``a``."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch twin numpy knows of: reinterpret
        # its bits, which is exact, instead of converting its values
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(a)


def _flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten_tree(v, path))
        else:
            out[path] = v
    return out


def params_from_numpy(tree: Mapping[str, Any],
                      device: "torch.device | str | None" = None,
                      shardings: Any = None) -> Any:
    """The port's parameter tree from numpy arrays, path for path.

    ``tree`` is a nested dict of arrays (the JAX package's parameter tree
    after ``np.asarray`` on each leaf) or a flat ``{'a/b/c': array}`` map.
    bfloat16 arrays (numpy dtype name ``bfloat16``) are carried over bit
    for bit.  Returns the nested tree on ``device`` (default: the card),
    or, with ``shardings`` (a layout tree of the same structure,
    :mod:`repro_torch.dist.partition`), as DTensors on those layouts.
    """
    dev = resolve_device(device)
    flat = {p: _from_numpy(a).to(dev)
            for p, a in _flatten_tree(tree).items()}
    out = _unflatten(flat)
    if shardings is not None:
        from ..dist.partition import distribute
        out = distribute(out, shardings)
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root

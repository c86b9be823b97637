"""Model zoo: the unified decoder covering all ten architectures.

The same exports as the JAX package's ``repro.models``;
``params_from_numpy`` carries a JAX parameter tree over, and
``tree_leaves``/``tree_map`` walk a tree in ``jax.tree_util``'s order.
"""

from .config import SHAPES, ModelConfig, ShapeConfig
from .model import (DEFAULT_RUN, RunConfig, abstract_cache, abstract_model,
                    cache_defs, cross_entropy, decode_step, forward,
                    init_cache, init_model, loss_fn, model_defs)
from .params import (ParamDef, abstract_params, count_params, init_params,
                     param_axes, param_bytes, params_from_numpy, stack_defs,
                     tree_leaves, tree_map, tree_paths)

__all__ = [
    "SHAPES", "ModelConfig", "ShapeConfig",
    "DEFAULT_RUN", "RunConfig", "abstract_cache", "abstract_model",
    "cache_defs", "cross_entropy", "decode_step", "forward", "init_cache",
    "init_model", "loss_fn", "model_defs",
    "ParamDef", "abstract_params", "count_params", "init_params",
    "param_axes", "param_bytes", "params_from_numpy", "stack_defs",
    "tree_leaves", "tree_map", "tree_paths",
]

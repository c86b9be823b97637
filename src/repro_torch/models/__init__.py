"""Model zoo: the unified decoder covering all ten architectures.

The same exports as the JAX package's ``repro.models``, less the loss
(``cross_entropy``, ``loss_fn``), which comes with training
(ROADMAP.md, Queue 1).  ``params_from_numpy`` carries a JAX parameter
tree over.
"""

from .config import SHAPES, ModelConfig, ShapeConfig
from .model import (DEFAULT_RUN, RunConfig, abstract_cache, abstract_model,
                    cache_defs, decode_step, forward, init_cache, init_model,
                    model_defs)
from .params import (ParamDef, abstract_params, count_params, init_params,
                     param_axes, param_bytes, params_from_numpy, stack_defs,
                     tree_paths)

__all__ = [
    "SHAPES", "ModelConfig", "ShapeConfig",
    "DEFAULT_RUN", "RunConfig", "abstract_cache", "abstract_model",
    "cache_defs", "decode_step", "forward", "init_cache", "init_model",
    "model_defs",
    "ParamDef", "abstract_params", "count_params", "init_params",
    "param_axes", "param_bytes", "params_from_numpy", "stack_defs",
    "tree_paths",
]

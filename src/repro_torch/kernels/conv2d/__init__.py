from .conv2d import (DEFAULT_CONFIG, Conv2d, LAUNCHES, analytical_time,
                     block_threads, conv2d_plain, make_conv2d, micro_tile,
                     smem_footprint, validate_config)
from .ops import (CONV2D, conv2d, heuristic_config, lookup_config,
                  make_tuner, shape_key, tune_conv2d, tuning_space)
from .ref import conv2d_reference, conv_bytes, conv_flops

__all__ = [
    "CONV2D", "Conv2d", "DEFAULT_CONFIG", "LAUNCHES", "analytical_time",
    "block_threads", "conv2d_plain", "make_conv2d", "micro_tile",
    "smem_footprint", "validate_config", "conv2d", "heuristic_config", "lookup_config",
    "make_tuner", "shape_key", "tune_conv2d", "tuning_space",
    "conv2d_reference", "conv_bytes", "conv_flops",
]

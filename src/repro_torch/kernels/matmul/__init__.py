from .matmul import (DEFAULT_CONFIG, LAUNCHES, analytical_time, block_threads,
                     gemm_plain, make_matmul, micro_tile, smem_footprint,
                     validate_config, warp_tile)
from .ops import (GEMM, heuristic_config, lookup_config, make_tuner, matmul,
                  shape_key, tune_matmul, tuning_space)
from .ref import gemm_reference

__all__ = [
    "DEFAULT_CONFIG", "GEMM", "LAUNCHES", "analytical_time", "block_threads",
    "gemm_plain", "make_matmul", "micro_tile", "smem_footprint",
    "validate_config", "warp_tile",
    "heuristic_config", "lookup_config", "make_tuner", "matmul", "shape_key",
    "tune_matmul", "tuning_space", "gemm_reference",
]

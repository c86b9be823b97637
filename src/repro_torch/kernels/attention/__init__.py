from .flash import (DEFAULT_CONFIG, LAUNCHES, FlashAttention,
                    analytical_time, block_threads, flash_plain, geometry,
                    kv_end, kv_steps, make_flash_attention,
                    register_estimate, smem_footprint, validate_config)
from .ops import (FLASH_ATTENTION, flash_attention, heuristic_config,
                  lookup_config, make_tuner, shape_key,
                  tune_flash_attention, tuning_space)
from .ref import attention_flops, attention_reference

__all__ = [
    "DEFAULT_CONFIG", "FLASH_ATTENTION", "FlashAttention", "LAUNCHES",
    "analytical_time", "block_threads", "flash_plain", "geometry", "kv_end",
    "kv_steps", "make_flash_attention", "register_estimate",
    "smem_footprint", "validate_config",
    "flash_attention", "heuristic_config", "lookup_config", "make_tuner",
    "shape_key", "tune_flash_attention", "tuning_space", "attention_flops",
    "attention_reference",
]

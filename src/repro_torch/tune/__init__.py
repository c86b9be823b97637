"""Tuning integration: the generic one-shot API, batch sessions and the
distributed tuner, and the distributed-config (sharding) tuner.

The generic entry points (``tune_kernel``/``TuningSession``/
``tune_kernel_distributed``) live here; per-kernel conveniences
(``tune_matmul`` etc.) are lazy re-exports, as in the JAX package — thin
delegates to ``tune_kernel``.  ``tune_cell`` searches one cell's
(sharding rules x execution knobs) against the fake-world dry-run's
roofline (``sharding_autotune``).
"""

from .api import (TuningSession, tune_kernel, tune_kernel_distributed,
                  warm_start_seeds)
from .sharding_autotune import (CellObjective, build_space,
                                config_to_run_rules, tune_cell)

__all__ = ["TuningSession", "tune_kernel", "tune_kernel_distributed",
           "warm_start_seeds",
           "CellObjective", "build_space", "config_to_run_rules",
           "tune_cell",
           "tune_flash_attention", "tune_conv2d", "tune_matmul"]

_LEGACY = {
    "tune_matmul": ("repro_torch.kernels.matmul.ops", "tune_matmul"),
    "tune_conv2d": ("repro_torch.kernels.conv2d.ops", "tune_conv2d"),
    "tune_flash_attention": ("repro_torch.kernels.attention.ops",
                             "tune_flash_attention"),
}


def __getattr__(name):
    # lazy: kernels import repro_torch.tune.api, so importing them eagerly
    # here would be circular.
    if name in _LEGACY:
        import importlib
        module, attr = _LEGACY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Distribution layer: the step functions the trainer and the serving
engine run.

``step`` — ``make_train_step`` / ``make_prefill_step`` /
``make_serve_step`` and ``apply_kernel_configs``.  The JAX package's
logical-axis sharding (``sharding``, ``partition``) comes with the
DTensor slice (ROADMAP.md, Queue 1); outside a mesh the JAX model's
sharding annotations are no-ops, so the port has none.
"""

from .step import (apply_kernel_configs, make_prefill_step, make_serve_step,
                   make_train_step)

__all__ = ["apply_kernel_configs", "make_prefill_step", "make_serve_step",
           "make_train_step"]

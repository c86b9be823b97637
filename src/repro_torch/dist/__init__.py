"""Distribution layer: the step functions the serving engine runs.

``step`` — ``make_prefill_step`` / ``make_serve_step`` and
``apply_kernel_configs``.  The JAX package's logical-axis sharding
(``sharding``, ``partition``) and ``make_train_step`` come with the
distribution and training slices (ROADMAP.md, Queue 1); outside a mesh the
JAX model's sharding annotations are no-ops, so the port has none.
"""

from .step import apply_kernel_configs, make_prefill_step, make_serve_step

__all__ = ["apply_kernel_configs", "make_prefill_step", "make_serve_step"]

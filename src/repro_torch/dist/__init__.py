"""Distribution layer: logical-axis sharding rules, layout trees, and the
train/prefill/serve step functions.

``sharding``  — logical axis -> mesh axis rules, ``shard`` annotations and
                ``spec_for`` (divisibility + mesh-axis dedup), on DTensor.
``partition`` — layout trees for params / optimizer / batch / cache, and
                ``distribute`` to place a tree on them.
``step``      — ``make_train_step`` / ``make_prefill_step`` /
                ``make_serve_step`` factories shared by training, serving
                and the dry-run.

``partition``/``step`` sit *above* the model layer (they import it), while
``sharding`` sits below (the model imports ``shard``), so only ``sharding``
is imported eagerly here; the rest resolves lazily to keep
``import repro_torch.models`` acyclic.
"""

from .sharding import DEFAULT_RULES, shard, spec_for, use_sharding

__all__ = ["partition", "sharding", "step",
           "DEFAULT_RULES", "shard", "spec_for", "use_sharding",
           "apply_kernel_configs", "make_prefill_step", "make_serve_step",
           "make_train_step"]

_LAZY = {
    "partition": ("repro_torch.dist.partition", None),
    "step": ("repro_torch.dist.step", None),
    "apply_kernel_configs": ("repro_torch.dist.step", "apply_kernel_configs"),
    "make_prefill_step": ("repro_torch.dist.step", "make_prefill_step"),
    "make_serve_step": ("repro_torch.dist.step", "make_serve_step"),
    "make_train_step": ("repro_torch.dist.step", "make_train_step"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        mod = importlib.import_module(module)
        return getattr(mod, attr) if attr else mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Declared kernel cost: the FLOPs and bytes one configuration moves.

The twin of the JAX package's ``repro/core/hlo.py``.  There, the cost
model reads FLOPs and bytes from XLA's ``cost_analysis()`` of the lowered
module and parses the HLO text for collective traffic.  A CUDA kernel
built with ``nvcc`` has no such module to read, so each kernel declares
its cost instead: a function ``(shape, config) -> KernelCost`` beside its
build (``traffic`` in ``kernels/*/``), wired into the declaration as
``TunableKernel.cost``.  The count is per configuration, as XLA prices
each lowered configuration separately: the block geometry decides how
often each operand is read from device memory.

What waits: ``collective_stats`` and ``canonicalize_hlo``/``fingerprint``
have nothing to parse on one card; they come back with the port of the
distributed layer.  A CUDA build already has its content address,
``cuda:<digest>`` (:mod:`repro_torch.kernels.build`), and evaluators with
no build of their own use
:func:`~repro_torch.core.artifacts.spec_fingerprint`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping

Config = Mapping[str, Any]


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """What one launch of a configuration does: floating-point operations,
    bytes moved to and from device memory, and bytes sent between devices
    (0 on one card)."""

    flops: float
    bytes: float
    collective_bytes: float = 0.0

    def __post_init__(self) -> None:
        for name in ("flops", "bytes", "collective_bytes"):
            value = float(getattr(self, name))
            if not math.isfinite(value) or value < 0:
                raise ValueError(f"KernelCost.{name} must be finite and "
                                 f">= 0, got {value!r}")
            object.__setattr__(self, name, value)

    def to_json(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def declared_cost(cost: Callable[[Config], KernelCost],
                  config: Config) -> KernelCost:
    """Evaluate a kernel's declared cost for ``config``.

    ``cost`` is the shape-bound declaration (``KernelSpec.cost``).  It
    raises ``ValueError`` for a configuration its kernel cannot build, as
    a lowering fails in the JAX package; anything it returns must be a
    :class:`KernelCost`."""
    out = cost(dict(config))
    if not isinstance(out, KernelCost):
        raise TypeError(f"a declared cost must return a KernelCost, got "
                        f"{type(out).__name__}")
    return out

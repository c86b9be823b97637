"""repro_torch.analyze — static search-space & declaration analysis.

The twin of the JAX package's ``repro.analyze``, with the device rules
re-derived for CUDA: shared memory and threads per block are proven,
registers and alignment only advised.

CLTune §III-A auto-imposes device limits as search-space constraints;
this package is that idea grown into a static-analysis pass over the
whole `@tunable` layer:

* :mod:`~repro_torch.analyze.space_audit` — satisfiability, dead values,
  constraint health (exact below a cardinality bound, stratified above
  it, with an explicit ``exact|probabilistic`` confidence verdict);
* :mod:`~repro_torch.analyze.resource` — the declared
  ``smem_footprint`` and ``block_threads`` models evaluated against the
  ``DeviceProfile`` limits: **proven** infeasibility the engine answers
  without building (``EngineStats.proven_pruned``) and the lookup chain
  refuses to transfer;
* :mod:`~repro_torch.analyze.lint` — registry-wide declaration rules,
  each a typed :class:`Finding` with a stable ``rule_id``;
* ``python -m repro_torch.analyze`` — the CLI/CI entry point.

Env knobs (see :mod:`repro_torch.core.envknobs` conventions):

* ``REPRO_ANALYZE`` — default for ``Tuner.tune(analyze=...)`` /
  ``tune_kernel(analyze=...)`` when the caller passes nothing
  (default off; non-boolean values raise).
* ``REPRO_ANALYZE_STRICT`` — when analysis runs pre-search, raise on
  error-severity findings instead of tuning anyway (default off).
"""

from __future__ import annotations

from ..core.envknobs import env_bool
from .findings import SEVERITIES, AnalysisReport, Finding
from .lint import (analyze_registry, constraint_arity_error,
                   default_profiles, kernel_findings, render_text)
from .resource import (alignment_findings, device_constraints,
                       dtype_bytes, footprint_bytes,
                       install_device_constraints, limit_violations,
                       proven_checker, proven_violations, register_findings,
                       resource_findings, threads_per_block)
from .space_audit import (DEFAULT_EXACT_LIMIT, DEFAULT_SAMPLES, SpaceReport,
                          audit_space, space_findings)


def analyze_default() -> bool:
    """Session default for ``analyze=`` knobs (``REPRO_ANALYZE``)."""
    return env_bool("REPRO_ANALYZE", False)


def strict_default() -> bool:
    """Whether pre-search analysis raises on errors
    (``REPRO_ANALYZE_STRICT``)."""
    return env_bool("REPRO_ANALYZE_STRICT", False)


__all__ = [
    "AnalysisReport", "Finding", "SEVERITIES", "SpaceReport",
    "alignment_findings", "analyze_default", "analyze_registry",
    "audit_space", "constraint_arity_error", "default_profiles",
    "device_constraints", "dtype_bytes", "footprint_bytes",
    "install_device_constraints", "kernel_findings", "limit_violations",
    "proven_checker", "proven_violations", "register_findings",
    "render_text", "resource_findings", "space_findings",
    "strict_default", "threads_per_block", "DEFAULT_EXACT_LIMIT",
    "DEFAULT_SAMPLES",
]

"""Declaration linter: registry-wide static checks over `@tunable` kernels.

Each rule produces typed :class:`~repro_torch.analyze.findings.Finding` rows;
:func:`analyze_registry` sweeps every registered tunable at its declared
default shapes across the built-in device profiles and, when a card is
present, the card's runtime profile (:func:`device_profile`, which takes
the place of the built-in profile of the same name).  Shape-free kernels
(no ``default_shapes``) still get the declaration-level rules;
space/resource rules need a concrete shape.

Rule inventory:

==========================  ========  =====================================
rule_id                     severity  meaning
==========================  ========  =====================================
space-unsatisfiable         error*    constraint set admits no config
space-unknown-param         error     constraint references undeclared name
space-constraint-raises     error     constraint predicate raises
space-dead-value            warning*  value appears in no feasible config
space-vacuous-constraint    info      constraint rejects nothing
space-implied-constraint    info      constraint implied by the others
space-build-error           error     space()/make_space raised
space-over-smem             error*    every feasible config over a block limit
footprint-model-raises      error     smem/threads model raises on feasible
device-feasibility          info      proven-infeasible fraction per device
align-warp/align-vector     info      heuristic not whole warps / 16 B rows
register-estimate           info      heuristic over the register budget
heuristic-raises            error     heuristic(shape) raises
heuristic-out-of-space      warning   heuristic names/values outside space
heuristic-infeasible        warning   heuristic violates constraints
heuristic-over-smem         warning   heuristic config over a device limit
extended-not-superset       error     extended space loses default values
constraint-arity            error     constraint fn arity != len(names)
bool-int-aliasing           warning   param mixes bool and equal int values
missing-analytical-model    warning   no model but cost-model paths declared
no-default-shapes           info      kernel skipped space/resource rules
==========================  ========  =====================================

(* probabilistic confidence demotes the severity one step.)
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import torch

from ..core.profiles import PROFILES, DeviceProfile, device_profile
from ..core.registry import REGISTRY, KernelRegistry, TunableKernel
from ..core.space import (Constraint, SearchSpace, _value_ident,
                          constraint_arity_error)
from .findings import AnalysisReport, Finding
from .resource import (alignment_findings, proven_violations,
                       register_findings, resource_findings)
from .space_audit import (DEFAULT_EXACT_LIMIT, DEFAULT_SAMPLES, audit_space,
                          space_findings)

Shape = Mapping[str, Any]


# constraint-arity checking: SearchSpace.add_constraint raises on new
# declarations; this rule catches pre-built / hand-assembled spaces
def _arity_findings(space: SearchSpace, kernel: str,
                    shape: Optional[Shape], space_name: str) -> List[Finding]:
    out = []
    for i, c in enumerate(space.constraints):
        label = c.label or f"constraint over {list(c.names)}"
        err = constraint_arity_error(c.fn, len(c.names))
        if err:
            out.append(Finding(
                rule_id="constraint-arity", severity="error", kernel=kernel,
                shape=dict(shape) if shape else None,
                detail=f"[{space_name} space] #{i}:{label}: {err}",
                data={"constraint": label, "space": space_name}))
    return out


def _alias_findings(space: SearchSpace, kernel: str,
                    shape: Optional[Shape], space_name: str) -> List[Finding]:
    """Params mixing bools with the ints they compare equal to.

    ``(0, 1, True)`` is legal (the space machinery is bool-aware) but
    almost always a declaration typo: caches, JSON round-trips
    and user code conflate the aliased pair.
    """
    out = []
    for p in space.parameters:
        bools = {v for v in p.values if isinstance(v, bool)}
        if not bools:
            continue
        aliased = [v for v in p.values
                   if not isinstance(v, bool)
                   and any(v == b for b in bools)]
        if aliased:
            out.append(Finding(
                rule_id="bool-int-aliasing", severity="warning",
                kernel=kernel, shape=dict(shape) if shape else None,
                detail=f"[{space_name} space] parameter {p.name!r} mixes "
                       f"bool values {sorted(bools)} with equal int "
                       f"value(s) {aliased}; JSON/cache round-trips "
                       f"conflate them",
                data={"param": p.name, "space": space_name}))
    return out


def _heuristic_findings(k: TunableKernel, shape: Shape,
                        space: SearchSpace,
                        profiles: Sequence[DeviceProfile]) -> List[Finding]:
    out: List[Finding] = []
    try:
        h = dict(k.heuristic(dict(shape)))
    except Exception as e:
        return [Finding(
            rule_id="heuristic-raises", severity="error", kernel=k.name,
            shape=dict(shape),
            detail=f"heuristic raised {type(e).__name__}: {e}")]

    by_name = {p.name: p for p in space.parameters}
    extra = sorted(set(h) - set(by_name))
    off_value = {}
    for name, value in h.items():
        p = by_name.get(name)
        if p is None:
            continue
        try:
            p.index_of(value)
        except ValueError:
            off_value[name] = value
    if extra or off_value:
        out.append(Finding(
            rule_id="heuristic-out-of-space", severity="warning",
            kernel=k.name, shape=dict(shape),
            detail=f"heuristic strays from the default space: "
                   f"extra names {extra or '[]'}, out-of-list values "
                   f"{off_value or '{}'} (runtime projects these, but the "
                   f"declared intent is lost)",
            data={"extra": extra, "off_value": off_value}))

    def _violates(c: Constraint, config: Dict[str, object]) -> bool:
        # a raising constraint is the audit's space-constraint-raises
        # finding, not a heuristic-infeasibility verdict
        try:
            return not c.check(config)
        except Exception:
            return False

    known = {n: v for n, v in h.items() if n in by_name}
    if not off_value and set(known) == set(by_name):
        labels = [c.label or repr(c.names) for c in space.constraints
                  if set(c.names) <= set(known) and _violates(c, known)]
        if labels:
            out.append(Finding(
                rule_id="heuristic-infeasible", severity="warning",
                kernel=k.name, shape=dict(shape),
                detail=f"heuristic violates constraint(s) {labels} "
                       f"(runtime projects it to a feasible neighbour)",
                data={"violated": labels}))
        else:
            # feasible heuristic: device-budget + alignment advisories
            for prof in profiles:
                viol = proven_violations(k, shape, h, prof)
                if viol:
                    out.append(Finding(
                        rule_id="heuristic-over-smem", severity="warning",
                        kernel=k.name, shape=dict(shape), profile=prof.name,
                        detail=f"heuristic config is proven infeasible on "
                               f"{prof.name}: {'; '.join(viol)}",
                        data={"violations": viol}))
            if profiles:
                out.extend(alignment_findings(k, shape, h, profiles[0],
                                              context="heuristic"))
                out.extend(register_findings(k, shape, h, profiles[0],
                                             context="heuristic"))
    return out


def _extended_superset_findings(k: TunableKernel, shape: Shape,
                                default_space: SearchSpace) -> List[Finding]:
    if not k.supports_extended():
        return []
    try:
        ext = k.make_space(dict(shape), extended=True)
    except Exception as e:
        return [Finding(
            rule_id="space-build-error", severity="error", kernel=k.name,
            shape=dict(shape),
            detail=f"extended space build raised {type(e).__name__}: {e}",
            data={"space": "extended"})]
    ext_by_name = {p.name: p for p in ext.parameters}
    out = []
    for p in default_space.parameters:
        q = ext_by_name.get(p.name)
        if q is None:
            out.append(Finding(
                rule_id="extended-not-superset", severity="error",
                kernel=k.name, shape=dict(shape),
                detail=f"extended space drops parameter {p.name!r} — tuned "
                       f"extended configs cannot serve default-space calls",
                data={"param": p.name}))
            continue
        ext_idents = {_value_ident(v) for v in q.values}
        lost = [v for v in p.values if _value_ident(v) not in ext_idents]
        if lost:
            out.append(Finding(
                rule_id="extended-not-superset", severity="error",
                kernel=k.name, shape=dict(shape),
                detail=f"extended space loses default value(s) {lost} of "
                       f"parameter {p.name!r}",
                data={"param": p.name, "lost": lost}))
    return out


def _declaration_findings(k: TunableKernel) -> List[Finding]:
    out: List[Finding] = []
    if k.analytical_model is None:
        defaults = {str(v).lower() for v in k.defaults.values()}
        needs = bool({"costmodel", "analytical"} & defaults)
        out.append(Finding(
            rule_id="missing-analytical-model",
            severity="error" if needs else "warning",
            kernel=k.name,
            detail="no analytical_model declared"
                   + (": the kernel's own defaults request a cost-model "
                      "path that cannot be built" if needs else
                      "; CostModelPredictor / analytical evaluation are "
                      "unavailable for this kernel"),
            data={"required_by_defaults": needs}))
    return out


def default_profiles() -> List[DeviceProfile]:
    """The built-in profiles, with the card's runtime profile in place of
    the built-in one of its name (added when no built-in has it) when a
    card is present."""
    profiles = dict(PROFILES)
    if torch.cuda.is_available():
        runtime = device_profile()
        profiles[runtime.name] = runtime
    return list(profiles.values())


def kernel_findings(k: TunableKernel, *,
                    shapes: Optional[Iterable[Shape]] = None,
                    profiles: Optional[Sequence[DeviceProfile]] = None,
                    exact_limit: int = DEFAULT_EXACT_LIMIT,
                    samples: int = DEFAULT_SAMPLES,
                    seed: int = 0) -> List[Finding]:
    """All findings for one tunable kernel."""
    shape_list = [dict(s) for s in (shapes if shapes is not None
                                    else k.default_shapes)]
    prof_list = list(profiles if profiles is not None
                     else default_profiles())
    findings: List[Finding] = list(_declaration_findings(k))

    if not shape_list:
        findings.append(Finding(
            rule_id="no-default-shapes", severity="info", kernel=k.name,
            detail="kernel declares no default_shapes; space and resource "
                   "rules skipped (pass explicit shapes to audit them)"))
        return findings

    for shape in shape_list:
        try:
            space = k.make_space(dict(shape))
        except Exception as e:
            findings.append(Finding(
                rule_id="space-build-error", severity="error", kernel=k.name,
                shape=dict(shape),
                detail=f"space build raised {type(e).__name__}: {e}",
                data={"space": "default"}))
            continue

        report = audit_space(space, exact_limit=exact_limit,
                             samples=samples, seed=seed)
        findings.extend(space_findings(report, kernel=k.name, shape=shape))
        findings.extend(_arity_findings(space, k.name, shape, "default"))
        findings.extend(_alias_findings(space, k.name, shape, "default"))
        findings.extend(_heuristic_findings(k, shape, space, prof_list))
        findings.extend(_extended_superset_findings(k, shape, space))
        if not report.unsatisfiable:
            for prof in prof_list:
                findings.extend(resource_findings(
                    k, shape, prof, report.feasible_sample,
                    report.confidence))
    return findings


def analyze_registry(registry: Optional[KernelRegistry] = None, *,
                     kernels: Optional[Sequence[str]] = None,
                     profiles: Optional[Sequence[DeviceProfile]] = None,
                     exact_limit: int = DEFAULT_EXACT_LIMIT,
                     samples: int = DEFAULT_SAMPLES,
                     seed: int = 0) -> AnalysisReport:
    """Sweep every registered tunable (or the named subset)."""
    if registry is None:
        from ..core.registry import _ensure_builtins
        _ensure_builtins()                      # load the built-in tunables
        registry = REGISTRY
    names = list(kernels) if kernels else sorted(registry.names())
    report = AnalysisReport()
    for name in names:
        report.extend(kernel_findings(registry.get(name),
                                      profiles=profiles,
                                      exact_limit=exact_limit,
                                      samples=samples, seed=seed))
    return report


# re-exported convenience: grouped human rendering for the CLI
def render_text(report: AnalysisReport) -> str:
    by_kernel: Dict[str, List[Finding]] = {}
    for f in report:
        by_kernel.setdefault(f.kernel or "<unattributed>", []).append(f)
    lines: List[str] = []
    for kernel in sorted(by_kernel):
        lines.append(f"{kernel}:")
        lines.extend(f"  {f}" for f in by_kernel[kernel])
    lines.append(report.summary())
    return "\n".join(lines)

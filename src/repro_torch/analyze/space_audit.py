"""Static search-space audit: satisfiability, dead values, constraint health.

CLTune's spaces are small cartesian products filtered by lambda
constraints; most declaration bugs are therefore *statically decidable*
by bounded enumeration: a constraint set with an empty feasible set, a
parameter value that no feasible config ever takes (dead weight the
strategies keep resampling), a constraint referencing a parameter that
was never declared, or a constraint that rejects nothing the others
don't already reject.

Paper-scale extended spaces (GEMM: ~250k raw points) are too large to
enumerate in a pre-search pass, so the audit falls back to *stratified*
sampling — every (parameter, value) pair is guaranteed to appear in the
sample, so a value reported dead was really rejected in combination
with a balanced mix of the other parameters — and the report carries an
explicit ``confidence`` verdict: ``exact`` (enumerated, claims are
proofs) or ``probabilistic`` (sampled, claims are evidence).
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..core.space import Config, Constraint, SearchSpace, _value_ident
from .findings import Finding

#: Spaces at or below this raw cardinality are enumerated exactly.
DEFAULT_EXACT_LIMIT = 20_000
#: Stratified sample size for spaces above the exact limit.
DEFAULT_SAMPLES = 2_048


@dataclasses.dataclass
class SpaceReport:
    """Outcome of one :func:`audit_space` pass over a `SearchSpace`."""

    #: raw cartesian-product size (unconstrained)
    cardinality: int
    #: configs actually evaluated against the constraints
    examined: int
    #: feasible configs among the examined ones
    feasible: int
    #: feasible fraction of the examined set
    feasible_fraction: float
    #: ``exact`` (bounded enumeration) or ``probabilistic`` (stratified)
    confidence: str
    #: param name -> values appearing in no examined feasible config
    dead_values: Dict[str, List[Any]]
    #: labels of constraints that rejected no config at all (exact only)
    vacuous_constraints: List[str]
    #: labels of constraints whose every rejection was co-rejected by
    #: another constraint — implied/redundant (exact only)
    implied_constraints: List[str]
    #: constraint label -> parameter names it references that the space
    #: does not declare
    unknown_params: Dict[str, List[str]]
    #: constraint label -> count of configs whose check raised
    constraint_errors: Dict[str, int]
    #: no examined config satisfied every constraint
    unsatisfiable: bool
    #: a bounded sample of feasible configs (for downstream resource checks)
    feasible_sample: List[Config]

    def stats(self) -> Dict[str, Any]:
        """Compact mapping for tuner reports / bench records."""
        return {
            "cardinality": self.cardinality,
            "examined": self.examined,
            "feasible": self.feasible,
            "feasible_fraction": round(self.feasible_fraction, 4),
            "confidence": self.confidence,
            "dead_values": sum(len(v) for v in self.dead_values.values()),
            "vacuous_constraints": len(self.vacuous_constraints),
            "implied_constraints": len(self.implied_constraints),
        }


def _constraint_label(c: Constraint, index: int) -> str:
    base = c.label or f"constraint over {list(c.names)}"
    return f"#{index}:{base}"


def _check_safe(c: Constraint, cfg: Mapping[str, object]) -> Optional[bool]:
    """Evaluate a constraint; ``None`` means the predicate itself raised."""
    try:
        return bool(c.check(cfg))
    except Exception:
        return None


def _stratified_sample(space: SearchSpace, samples: int,
                       rng: random.Random) -> List[Config]:
    """Balanced sample: each (param, value) appears ~samples/len(values)
    times; per-parameter columns are shuffled independently, then zipped.

    This is the latin-hypercube idea on discrete axes: unlike i.i.d.
    uniform draws it cannot miss a value entirely, which is what makes a
    sampled dead-value claim meaningful.
    """
    columns: List[List[object]] = []
    for p in space.parameters:
        reps = math.ceil(samples / len(p.values))
        col = list(p.values) * reps
        rng.shuffle(col)
        columns.append(col[:samples])
    names = space.names
    return [dict(zip(names, row)) for row in zip(*columns)]


def audit_space(space: SearchSpace, *,
                exact_limit: int = DEFAULT_EXACT_LIMIT,
                samples: int = DEFAULT_SAMPLES,
                sample_cap: int = 512,
                seed: int = 0) -> SpaceReport:
    """Audit a space: exact below ``exact_limit``, stratified above it."""
    params = space.parameters
    constraints = space.constraints
    declared = set(space.names)

    labels = [_constraint_label(c, i) for i, c in enumerate(constraints)]
    unknown: Dict[str, List[str]] = {}
    evaluable: List[Tuple[int, Constraint]] = []
    for i, c in enumerate(constraints):
        missing = [n for n in c.names if n not in declared]
        if missing:
            unknown[labels[i]] = missing
        else:
            evaluable.append((i, c))

    cardinality = space.cardinality()
    exact = cardinality <= max(1, exact_limit)
    if exact:
        candidates = _enumerate_product(space)
        examined = cardinality
    else:
        rng = random.Random(seed)
        samples = max(samples, max((len(p.values) for p in params),
                                   default=1))
        candidates = _stratified_sample(space, samples, rng)
        examined = len(candidates)

    alive: Dict[str, set] = {p.name: set() for p in params}
    reject = [0] * len(constraints)
    sole = [0] * len(constraints)
    errors = [0] * len(constraints)
    feasible = 0
    feasible_sample: List[Config] = []

    for cfg in candidates:
        violated: List[int] = []
        for i, c in evaluable:
            ok = _check_safe(c, cfg)
            if ok is None:
                errors[i] += 1
                violated.append(i)
            elif not ok:
                violated.append(i)
        if not violated:
            feasible += 1
            if len(feasible_sample) < sample_cap:
                feasible_sample.append(dict(cfg))
            for name, value in cfg.items():
                alive[name].add(_value_ident(value))
        else:
            for i in violated:
                reject[i] += 1
            if len(violated) == 1:
                sole[violated[0]] += 1

    dead_values: Dict[str, List[Any]] = {}
    for p in params:
        dead = [v for v in p.values if _value_ident(v) not in alive[p.name]]
        if dead:
            dead_values[p.name] = dead

    vacuous: List[str] = []
    implied: List[str] = []
    if exact:
        for i, _ in evaluable:
            if errors[i]:
                continue
            if reject[i] == 0:
                vacuous.append(labels[i])
            elif sole[i] == 0:
                implied.append(labels[i])

    constraint_errors = {labels[i]: n for i, n in enumerate(errors) if n}

    return SpaceReport(
        cardinality=cardinality,
        examined=examined,
        feasible=feasible,
        feasible_fraction=feasible / examined if examined else 0.0,
        confidence="exact" if exact else "probabilistic",
        dead_values=dead_values,
        vacuous_constraints=vacuous,
        implied_constraints=implied,
        unknown_params=unknown,
        constraint_errors=constraint_errors,
        unsatisfiable=(feasible == 0),
        feasible_sample=feasible_sample,
    )


def _enumerate_product(space: SearchSpace) -> List[Config]:
    import itertools
    names = space.names
    return [dict(zip(names, combo))
            for combo in itertools.product(
                *(p.values for p in space.parameters))]


def space_findings(report: SpaceReport, *, kernel: str = "",
                   shape: Optional[Mapping[str, Any]] = None,
                   space_name: str = "default") -> List[Finding]:
    """Map a :class:`SpaceReport` onto typed findings.

    Severity policy: anything *proved* broken (exact confidence) is an
    error; the same observation under sampling is a warning (still
    strong evidence — stratification covered every value); statistics
    and redundancy observations are info.
    """
    shape_d = dict(shape) if shape is not None else None
    exact = report.confidence == "exact"
    out: List[Finding] = []

    def finding(rule_id: str, severity: str, detail: str,
                **data: Any) -> Finding:
        data.setdefault("space", space_name)
        data.setdefault("confidence", report.confidence)
        return Finding(rule_id=rule_id, severity=severity, kernel=kernel,
                       detail=f"[{space_name} space] {detail}",
                       shape=shape_d, data=data)

    for label, missing in report.unknown_params.items():
        out.append(finding(
            "space-unknown-param", "error",
            f"constraint {label} references undeclared parameter(s) "
            f"{missing}", constraint=label, missing=missing))

    for label, n in report.constraint_errors.items():
        out.append(finding(
            "space-constraint-raises", "error",
            f"constraint {label} raised on {n}/{report.examined} "
            f"examined config(s); a raising predicate kills searches "
            f"mid-strategy", constraint=label, raised=n))

    if report.unsatisfiable:
        if exact:
            detail = (f"no feasible config exists: all "
                      f"{report.examined} configs violate the "
                      f"constraint set")
        else:
            detail = (f"probably unsatisfiable: 0 of {report.examined} "
                      f"stratified samples feasible "
                      f"(cardinality {report.cardinality})")
        out.append(finding("space-unsatisfiable",
                           "error" if exact else "warning", detail,
                           examined=report.examined))
        return out          # everything below is noise once the set is empty

    for name, dead in report.dead_values.items():
        if exact:
            detail = (f"parameter {name!r}: value(s) {dead} appear in no "
                      f"feasible config (dead weight for every strategy)")
        else:
            detail = (f"parameter {name!r}: value(s) {dead} appeared in no "
                      f"feasible config across {report.examined} stratified "
                      f"samples (probabilistic)")
        out.append(finding("space-dead-value",
                           "warning" if exact else "info", detail,
                           param=name, values=dead))

    for label in report.vacuous_constraints:
        out.append(finding(
            "space-vacuous-constraint", "info",
            f"constraint {label} rejected no config — it can be removed",
            constraint=label))
    for label in report.implied_constraints:
        out.append(finding(
            "space-implied-constraint", "info",
            f"constraint {label} is implied: every config it rejects is "
            f"also rejected by another constraint", constraint=label))

    return out

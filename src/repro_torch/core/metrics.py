"""Structured measurement metrics and typed tuning objectives.

Retires the scalar ``time_s`` contract: evaluators attach a
:class:`Metrics` object carrying the **full per-repeat sample vector**
(plus compile time and an optional work term), and search layers
scalarize it through a typed :class:`Objective` instead of assuming
"median seconds of one fixed geometry".  This is CLTune's scenario 3
(the optimum depends on the input) extended to tail-latency targets:
a config that wins on median can lose badly at p99 once the sample
distribution is wide, and only the full vector can tell them apart.

Objectives are **first-class identities**, not just scalarizers:
``Trial``/``SearchResult``/``CacheEntry`` record which objective produced
a winner, and ``TuningCache`` refuses to fold winners tuned under
different objectives into one comparison (a p99 winner silently beating
a median winner during a distributed merge is the footgun this guards).

Spec grammar (the canonical string identity)::

    median_time                       # named preset (the default)
    p99_time                          # tail-latency preset
    throughput                        # maximize work/s (stored inverted)
    0.7*median_time+0.3*p99_time      # weighted multi-term

All terms scalarize to *lower-is-better seconds-like* values so every
strategy comparison in the engine keeps its existing direction;
``throughput`` maps to inverse throughput (seconds per unit work).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np

from .envknobs import env_str

__all__ = ["Metrics", "Objective", "DEFAULT_OBJECTIVE", "default_objective"]


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Metrics:
    """Full measurement result: the per-repeat sample vector + context.

    ``samples`` are wall-clock (or modeled) seconds per call, one entry
    per surviving repeat.  ``work`` is the per-call work in whatever unit
    the evaluator chose (flops, tokens, bytes); 0 means "unknown", which
    makes throughput objectives infeasible rather than silently wrong.
    """

    samples: Tuple[float, ...]
    compile_s: float = 0.0
    #: per-call work units (flops/tokens/...); 0 = unknown
    work: float = 0.0

    def __post_init__(self):
        if not self.samples:
            raise ValueError("Metrics requires at least one sample")
        object.__setattr__(self, "samples",
                           tuple(float(s) for s in self.samples))

    # -- derived statistics (all seconds, lower is better) ------------------

    def percentile(self, q: float) -> float:
        return float(np.percentile(np.asarray(self.samples, np.float64), q))

    @property
    def mean(self) -> float:
        return float(np.mean(self.samples))

    @property
    def median(self) -> float:
        return float(np.median(self.samples))

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p95(self) -> float:
        return self.percentile(95.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    @property
    def best(self) -> float:
        return min(self.samples)

    @property
    def worst(self) -> float:
        return max(self.samples)

    @property
    def std(self) -> float:
        return float(np.std(self.samples))

    @property
    def throughput(self) -> float:
        """Work units per second at the median sample (0 if work unknown)."""
        m = self.median
        return self.work / m if self.work > 0 and m > 0 else 0.0

    @property
    def inverse_throughput(self) -> float:
        """Seconds per unit work — the lower-is-better form of throughput."""
        if self.work <= 0:
            return math.inf
        return self.median / self.work

    def to_json(self) -> Dict[str, object]:
        d: Dict[str, object] = {
            "samples": [round(s, 9) for s in self.samples],
            "mean": self.mean, "median": self.median,
            "p95": self.p95, "p99": self.p99,
        }
        if self.compile_s:
            d["compile_s"] = self.compile_s
        if self.work:
            d["work"] = self.work
        return d

    @classmethod
    def from_samples(cls, samples, *, compile_s: float = 0.0,
                     work: float = 0.0) -> "Metrics":
        return cls(samples=tuple(float(s) for s in samples),
                   compile_s=float(compile_s), work=float(work))


# ---------------------------------------------------------------------------
# Objective
# ---------------------------------------------------------------------------

#: term name -> extractor over Metrics (all lower-is-better seconds-like)
_TERMS: Dict[str, Callable[[Metrics], float]] = {
    "median_time": lambda m: m.median,
    "mean_time": lambda m: m.mean,
    "p50_time": lambda m: m.p50,
    "p95_time": lambda m: m.p95,
    "p99_time": lambda m: m.p99,
    "min_time": lambda m: m.best,
    "max_time": lambda m: m.worst,
    "compile_time": lambda m: m.compile_s,
    # maximize throughput == minimize seconds-per-unit-work, keeping the
    # engine's lower-is-better comparisons intact
    "throughput": lambda m: m.inverse_throughput,
}

DEFAULT_SPEC = "median_time"


@dataclasses.dataclass(frozen=True)
class Objective:
    """A typed, canonical scalarization of :class:`Metrics`.

    ``terms`` is a tuple of ``(weight, term_name)`` pairs; single-preset
    objectives have one term with weight 1.  Equality and hashing go
    through the canonical ``spec`` string, so ``Objective.parse(s).spec``
    round-trips and two differently-written-but-equal specs compare equal.
    """

    terms: Tuple[Tuple[float, str], ...]

    def __post_init__(self):
        if not self.terms:
            raise ValueError("Objective requires at least one term")
        norm = []
        for w, name in self.terms:
            if name not in _TERMS:
                raise ValueError(
                    f"unknown objective term {name!r} "
                    f"(known: {', '.join(sorted(_TERMS))})")
            w = float(w)
            if not math.isfinite(w) or w <= 0:
                raise ValueError(f"objective weight must be finite and > 0, "
                                 f"got {w!r} for {name!r}")
            norm.append((w, name))
        # canonical order: by term name, so equal objectives spelled in a
        # different order still produce the same spec/identity
        norm.sort(key=lambda t: t[1])
        merged: Dict[str, float] = {}
        for w, name in norm:
            merged[name] = merged.get(name, 0.0) + w
        object.__setattr__(
            self, "terms",
            tuple((w, name) for name, w in sorted(merged.items())))

    # -- identity -----------------------------------------------------------

    @property
    def spec(self) -> str:
        """Canonical string form — the identity recorded in caches."""
        if len(self.terms) == 1 and self.terms[0][0] == 1.0:
            return self.terms[0][1]
        return "+".join(f"{_fmt_weight(w)}*{name}" for w, name in self.terms)

    @property
    def is_default(self) -> bool:
        return self.spec == DEFAULT_SPEC

    def __str__(self) -> str:
        return self.spec

    def __eq__(self, other) -> bool:
        if isinstance(other, Objective):
            return self.spec == other.spec
        if isinstance(other, str):
            return self.spec == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.spec)

    # -- scalarization ------------------------------------------------------

    def scalarize(self, metrics: Optional[Metrics]) -> float:
        """Collapse ``metrics`` to one lower-is-better float (inf if no
        metrics are available — an unmeasured config can never win)."""
        if metrics is None:
            return math.inf
        total = 0.0
        for w, name in self.terms:
            v = _TERMS[name](metrics)
            if not math.isfinite(v):
                return math.inf
            total += w * v
        return total

    # -- construction -------------------------------------------------------

    @classmethod
    def parse(cls, spec: str) -> "Objective":
        """Parse ``median_time`` / ``p99_time`` / ``0.7*a+0.3*b`` specs."""
        if isinstance(spec, Objective):
            return spec
        if not isinstance(spec, str) or not spec.strip():
            raise ValueError(f"objective spec must be a non-empty string, "
                             f"got {spec!r}")
        terms = []
        for part in spec.split("+"):
            part = part.strip()
            if not part:
                raise ValueError(f"empty term in objective spec {spec!r}")
            if "*" in part:
                w_s, _, name = part.partition("*")
                try:
                    w = float(w_s.strip())
                except ValueError:
                    raise ValueError(f"bad weight {w_s.strip()!r} in "
                                     f"objective spec {spec!r}") from None
                terms.append((w, name.strip()))
            else:
                terms.append((1.0, part))
        return cls(terms=tuple(terms))

    @classmethod
    def coerce(cls, value: Union["Objective", str, None]) -> "Objective":
        """None -> the default objective; strings are parsed."""
        if value is None:
            return DEFAULT_OBJECTIVE
        if isinstance(value, Objective):
            return value
        if isinstance(value, str):
            return cls.parse(value)
        raise TypeError(f"objective must be an Objective, spec string or "
                        f"None; got {type(value).__name__}: {value!r}")


def _fmt_weight(w: float) -> str:
    return f"{w:g}"


#: the historical behavior: median wall-clock seconds of the measured shape
DEFAULT_OBJECTIVE = Objective.parse(DEFAULT_SPEC)


def default_objective() -> Objective:
    """Session default: ``REPRO_OBJECTIVE`` spec, else ``median_time``."""
    spec = env_str("REPRO_OBJECTIVE", None)
    if not spec:
        return DEFAULT_OBJECTIVE
    return Objective.parse(spec)

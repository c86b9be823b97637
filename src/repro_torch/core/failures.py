"""Failure taxonomy for the evaluation path.

CLTune's core contract (paper §III) is that infeasible or failing
configurations are *tolerated*: a kernel that does not compile, produces
wrong results or crashes at run time is simply recorded as infeasible and
the search moves on.  Production autotuners (KTT, Kernel Tuning Toolkit)
go further and treat per-configuration failure as a first-class trial
outcome, because on large hostile spaces a single bad point must never
cost the measurements already taken.

This module is that contract made explicit, with no dependencies on the
rest of the package so every layer (evaluators, engine, strategies,
tuner, benchmarks) can share it:

* :class:`EvaluationError` and its subclasses — the typed exceptions
  evaluators raise instead of letting bare ``Exception``\\ s escape.  Each
  carries the evaluation ``stage`` it belongs to and whether it is
  ``transient`` (worth retrying) or systematic.
* :class:`FailureRecord` — the structured description of one failed
  configuration (stage, exception type, message, config key, attempts)
  that becomes part of the ``inf``-time :class:`~repro_torch.core.strategies.Trial`.
* :class:`RetryPolicy` — how many times, and for which exceptions, an
  evaluation is re-attempted before it is recorded as failed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# Typed evaluation errors
# ---------------------------------------------------------------------------

class EvaluationError(Exception):
    """Base class for per-configuration evaluation failures.

    ``stage`` names the evaluation phase the failure belongs to
    (``"prepare"`` = build/lower/compile, ``"measure"`` = run/verify/time);
    ``transient`` marks failures that a :class:`RetryPolicy` may retry
    (flaky allocation, contended device, timeout) as opposed to
    systematic ones (the config simply does not compile).
    """

    stage: str = "evaluate"
    transient: bool = False


class CompileError(EvaluationError):
    """The configuration failed to build, lower or compile."""

    stage = "prepare"


class MeasureError(EvaluationError):
    """The compiled configuration failed to run or time."""

    stage = "measure"


class VerificationFailure(MeasureError):
    """The kernel ran but produced outputs that differ from the reference."""


class InfeasibleConfigError(EvaluationError):
    """The configuration is structurally infeasible (shared memory, device limits).

    Raised by model-based evaluators whose feasibility check lives in the
    evaluation itself rather than in a search-space constraint.
    """

    stage = "prepare"


class EvaluationTimeout(MeasureError):
    """The measurement exceeded its time budget.  Transient by default:
    a timeout on a shared host is often contention, not the config."""

    transient = True


class TransientError(EvaluationError):
    """Explicitly retryable failure (OOM from a previous tenant, flaky
    allocation, device busy).  Evaluators wrap such causes in this."""

    transient = True


# ---------------------------------------------------------------------------
# FailureRecord — the structured trial-level failure description
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FailureRecord:
    """Why one configuration failed: the payload of an ``inf`` trial."""

    #: evaluation phase: "prepare" | "measure" (or "evaluate" when unknown)
    stage: str
    #: exception class name (e.g. "CompileError", "XlaRuntimeError")
    error_type: str
    #: truncated exception message
    message: str
    #: canonical config key (SearchSpace.config_key) of the failed config
    config_key: Tuple = ()
    #: total evaluation attempts, including retries (>= 1)
    attempts: int = 1

    def to_json(self) -> Dict[str, Any]:
        return {"stage": self.stage, "error_type": self.error_type,
                "message": self.message,
                "config_key": list(self.config_key),
                "attempts": self.attempts}

    @classmethod
    def from_exception(cls, exc: BaseException, *, stage: str,
                       config_key: Tuple = (),
                       attempts: int = 1) -> "FailureRecord":
        # a typed error naming a specific stage wins over the caller's
        # observation; the generic base default ("evaluate") does not —
        # e.g. a TransientError raised from measure() must stay "measure"
        typed_stage = getattr(exc, "stage", None)
        if isinstance(exc, EvaluationError) and typed_stage \
                and typed_stage != EvaluationError.stage:
            stage = typed_stage
        return cls(stage=stage, error_type=type(exc).__name__,
                   message=str(exc)[:500], config_key=tuple(config_key),
                   attempts=attempts)

    def __str__(self) -> str:
        return (f"[{self.stage}] {self.error_type}: {self.message} "
                f"(config={self.config_key}, attempts={self.attempts})")


def summarize_failures(records: List[FailureRecord]) -> Dict[str, Any]:
    """Aggregate failure records into a report-friendly dict."""
    by_stage: Dict[str, int] = {}
    by_type: Dict[str, int] = {}
    for r in records:
        by_stage[r.stage] = by_stage.get(r.stage, 0) + 1
        by_type[r.error_type] = by_type.get(r.error_type, 0) + 1
    return {"total": len(records), "by_stage": by_stage, "by_type": by_type}


# ---------------------------------------------------------------------------
# RetryPolicy — transient-failure handling
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RetryPolicy:
    """When to re-attempt a failed evaluation before recording a failure.

    The default retries nothing (every failure is final on first sight).
    ``max_retries=N`` with ``transient_only=True`` retries only failures
    that declare themselves transient (:class:`TransientError`,
    :class:`EvaluationTimeout`, or any :class:`EvaluationError` subclass
    with ``transient=True``); ``transient_only=False`` retries every
    failure, which is the right setting on hosts where compile-level
    flakiness is known to exist.
    """

    max_retries: int = 0
    transient_only: bool = True

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    def should_retry(self, exc: BaseException, attempts: int) -> bool:
        """attempts = evaluation attempts made so far (>= 1)."""
        if attempts > self.max_retries:
            return False
        if self.transient_only:
            return bool(getattr(exc, "transient", False))
        return True

    @classmethod
    def normalize(cls, value: "RetryPolicy | int | Dict[str, Any] | None"
                  ) -> "RetryPolicy":
        """Accept the shorthand forms EngineConfig allows."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, int):
            return cls(max_retries=value)
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"cannot build RetryPolicy from {value!r}")


class CircuitBreakerTripped(RuntimeError):
    """Internal signal: the failure circuit-breaker aborted the search.

    The engine converts this into a graceful partial result (the trials
    already measured survive, ``extra['aborted']`` describes why) rather
    than letting it escape to the caller.
    """

    def __init__(self, failures: int, evaluations: int, limit: int):
        self.failures = failures
        self.evaluations = evaluations
        self.limit = limit
        super().__init__(
            f"circuit breaker: {failures} failed configurations out of "
            f"{evaluations} evaluations (max_failures={limit}); the space "
            f"looks systematically broken")


__all__ = [
    "EvaluationError", "CompileError", "MeasureError", "VerificationFailure",
    "InfeasibleConfigError", "EvaluationTimeout", "TransientError",
    "FailureRecord", "RetryPolicy", "CircuitBreakerTripped",
    "summarize_failures",
]

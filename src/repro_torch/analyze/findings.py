"""Typed findings: the analyzer's unit of output.

Every rule in :mod:`repro_torch.analyze` — space audit, resource check,
declaration lint — reports through a :class:`Finding`: a stable
``rule_id``, a severity, the kernel it concerns and a human-readable
detail string, plus optional structured context (shape, profile, extra
data).  Findings aggregate into an :class:`AnalysisReport` that knows
how to serialize itself to machine-readable JSON and how to map
severities onto a process exit code (the ``python -m repro_torch.analyze``
contract: nonzero on errors, ``--strict`` also fails warnings).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

#: Ordered severities, most severe first.  ``error`` findings always
#: fail the CLI; ``warning`` findings fail it under ``--strict``;
#: ``info`` findings are advisory statistics and never gate.
SEVERITIES: Tuple[str, ...] = ("error", "warning", "info")

REPORT_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer diagnosis: a rule hit on a kernel/space/declaration."""

    rule_id: str
    severity: str
    kernel: str = ""
    detail: str = ""
    #: shape the finding was evaluated at (None for shape-free rules)
    shape: Optional[Dict[str, Any]] = None
    #: device-profile name for resource findings (None when device-free)
    profile: Optional[str] = None
    #: structured context for tooling (counts, offending values, labels)
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.rule_id:
            raise ValueError("Finding.rule_id must be non-empty")
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"unknown severity {self.severity!r}; expected one of "
                f"{SEVERITIES}")

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "rule_id": self.rule_id,
            "severity": self.severity,
            "kernel": self.kernel,
            "detail": self.detail,
        }
        if self.shape is not None:
            out["shape"] = dict(self.shape)
        if self.profile is not None:
            out["profile"] = self.profile
        if self.data:
            out["data"] = dict(self.data)
        return out

    def __str__(self) -> str:
        where = self.kernel or "<space>"
        ctx = ""
        if self.profile:
            ctx += f" [{self.profile}]"
        if self.shape:
            dims = ",".join(f"{k}={v}" for k, v in self.shape.items())
            ctx += f" [{dims}]"
        return f"{self.severity:<7} {self.rule_id:<28} {where}{ctx}: {self.detail}"


class AnalysisReport:
    """An ordered collection of findings with severity accounting."""

    def __init__(self, findings: Optional[List[Finding]] = None):
        self.findings: List[Finding] = list(findings or ())

    # -- collection --------------------------------------------------------
    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings: List[Finding]) -> None:
        self.findings.extend(findings)

    # -- accounting --------------------------------------------------------
    def by_severity(self, severity: str) -> List[Finding]:
        if severity not in SEVERITIES:
            raise ValueError(f"unknown severity {severity!r}")
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> List[Finding]:
        return self.by_severity("error")

    @property
    def warnings(self) -> List[Finding]:
        return self.by_severity("warning")

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def exit_code(self, strict: bool = False) -> int:
        """CLI contract: 1 on errors, 1 on warnings too under strict."""
        if self.errors:
            return 1
        if strict and self.warnings:
            return 1
        return 0

    # -- serialization -----------------------------------------------------
    def to_json(self) -> Dict[str, Any]:
        return {
            "schema_version": REPORT_SCHEMA_VERSION,
            "counts": self.counts(),
            "findings": [f.to_json() for f in self.findings],
        }

    def dumps(self, indent: int = 2) -> str:
        return json.dumps(self.to_json(), indent=indent, default=str,
                          sort_keys=False)

    def summary(self) -> str:
        c = self.counts()
        return (f"{len(self.findings)} finding(s): {c['error']} error, "
                f"{c['warning']} warning, {c['info']} info")

    def __len__(self) -> int:
        return len(self.findings)

    def __iter__(self) -> Iterator[Finding]:
        return iter(self.findings)

    def __repr__(self) -> str:
        return f"AnalysisReport({self.summary()})"


def stats_dict(report: "AnalysisReport",
               extra: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """Flatten a report into the stats mapping tuner outcomes attach."""
    out: Dict[str, Any] = {"findings": report.counts()}
    if extra:
        out.update(dict(extra))
    return out

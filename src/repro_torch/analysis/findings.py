"""Finding records emitted by the program-contract linter.

A :class:`Finding` is one observation about one contract by one check:
``severity`` is one of ``error`` (fails the lint), ``warning`` (reported,
does not fail) or ``info`` (context: skipped contracts, fallback notes).
Findings are plain data — JSON-serializable via :func:`to_json` — so the
CLI can persist ``results/lint_torch.json`` and tests can assert on exact
(check, contract, severity) triples.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass
class Finding:
    check: str                      # which check produced it
    contract: str                   # which contract it is about
    severity: str                   # error | warning | info
    message: str                    # one-line human summary
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}"
            )

    def to_json(self) -> Dict[str, Any]:
        return {
            "check": self.check,
            "contract": self.contract,
            "severity": self.severity,
            "message": self.message,
            "data": self.data,
        }


def error(check: str, contract: str, message: str, **data) -> Finding:
    return Finding(check, contract, "error", message, data)


def warning(check: str, contract: str, message: str, **data) -> Finding:
    return Finding(check, contract, "warning", message, data)


def info(check: str, contract: str, message: str, **data) -> Finding:
    return Finding(check, contract, "info", message, data)


@dataclasses.dataclass
class Report:
    """Outcome of one lint run: every finding plus what actually executed
    (a check that never ran cannot have passed)."""
    findings: List[Finding] = dataclasses.field(default_factory=list)
    checks_executed: List[str] = dataclasses.field(default_factory=list)
    contracts_executed: List[str] = dataclasses.field(default_factory=list)
    backend: Optional[str] = None
    # Wall-clock seconds per unit of work: "<contract>:build" for the
    # contract build, "<contract>:<check>" for each check run on it.
    timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    def extend(self, findings: List[Finding]) -> None:
        self.findings.extend(findings)

    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    @property
    def ok(self) -> bool:
        return not self.by_severity("error")

    def summary(self) -> Dict[str, int]:
        return {s: len(self.by_severity(s)) for s in SEVERITIES}

    def to_json(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "backend": self.backend,
            "summary": self.summary(),
            "checks_executed": sorted(set(self.checks_executed)),
            "contracts_executed": sorted(set(self.contracts_executed)),
            "timings": {k: round(v, 3) for k, v in sorted(self.timings.items())},
            "findings": [f.to_json() for f in self.findings],
        }

"""Diagnostic records of the lint pipeline over traced torch programs
(counterpart of paddle_tpu/analysis/diagnostics.py; the same records and
JSON schema).

Analog of the reference's PIR pass diagnostics / infermeta error surface
(paddle/pir/core/diagnostic: structured location + message instead of a
stack trace from deep inside the compiler). Every lint rule emits
`Diagnostic` records; the `Report` collects them, formats them, and
applies the severity policy (raise on error / warn on warning).
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict, Iterable, List, Optional


class Severity(enum.IntEnum):
    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # "error", not "Severity.ERROR"
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: which rule fired, how bad, where in the graph, and
    what to do about it."""

    rule: str                       # rule id, e.g. "TPU101"
    severity: Severity
    message: str
    # location: the program's name + node index and operator,
    # e.g. "decode/node[12]:aten.mm.default"
    where: str = ""
    hint: Optional[str] = None      # actionable fix suggestion

    def format(self) -> str:
        loc = f" at {self.where}" if self.where else ""
        hint = f"\n    hint: {self.hint}" if self.hint else ""
        return f"[{self.rule}] {self.severity}{loc}: {self.message}{hint}"


class LintError(Exception):
    """Raised when a lint run produced diagnostics at/above the failure
    severity. Carries the report for programmatic access."""

    def __init__(self, report: "Report"):
        self.report = report
        super().__init__("\n" + report.format())


class Report:
    """Ordered collection of diagnostics from one pipeline run."""

    def __init__(self, diagnostics: Iterable[Diagnostic] = (),
                 target: str = "<callable>"):
        self.diagnostics: List[Diagnostic] = list(diagnostics)
        self.target = target

    # -- collection ----------------------------------------------------
    def add(self, diag: Diagnostic):
        self.diagnostics.append(diag)

    def extend(self, diags: Iterable[Diagnostic]):
        self.diagnostics.extend(diags)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def __bool__(self) -> bool:
        return bool(self.diagnostics)

    # -- views ---------------------------------------------------------
    def at_least(self, severity: Severity) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity >= severity]

    @property
    def errors(self) -> List[Diagnostic]:
        return self.at_least(Severity.ERROR)

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity == Severity.WARNING]

    def by_rule(self) -> Dict[str, List[Diagnostic]]:
        out: Dict[str, List[Diagnostic]] = {}
        for d in self.diagnostics:
            out.setdefault(d.rule, []).append(d)
        return out

    # -- output --------------------------------------------------------
    def summary(self) -> str:
        n_err = len(self.errors)
        n_warn = len(self.warnings)
        n_info = len(self.diagnostics) - n_err - n_warn
        return (f"lint {self.target}: {n_err} error(s), "
                f"{n_warn} warning(s), {n_info} info")

    def format(self, min_severity: Severity = Severity.INFO) -> str:
        lines = [self.summary()]
        lines += [d.format() for d in self.diagnostics
                  if d.severity >= min_severity]
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """Stable, machine-readable form of the report: diagnostics in
        emission order, severities as lowercase strings, summary counts
        alongside. The schema `--format json` and the bench scripts
        consume — add keys, never rename them."""
        return {
            "target": self.target,
            "counts": {
                "error": len(self.errors),
                "warning": len(self.warnings),
                "info": len(self.diagnostics) - len(self.errors)
                - len(self.warnings),
            },
            "diagnostics": [
                {"rule": d.rule, "severity": str(d.severity),
                 "message": d.message, "where": d.where, "hint": d.hint}
                for d in self.diagnostics
            ],
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        """`to_dict` serialized with sorted keys — byte-stable for the
        same findings, so CI can diff two runs."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)

    def raise_or_warn(self, fail_on: Severity = Severity.ERROR,
                      warn_on: Severity = Severity.WARNING):
        """Apply the severity policy: LintError at/above `fail_on`,
        python warnings at/above `warn_on` (below fail_on)."""
        if self.at_least(fail_on):
            raise LintError(self)
        to_warn = [d for d in self.diagnostics
                   if warn_on <= d.severity < fail_on]
        if to_warn:
            import warnings

            for d in to_warn:
                warnings.warn(f"paddle_tpu_torch.analysis: {d.format()}",
                              stacklevel=3)
        return self

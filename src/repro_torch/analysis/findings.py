"""Finding model shared by every repro-lint checker.

A ``Finding`` is one diagnostic: a rule id, a severity, a location and a
message. Findings are value objects (frozen, ordered) so the CLI can sort,
de-duplicate and diff them against a committed baseline.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional

WARNING = "warning"
ERROR = "error"

#: severity rank used by ``--fail-on`` (higher = more severe)
SEVERITY_RANK = {WARNING: 1, ERROR: 2}


@dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic emitted by a checker."""
    path: str
    line: int
    col: int
    rule: str
    severity: str
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITY_RANK:
            raise ValueError(f"unknown severity {self.severity!r}")

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.severity} [{self.rule}] {self.message}")

    def key(self) -> tuple:
        """Baseline identity: location-insensitive so grandfathered findings
        survive unrelated line churn in the same file."""
        return (self.path, self.rule, self.message)


@dataclass
class RawFinding:
    """Checker-side finding, pre-location: carries the AST node so the
    framework can resolve line/col and statement-extent suppressions
    uniformly."""
    node: ast.AST
    rule: str
    severity: str
    message: str

    def at(self, path: str) -> Finding:
        return Finding(path=path,
                       line=getattr(self.node, "lineno", 1),
                       col=getattr(self.node, "col_offset", 0),
                       rule=self.rule, severity=self.severity,
                       message=self.message)

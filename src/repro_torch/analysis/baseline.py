"""Baseline files: grandfather existing findings, gate only on new ones.

A baseline is a JSON document listing known findings by their
location-insensitive key (path, rule, message). ``filter_findings`` removes
current findings that match an entry (consuming entries one-for-one, so two
identical findings need two baseline entries) and reports entries that no
longer match anything — stale entries mean the debt was paid and the baseline
should be regenerated with ``--write-baseline``.

The shipped baseline (``analysis/baseline.json``) is empty: src/ and
benchmarks/ lint clean, and the CI gate keeps them that way.
"""
from __future__ import annotations

import json
from collections import Counter
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.analysis.findings import Finding

FORMAT_VERSION = 1


def save_baseline(path: str, findings: Sequence[Finding]) -> None:
    doc = {
        "version": FORMAT_VERSION,
        "findings": [
            {"path": f.path, "rule": f.rule, "message": f.message,
             "line": f.line}
            for f in sorted(findings)
        ],
    }
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")


def load_baseline(path: str) -> List[Tuple[str, str, str]]:
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("version") != FORMAT_VERSION:
        raise ValueError(f"unsupported baseline version {doc.get('version')!r}"
                         f" in {path}")
    return [(e["path"], e["rule"], e["message"]) for e in doc["findings"]]


@dataclass
class BaselineResult:
    new: List[Finding]          # findings not covered by the baseline
    matched: List[Finding]      # grandfathered findings
    stale: List[Tuple[str, str, str]]   # baseline entries with no match


def filter_findings(findings: Sequence[Finding],
                    entries: Sequence[Tuple[str, str, str]]) -> BaselineResult:
    budget = Counter(entries)
    new: List[Finding] = []
    matched: List[Finding] = []
    for f in sorted(findings):
        k = f.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            matched.append(f)
        else:
            new.append(f)
    stale = [k for k, n in budget.items() for _ in range(n) if n > 0]
    return BaselineResult(new=new, matched=matched, stale=stale)

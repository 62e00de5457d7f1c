"""repro-lint CLI.

    python -m repro.analysis [--fail-on warning] [--baseline FILE] [paths]

Exit status is 1 when any finding at or above ``--fail-on`` severity
survives baseline filtering, else 0. ``--write-baseline FILE`` records the
current findings as grandfathered debt instead of failing.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.analysis import baseline as bl
from repro_torch.analysis.findings import SEVERITY_RANK
from repro_torch.analysis.framework import (all_rules, analyze_paths,
                                      default_checkers, iter_py_files)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro-lint",
        description="dimensional-analysis / JAX hot-path / scheduler-purity "
                    "linter for the repro codebase")
    p.add_argument("paths", nargs="*", default=["src"],
                   help="files or directories to analyze (default: src)")
    p.add_argument("--fail-on", choices=sorted(SEVERITY_RANK),
                   default="error",
                   help="minimum severity that fails the run "
                        "(default: error)")
    p.add_argument("--baseline", metavar="FILE",
                   help="JSON baseline of grandfathered findings to ignore")
    p.add_argument("--write-baseline", metavar="FILE",
                   help="write current findings to FILE and exit 0")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--list-rules", action="store_true",
                   help="print every rule id and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    checkers = default_checkers()
    if args.list_rules:
        for rule, desc in sorted(all_rules(checkers).items()):
            print(f"{rule}: {desc}")
        return 0

    findings = analyze_paths(args.paths, checkers)
    n_files = len(iter_py_files(args.paths))

    if args.write_baseline:
        bl.save_baseline(args.write_baseline, findings)
        print(f"wrote {len(findings)} finding(s) to {args.write_baseline}")
        return 0

    stale: list = []
    grandfathered = 0
    if args.baseline:
        res = bl.filter_findings(findings, bl.load_baseline(args.baseline))
        findings, grandfathered, stale = res.new, len(res.matched), res.stale

    if args.format == "json":
        print(json.dumps([vars(f) for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        for path, rule, message in stale:
            print(f"note: stale baseline entry {path} [{rule}] {message!r} "
                  f"— regenerate with --write-baseline", file=sys.stderr)
        n_err = sum(1 for f in findings if f.severity == "error")
        n_warn = len(findings) - n_err
        print(f"repro-lint: {len(findings)} finding(s) "
              f"({n_err} error(s), {n_warn} warning(s)), "
              f"{grandfathered} grandfathered, {n_files} file(s) checked",
              file=sys.stderr)

    threshold = SEVERITY_RANK[args.fail_on]
    failing = [f for f in findings if SEVERITY_RANK[f.severity] >= threshold]
    return 1 if failing else 0

"""Shared AST framework: parsed modules, suppressions, checker registry.

Checkers implement a tiny protocol::

    class MyChecker:
        name = "my-checker"
        rules = {"my-rule": "what it means"}
        def check(self, module: ParsedModule) -> Iterable[RawFinding]: ...

``analyze_paths`` walks ``.py`` files, parses each once, runs every
registered checker and resolves suppressions. Inline suppressions use::

    x = a_j + b_w  # repro-lint: allow[unit-add]

The comment may sit on any physical line of the flagged statement or on the
line directly above it; ``allow[*]`` silences every rule.
"""
from __future__ import annotations

import ast
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import ERROR, Finding, RawFinding

_ALLOW_RE = re.compile(r"#\s*repro-lint:\s*allow\[([^\]]*)\]")


def parse_suppressions(source: str) -> Dict[int, frozenset]:
    """Map line number -> set of rule ids allowed there ('*' = all)."""
    out: Dict[int, frozenset] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(line)
        if m:
            rules = frozenset(r.strip() for r in m.group(1).split(",")
                              if r.strip())
            out[i] = rules
    return out


@dataclass
class ParsedModule:
    path: str
    source: str
    tree: ast.Module
    suppressions: Dict[int, frozenset]

    @classmethod
    def from_source(cls, source: str, path: str = "<string>") -> "ParsedModule":
        tree = ast.parse(source, filename=path)
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                child._repro_parent = parent  # type: ignore[attr-defined]
        return cls(path=path, source=source, tree=tree,
                   suppressions=parse_suppressions(source))

    def is_suppressed(self, node: ast.AST, rule: str) -> bool:
        if not self.suppressions:
            return False
        lo = getattr(node, "lineno", None)
        if lo is None:
            return False
        hi = getattr(node, "end_lineno", lo) or lo
        # widen to the enclosing statement so a trailing comment on any
        # physical line of a multi-line statement applies
        stmt = node
        while stmt is not None and not isinstance(stmt, ast.stmt):
            stmt = getattr(stmt, "_repro_parent", None)
        if stmt is not None:
            lo = min(lo, stmt.lineno)
            hi = max(hi, getattr(stmt, "end_lineno", stmt.lineno) or stmt.lineno)
        for line in range(lo - 1, hi + 1):   # lo-1: comment-above form
            rules = self.suppressions.get(line)
            if rules and ("*" in rules or rule in rules):
                return True
        return False


def iter_py_files(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            files.append(p)
        elif os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for n in sorted(names):
                    if n.endswith(".py"):
                        files.append(os.path.join(root, n))
    return files


def default_checkers() -> List:
    from repro_torch.analysis.purity import SchedulerPurityChecker
    from repro_torch.analysis.torch_hotpath import TorchHotPathChecker
    from repro_torch.analysis.units import UnitsChecker
    return [UnitsChecker(), TorchHotPathChecker(), SchedulerPurityChecker()]


def all_rules(checkers: Optional[Sequence] = None) -> Dict[str, str]:
    rules: Dict[str, str] = {"parse-error": "file failed to parse"}
    for c in (checkers if checkers is not None else default_checkers()):
        rules.update(c.rules)
    return rules


def analyze_module(module: ParsedModule,
                   checkers: Optional[Sequence] = None) -> List[Finding]:
    findings: List[Finding] = []
    for checker in (checkers if checkers is not None else default_checkers()):
        for raw in checker.check(module):
            if not module.is_suppressed(raw.node, raw.rule):
                findings.append(raw.at(module.path))
    return sorted(set(findings))


def analyze_source(source: str, path: str = "<string>",
                   checkers: Optional[Sequence] = None) -> List[Finding]:
    return analyze_module(ParsedModule.from_source(source, path), checkers)


def analyze_paths(paths: Sequence[str],
                  checkers: Optional[Sequence] = None) -> List[Finding]:
    if checkers is None:
        checkers = default_checkers()
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        try:
            with tokenize.open(path) as f:
                source = f.read()
            module = ParsedModule.from_source(source, path)
        except (SyntaxError, UnicodeDecodeError, OSError) as exc:
            findings.append(Finding(path=path, line=getattr(exc, "lineno", 1) or 1,
                                    col=0, rule="parse-error", severity=ERROR,
                                    message=str(exc)))
            continue
        findings.extend(analyze_module(module, checkers))
    return sorted(set(findings))


# --------------------------------------------------------------- AST helpers

def dotted_name(node: ast.AST) -> Optional[str]:
    """'np.asarray' for Attribute/Name chains, None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def root_name(node: ast.AST) -> Optional[str]:
    """Leftmost Name of an Attribute/Subscript/Call chain (e.g. 'self' for
    self.pool.free_at[0].append)."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def decorator_names(node) -> List[str]:
    names = []
    for dec in getattr(node, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = dotted_name(target)
        if name:
            names.append(name)
        if isinstance(dec, ast.Call):   # functools.partial(jax.jit, ...)
            for arg in dec.args:
                inner = dotted_name(arg)
                if inner:
                    names.append(inner)
    return names

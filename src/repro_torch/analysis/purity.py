"""Scheduler purity: ``choose``/``dispatch``/``dispatch_rid`` must not
write to ``self``.

The PR-2 contract: pricing a query (``choose``/``dispatch``, and since the
vectorized engine's table path, ``dispatch_rid``) is a pure function of
(query, fleet state) so policies can be replayed, A/B-compared and priced
speculatively; all state commits happen in ``observe()``/``observe_rid()``
after the caller accepts the decision. This checker walks every class named
(or inheriting from a base named) ``*Scheduler``, computes the set of
methods reachable from the entry points through ``self.<m>()`` calls —
stopping at the commit methods — and flags any mutation of ``self`` state
inside them: attribute/subscript assignment, ``del``, mutating container
methods (``append``/``update``/``heappush`` & co.), and ``heapq.*`` calls
whose first argument is rooted at ``self``. Plan-constructing helpers
(``_price_terms``, ``_as_plan``, ...) are ordinary ``self.<m>()`` calls, so
the trace follows dispatch through them automatically.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.analysis.findings import ERROR, RawFinding
from repro_torch.analysis.framework import ParsedModule, dotted_name, root_name

_ENTRY_METHODS = ("choose", "dispatch", "dispatch_rid")
_COMMIT_METHODS = {"observe", "observe_rid"}

_MUTATOR_METHODS = {"append", "extend", "insert", "remove", "pop", "popitem",
                    "clear", "update", "add", "discard", "setdefault", "sort",
                    "reverse", "appendleft", "popleft", "push"}
_HEAP_FUNCS = {"heappush", "heappop", "heapreplace", "heappushpop", "heapify"}


def _is_scheduler_class(cls: ast.ClassDef) -> bool:
    if cls.name.endswith("Scheduler"):
        return True
    for base in cls.bases:
        name = dotted_name(base)
        if name and name.split(".")[-1].endswith("Scheduler"):
            return True
    return False


class SchedulerPurityChecker:
    name = "scheduler-purity"
    rules = {
        "scheduler-purity": "self-mutation reachable from Scheduler."
                            "choose/dispatch/dispatch_rid (must go through "
                            "observe()/observe_rid())",
    }

    def check(self, module: ParsedModule) -> Iterable[RawFinding]:
        out: List[RawFinding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef) and _is_scheduler_class(node):
                out.extend(self._check_class(node))
        return out

    def _check_class(self, cls: ast.ClassDef) -> Iterable[RawFinding]:
        methods: Dict[str, ast.FunctionDef] = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        reachable: Dict[str, str] = {}          # method -> entry it serves
        queue = [(m, m) for m in _ENTRY_METHODS if m in methods]
        while queue:
            name, entry = queue.pop()
            if name in reachable:
                continue
            reachable[name] = entry
            for sub in ast.walk(methods[name]):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and isinstance(sub.func.value, ast.Name) \
                        and sub.func.value.id == "self":
                    callee = sub.func.attr
                    if callee in methods and callee not in _COMMIT_METHODS \
                            and callee not in reachable:
                        queue.append((callee, entry))
        for name, entry in sorted(reachable.items()):
            yield from self._check_method(cls, methods[name], entry)

    def _check_method(self, cls, fn, entry: str) -> Iterable[RawFinding]:
        via = "" if fn.name == entry else f" (reachable from {entry}())"
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                continue
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            elif isinstance(node, ast.Delete):
                targets = node.targets
            for t in targets:
                attr = _self_target(t)
                if attr:
                    yield RawFinding(
                        node, "scheduler-purity", ERROR,
                        f"{cls.name}.{fn.name} writes self.{attr}{via}; "
                        f"schedulers may only mutate state in observe()")
            if isinstance(node, ast.Call):
                attr = self._mutating_call(node)
                if attr:
                    yield RawFinding(
                        node, "scheduler-purity", ERROR,
                        f"{cls.name}.{fn.name} mutates self.{attr}{via}; "
                        f"schedulers may only mutate state in observe()")

    def _mutating_call(self, node: ast.Call) -> Optional[str]:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _MUTATOR_METHODS:
            if root_name(func.value) == "self":
                return _describe(func.value) + f".{func.attr}(...)"
        callee = dotted_name(func)
        if callee:
            leaf = callee.rsplit(".", 1)[-1]
            if leaf in _HEAP_FUNCS and node.args \
                    and root_name(node.args[0]) == "self":
                return _describe(node.args[0]) + f" via {leaf}()"
        return None


def _self_target(t: ast.AST) -> Optional[str]:
    if isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            got = _self_target(e)
            if got:
                return got
        return None
    if isinstance(t, (ast.Attribute, ast.Subscript, ast.Starred)):
        if root_name(t) == "self":
            return _describe(t)
    return None


def _describe(node: ast.AST) -> str:
    parts: List[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            parts.append("[...]")
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            break
    parts.reverse()
    out = ""
    for p in parts:
        out += p if p == "[...]" else ("." + p if out else p)
    return out or "<attr>"

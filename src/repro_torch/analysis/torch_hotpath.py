"""Host-sync hazards on the port's torch hot paths (the port's counterpart
of ``repro/analysis/jax_hotpath.py``).

The serving contract is *one* host sync per batcher tick: a CUDA tensor
read on the host (``.item()``, ``.cpu()``, ``int(t)``, an ``if`` on it)
waits for every kernel queued before it, so a sync per lane or per layer
stalls the launch queue. This checker tracks torch provenance through a
function body (values produced by ``torch.*`` / ``F.*`` calls and tensor
methods, engine and model step methods, or class attributes assigned such
values anywhere in the class) and flags operations that force a
device->host transfer where they hurt:

  hot scopes
    * any method of a class whose name contains ``Batcher`` (tick loops);
    * the body of any ``for``/``while`` loop elsewhere (per-iteration sync).

  rules
    torch-host-sync      .item()/.cpu()/.tolist()/.numpy(), int()/float()/
                         bool(), or a numpy call (np.asarray, np.array, ...)
                         applied to a torch value in a hot scope
    torch-traced-branch  Python ``if``/``while``/ternary/``assert`` on a
                         torch value in a hot scope (an implicit bool(),
                         so a sync); a ``while`` test anywhere

``x.cpu()`` and ``np.asarray(x)`` yield *host* values: ``.cpu().numpy()``
is one sync, and ``int(toks[i])`` on its result is clean. Metadata
(``.shape``, ``.dtype``, ``.device``, ``.numel()``, ``.size()``, ...) is
host-side, and ``is``/``is not`` tests read no data. Iterating a tensor
makes views without a sync, so it is not flagged.

``jax-recompile`` has no counterpart: the port has no jit, so no scope
traces its arguments. Intentional syncs (the batcher's single per-tick
transfer, the engine's early-EOS check) are marked
``# repro-lint: allow[torch-host-sync]`` at the call site.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set

from repro_torch.analysis.findings import ERROR, RawFinding
from repro_torch.analysis.framework import ParsedModule, dotted_name

#: methods whose results live on device (engine/model step functions)
_PRODUCER_METHODS = {
    "prefill", "decode", "decode_paged", "prefill_chunk", "generate_step",
    "_prefill", "_decode", "_decode_paged", "_prefill_chunk", "_select",
    "new_cache", "new_paged_cache", "init_cache", "init_paged_cache",
    "apply", "sample",
}

_SYNC_BUILTINS = {"int", "float", "bool", "complex"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "__array__"}
_NP_MODULES = {"np", "numpy", "onp"}
_TORCH_MODULES = {"torch", "F"}
#: torch namespaces whose calls return host objects (events, flags, bytes)
_HOST_NAMESPACES = ("torch.cuda.", "torch.backends.", "torch.profiler.")
#: torch.<name>() calls that return host objects, not tensors
_HOST_TORCH_CALLS = {
    "device", "dtype", "Generator", "no_grad", "enable_grad",
    "inference_mode", "is_tensor", "is_floating_point", "is_complex",
    "is_grad_enabled", "manual_seed", "get_default_dtype",
    "set_default_dtype", "Size", "finfo", "iinfo", "numel",
}
#: attribute reads that are static metadata, not device data
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "is_meta",
                 "layout", "requires_grad", "nbytes", "itemsize"}
#: tensor methods that return host metadata
_HOST_METHODS = {"numel", "dim", "size", "element_size", "data_ptr",
                 "stride", "is_contiguous", "get_device", "nelement",
                 "storage_offset", "is_floating_point"}
#: calls that return host/static values even on torch args
_HOST_RESULT_CALLS = {"len", "range", "isinstance", "getattr", "type", "id",
                      "repr", "str"}


def _is_torchish_call(node: ast.Call) -> bool:
    callee = dotted_name(node.func)
    if callee:
        head = callee.split(".", 1)[0]
        if head in _TORCH_MODULES:
            if callee.startswith(_HOST_NAMESPACES):
                return False
            return callee.split(".", 1)[-1] not in _HOST_TORCH_CALLS
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _PRODUCER_METHODS:
        return True
    return False


class TorchHotPathChecker:
    name = "torch-hot-path"
    rules = {
        "torch-host-sync": "device->host transfer on a torch hot path",
        "torch-traced-branch": "Python control flow on a torch value",
    }

    def check(self, module: ParsedModule) -> Iterable[RawFinding]:
        out: List[RawFinding] = []
        for node in module.tree.body:
            self._walk_toplevel(node, out, class_ctx=None)
        return out

    def _walk_toplevel(self, node, out, class_ctx) -> None:
        if isinstance(node, ast.ClassDef):
            traced_attrs = _class_traced_attrs(node)
            hot_class = "Batcher" in node.name
            for sub in node.body:
                self._walk_toplevel(sub, out,
                                    class_ctx=(hot_class, traced_attrs))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            hot_class, traced_attrs = class_ctx or (False, frozenset())
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out.extend(_FunctionScan(
                        sub, hot_method=hot_class,
                        traced_attrs=traced_attrs).run())


def _class_traced_attrs(cls: ast.ClassDef) -> frozenset:
    """Attributes assigned torch values anywhere in the class body
    (``self.cache = torch.zeros(...)`` in __init__ makes ``self.cache``
    a torch value in every method)."""
    attrs: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and _seed_traced_expr(node.value):
            flat = []
            for t in node.targets:
                flat.extend(t.elts if isinstance(t, (ast.Tuple, ast.List))
                            else [t])
            for t in flat:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    attrs.add(t.attr)
    return frozenset(attrs)


def _seed_traced_expr(node) -> bool:
    """Conservative 'is this expression torch-valued' for attr seeding."""
    if isinstance(node, ast.Call):
        if _is_torchish_call(node):
            return True
        callee = dotted_name(node.func)
        if callee and callee.startswith("dict"):
            return any(_seed_traced_expr(kw.value) for kw in node.keywords)
        return False
    if isinstance(node, (ast.Subscript, ast.Attribute)):
        return _seed_traced_expr(node.value)
    return False


class _FunctionScan:
    def __init__(self, fn, *, hot_method: bool, traced_attrs: frozenset):
        self.fn = fn
        self.hot_method = hot_method
        self.traced_attrs = traced_attrs
        self.loop_depth = 0
        self.findings: List[RawFinding] = []
        self.traced: Set[str] = set()

    # hot = a per-iteration context where a sync is a per-tick cost
    @property
    def hot(self) -> bool:
        return self.hot_method or self.loop_depth > 0

    def run(self) -> List[RawFinding]:
        for stmt in self.fn.body:
            self.stmt(stmt)
        return self.findings

    def report(self, node, rule, message):
        self.findings.append(RawFinding(node, rule, ERROR, message))

    # -------------------------------------------------------------- tracking
    def is_traced(self, node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.traced
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            if isinstance(node.value, ast.Name) and node.value.id == "self":
                return node.attr in self.traced_attrs
            return self.is_traced(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_traced(node.value)
        if isinstance(node, ast.Call):
            return self.call_traced(node)
        if isinstance(node, ast.BinOp):
            return self.is_traced(node.left) or self.is_traced(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_traced(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_traced(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False            # identity reads no data
            return self.is_traced(node.left) \
                or any(self.is_traced(c) for c in node.comparators)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_traced(e) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return self.is_traced(node.body) or self.is_traced(node.orelse)
        return False

    def call_traced(self, node: ast.Call) -> bool:
        callee = dotted_name(node.func)
        if callee:
            if callee in _HOST_RESULT_CALLS or callee in _SYNC_BUILTINS:
                return False            # result lands on host
            if callee.split(".", 1)[0] in _NP_MODULES:
                return False            # numpy result is host-side
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SYNC_METHODS | _HOST_METHODS:
            return False                # .cpu(), .item(), .size(), ...
        if _is_torchish_call(node):
            return True
        # method call on a torch receiver (.float(), .to(dev), .view(...))
        if isinstance(node.func, ast.Attribute) \
                and self.is_traced(node.func.value):
            return True
        # calling a torch-valued callable
        if self.is_traced(node.func) and not isinstance(node.func,
                                                        ast.Attribute):
            return True
        # plain constructors propagate (dict(cache, k=t), tuple, ...)
        if callee in ("dict", "tuple", "list"):
            return any(self.is_traced(a) for a in node.args) \
                or any(self.is_traced(k.value) for k in node.keywords)
        return False

    def mark(self, target, traced: bool) -> None:
        if isinstance(target, ast.Name):
            if traced:
                self.traced.add(target.id)
            else:
                self.traced.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self.mark(e, traced)
        elif isinstance(target, ast.Starred):
            self.mark(target.value, traced)

    # ------------------------------------------------------------ statements
    def stmt(self, s) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return                      # scanned separately
        if isinstance(s, ast.Assign):
            self.expr(s.value)
            t = self.is_traced(s.value)
            for target in s.targets:
                self.mark(target, t)
            return
        if isinstance(s, (ast.AnnAssign, ast.AugAssign)):
            if getattr(s, "value", None) is not None:
                self.expr(s.value)
                if isinstance(s.target, ast.Name):
                    if isinstance(s, ast.AugAssign):
                        if self.is_traced(s.value):
                            self.traced.add(s.target.id)
                    else:
                        self.mark(s.target, self.is_traced(s.value))
            return
        if isinstance(s, (ast.If, ast.While)):
            self.expr(s.test)
            # a while-test re-evaluates every iteration: hot by definition
            if (self.hot or isinstance(s, ast.While)) \
                    and self.is_traced(s.test) \
                    and not _is_sync_call(s.test):
                kind = "if" if isinstance(s, ast.If) else "while"
                self.report(s, "torch-traced-branch",
                            f"`{kind}` on a torch value syncs the device per "
                            f"evaluation; use torch.where or sync once "
                            f"outside the loop")
            if isinstance(s, ast.While):
                self.loop_depth += 1
            for b in s.body + s.orelse:
                self.stmt(b)
            if isinstance(s, ast.While):
                self.loop_depth -= 1
            return
        if isinstance(s, ast.For):
            self.expr(s.iter)
            self.mark(s.target, self.is_traced(s.iter))
            self.loop_depth += 1
            for b in s.body + s.orelse:
                self.stmt(b)
            self.loop_depth -= 1
            return
        if isinstance(s, ast.Return):
            if s.value is not None:
                self.expr(s.value)
            return
        if isinstance(s, ast.Expr):
            self.expr(s.value)
            return
        if isinstance(s, ast.With):
            for item in s.items:
                self.expr(item.context_expr)
            for b in s.body:
                self.stmt(b)
            return
        if isinstance(s, ast.Try):
            for b in s.body + s.orelse + s.finalbody:
                self.stmt(b)
            for h in s.handlers:
                for b in h.body:
                    self.stmt(b)
            return
        if isinstance(s, ast.Assert):
            self.expr(s.test)
            if self.hot and self.is_traced(s.test):
                self.report(s, "torch-traced-branch",
                            "assert on a torch value syncs the device; "
                            "assert on shapes, or check once outside the "
                            "loop")
            return

    # ----------------------------------------------------------- expressions
    def expr(self, node) -> None:
        if node is None:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self.check_call(sub)
            elif isinstance(sub, ast.IfExp) and self.hot \
                    and self.is_traced(sub.test):
                self.report(sub, "torch-traced-branch",
                            "ternary on a torch value forces a host sync")

    def check_call(self, node: ast.Call) -> None:
        if not self.hot:
            return
        callee = dotted_name(node.func)
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _SYNC_METHODS \
                and self.is_traced(node.func.value):
            self.report(node, "torch-host-sync",
                        f".{node.func.attr}() on a torch value blocks on the "
                        f"device in a hot scope")
            return
        if not callee:
            return
        args_traced = any(self.is_traced(a) for a in node.args)
        if callee in _SYNC_BUILTINS and len(node.args) == 1 and args_traced:
            self.report(node, "torch-host-sync",
                        f"{callee}() on a torch value blocks on the device "
                        f"in a hot scope")
            return
        if callee.split(".", 1)[0] in _NP_MODULES and args_traced:
            self.report(node, "torch-host-sync",
                        f"{callee}() transfers a torch value to host in a hot "
                        f"scope")


def _is_sync_call(node) -> bool:
    """`if bool(x):` / `if x.item():` is already reported at the call."""
    if not isinstance(node, ast.Call):
        return False
    if isinstance(node.func, ast.Attribute):
        return node.func.attr in _SYNC_METHODS
    return dotted_name(node.func) in _SYNC_BUILTINS

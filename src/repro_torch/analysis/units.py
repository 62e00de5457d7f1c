"""Dimensional analysis over the repo's unit-suffix naming convention.

Every physical quantity in this codebase carries its unit in its name
(``wait_s``, ``energy_j``, ``power_w``, ``j_per_token``, ``t_prefill``);
this checker turns that convention into algebra. Dimensions are exponent
vectors over (time, energy, tokens):

    time  [s]        (1, 0, 0)      seconds/ms/us/hours
    energy [J]       (0, 1, 0)      joules/Wh/kWh
    power  [W]       (-1, 1, 0)     energy per time
    tokens           (0, 0, 1)      token counts
    s/token          (1, 0, -1)
    J/token          (0, 1, -1)
    dimensionless    (0, 0, 0)      counts, fractions, literals

Multiplication/division adds/subtracts exponents (``_w * _s`` is energy,
``_j / tokens`` is J/token); addition, subtraction, comparison and min/max
require equal exponents. Unknown names are wildcards — the checker only
speaks when both sides of an operation are known, so it is quiet on code
that ignores the convention and precise on code that uses it.

Rules:
  unit-add            mixing dimensions in +/-/comparison/min/max
  unit-assign         value of one dimension bound to a name of another
  unit-return         function's suffix dimension != its return dimension
  unit-derived-name   product/quotient of unit-bearing names assigned to a
                      name with no unit suffix (warning)
  unit-field          numeric dataclass field naming an energy/power/time
                      quantity without a unit suffix
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, replace
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.findings import ERROR, WARNING, RawFinding
from repro_torch.analysis.framework import ParsedModule, decorator_names, dotted_name

# ------------------------------------------------------------------ dimensions

Exp = Tuple[int, int, int]     # (time, energy, tokens) exponents

SCALAR_EXP: Exp = (0, 0, 0)
TIME_EXP: Exp = (1, 0, 0)
ENERGY_EXP: Exp = (0, 1, 0)
POWER_EXP: Exp = (-1, 1, 0)
TOKENS_EXP: Exp = (0, 0, 1)
T_PER_TOK_EXP: Exp = (1, 0, -1)
E_PER_TOK_EXP: Exp = (0, 1, -1)

_EXP_NAMES = {
    SCALAR_EXP: "dimensionless",
    TIME_EXP: "time [s]",
    ENERGY_EXP: "energy [J]",
    POWER_EXP: "power [W]",
    TOKENS_EXP: "token count",
    T_PER_TOK_EXP: "time per token [s/token]",
    E_PER_TOK_EXP: "energy per token [J/token]",
}
RECOGNIZED = frozenset(_EXP_NAMES)

#: derived results worth a naming complaint when bound to a unit-less name
_INTERESTING = frozenset({TIME_EXP, ENERGY_EXP, POWER_EXP,
                          T_PER_TOK_EXP, E_PER_TOK_EXP})


@dataclass(frozen=True)
class Dim:
    exp: Exp
    scale: float = 1.0          # e.g. _ms -> 1e-3 relative to seconds
    reliable: bool = False      # scale read straight off a suffix
    derived: bool = False       # produced by unit arithmetic (*, /)

    @property
    def name(self) -> str:
        return _EXP_NAMES[self.exp]

    @property
    def nonscalar(self) -> bool:
        return self.exp != SCALAR_EXP


SCALAR = Dim(SCALAR_EXP)
TIME = Dim(TIME_EXP, reliable=True)
ENERGY = Dim(ENERGY_EXP, reliable=True)
POWER = Dim(POWER_EXP, reliable=True)
TOKENS = Dim(TOKENS_EXP)
T_PER_TOK = Dim(T_PER_TOK_EXP)
E_PER_TOK = Dim(E_PER_TOK_EXP)


def _mul_exp(a: Exp, b: Exp, sign: int) -> Optional[Exp]:
    exp = tuple(x + sign * y for x, y in zip(a, b))
    return exp if exp in RECOGNIZED else None


def dim_mul(a: Optional[Dim], b: Optional[Dim], sign: int = 1) -> Optional[Dim]:
    """sign=+1 multiply, -1 divide. None (unknown) contaminates."""
    if a is None or b is None:
        return None
    exp = _mul_exp(a.exp, b.exp, sign)
    if exp is None:
        return None
    derived = ((a.nonscalar and b.nonscalar) or a.derived or b.derived) \
        and exp != SCALAR_EXP
    return Dim(exp, derived=derived)


# ---------------------------------------------------------------- name grammar

_TIME_UNITS = {"s": 1.0, "sec": 1.0, "secs": 1.0, "second": 1.0,
               "seconds": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9,
               "hour": 3600.0, "hours": 3600.0, "hr": 3600.0, "hrs": 3600.0}
_ENERGY_UNITS = {"j": 1.0, "joule": 1.0, "joules": 1.0,
                 "wh": 3600.0, "kwh": 3.6e6}
_POWER_UNITS = {"w": 1.0, "watt": 1.0, "watts": 1.0, "kw": 1e3}
_TOKEN_WORDS = {"tokens", "token", "toks"}
_COUNT_WORDS = {"count", "counts", "len", "blocks", "slots", "instances",
                "chips", "queries", "lanes", "steps", "iters", "ticks",
                "wakes", "hits", "misses", "layers", "experts",
                "bytes", "byte"}
#: unit-bearing but outside the modeled algebra (rates, bandwidths etc.)
_RATE_WORDS = {"qps", "hz", "rps", "gbps"}
#: one-letter/short unit tokens need a preceding underscore to count
_SHORT_UNITS = {"s", "j", "w", "ms", "us", "ns", "wh", "kw", "hr", "sec"}

#: full words that imply a dimension even without a unit suffix
_KEYWORD_DIMS = {
    "energy": ENERGY, "joule": ENERGY, "joules": ENERGY,
    "power": POWER, "watts": POWER, "wattage": POWER,
    "latency": TIME, "runtime": TIME, "wait": TIME, "delay": TIME,
    "duration": TIME, "linger": TIME, "timeout": TIME, "period": TIME,
    "interval": TIME, "elapsed": TIME, "horizon": TIME, "uptime": TIME,
    "time": TIME,
}

#: method names whose return dimension is part of the repo's API contract
_KNOWN_CALLS = {"power": POWER, "state_power": POWER, "energy": ENERGY,
                "runtime": TIME}
_MODULE_RECEIVERS = {"np", "jnp", "jax", "numpy", "math", "scipy", "lax"}

#: numeric pass-through callables: result dim = dim of the first data arg
_PASSTHROUGH = {"abs", "float", "int", "round", "sum"}
_NP_PASSTHROUGH = {"sum", "mean", "median", "percentile", "min", "max",
                   "abs", "maximum", "minimum", "asarray", "array",
                   "cumsum", "float64", "float32"}

#: names that declare themselves dimensionless
_DIMLESS_WORDS = {"frac", "fraction", "ratio", "norm", "factor", "scale",
                  "coeff", "coef", "util", "utilization", "pct", "percent",
                  "share", "weight", "lam", "attainment", "eff"}

#: dataclass-field words that name a physical quantity (rule unit-field)
_QUANTITY_WORDS = {"energy", "joule", "joules", "power", "watt", "watts",
                   "wattage", "draw", "latency", "wait", "delay", "duration",
                   "runtime", "linger", "timeout", "period", "interval",
                   "elapsed", "horizon", "uptime", "time"}


@dataclass(frozen=True)
class NameInfo:
    dim: Optional[Dim]
    has_unit: bool              # satisfies the suffix convention


_UNKNOWN = NameInfo(None, False)
_ANNOTATED = NameInfo(None, True)


@lru_cache(maxsize=4096)
def classify_name(name: str) -> NameInfo:
    toks = [t for t in name.lower().lstrip("_").split("_") if t]
    if not toks:
        return _UNKNOWN
    # t_ prefix convention: t_prefill, t_decode, t_tok are seconds.
    # t_in/t_out are the paper's token-count *thresholds* — repo idiom,
    # explicitly excluded.
    if toks[0] == "t" and len(toks) > 1 and toks[1] not in ("in", "out"):
        return NameInfo(TIME, True)
    # per-patterns: j_per_token, fleet_j_per_token, g_per_kwh, qps ...
    if "per" in toks[1:]:
        i = len(toks) - 1 - toks[::-1].index("per")
        base, denom = toks[:i], toks[i + 1:]
        if denom in (["token"], ["tok"], ["toks"], ["query"]):
            last = base[-1] if base else ""
            if last in _ENERGY_UNITS or last in ("energy",):
                return NameInfo(E_PER_TOK, True)
            if last in _TIME_UNITS or last in ("latency", "runtime"):
                return NameInfo(T_PER_TOK, True)
        return _ANNOTATED
    last = toks[-1]
    if last in _SHORT_UNITS and len(toks) < 2:
        return _UNKNOWN                      # bare 's'/'j'/'w' names
    if last in _TIME_UNITS:
        return NameInfo(Dim(TIME_EXP, scale=_TIME_UNITS[last], reliable=True),
                        True)
    if last in _ENERGY_UNITS:
        return NameInfo(Dim(ENERGY_EXP, scale=_ENERGY_UNITS[last],
                            reliable=True), True)
    if last in _POWER_UNITS:
        return NameInfo(Dim(POWER_EXP, scale=_POWER_UNITS[last],
                            reliable=True), True)
    if last in _TOKEN_WORDS:
        return NameInfo(TOKENS, True)
    if last in _COUNT_WORDS:
        return NameInfo(SCALAR, True)
    if last in _RATE_WORDS:
        return _ANNOTATED
    if last in _DIMLESS_WORDS:
        # declared dimensionless-ish, but opaque to the algebra: dividing
        # energy by `e_norm` (a same-dimension reference) NORMALIZES it —
        # treating the norm as a plain scalar would mislabel the quotient
        return _ANNOTATED
    if last in _KEYWORD_DIMS:
        return NameInfo(_KEYWORD_DIMS[last], False)
    return _UNKNOWN


# ----------------------------------------------------------------- the checker

class UnitsChecker:
    name = "units"
    rules = {
        "unit-add": "mixing dimensions in addition/subtraction/comparison",
        "unit-assign": "value of one dimension bound to a name of another",
        "unit-return": "function suffix dimension != returned dimension",
        "unit-derived-name": "unit arithmetic result assigned to a "
                             "suffix-less name",
        "unit-field": "numeric dataclass field names a physical quantity "
                      "but carries no unit suffix",
    }

    def check(self, module: ParsedModule) -> Iterable[RawFinding]:
        out: List[RawFinding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_dataclass(node))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.extend(_FunctionUnits(node).run())
        return out

    # dataclass field rule -------------------------------------------------
    def _check_dataclass(self, cls: ast.ClassDef) -> Iterable[RawFinding]:
        decs = decorator_names(cls)
        if not any(d == "dataclass" or d.endswith(".dataclass") for d in decs):
            return
        for stmt in cls.body:
            if not (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                continue
            if not _numeric_annotation(stmt.annotation):
                continue
            fname = stmt.target.id
            info = classify_name(fname)
            if info.has_unit:
                continue
            toks = set(fname.lower().lstrip("_").split("_"))
            if toks & _DIMLESS_WORDS:
                continue
            hit = toks & _QUANTITY_WORDS
            if hit:
                yield RawFinding(
                    stmt, "unit-field", ERROR,
                    f"field '{cls.name}.{fname}' names a physical quantity "
                    f"({'/'.join(sorted(hit))}) but has no unit suffix — "
                    f"append _s/_j/_w (or _per_token)")


def _numeric_annotation(ann: ast.AST) -> bool:
    if isinstance(ann, ast.Name):
        return ann.id in ("int", "float")
    if isinstance(ann, ast.Subscript):      # Optional[float]
        base = dotted_name(ann.value) or ""
        if base.split(".")[-1] == "Optional":
            return _numeric_annotation(ann.slice)
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _numeric_annotation(ann.left) or _numeric_annotation(ann.right)
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value in ("int", "float")
    return False


class _FunctionUnits:
    """Single-pass dimensional walk of one function body."""

    def __init__(self, fn):
        self.fn = fn
        self.env: Dict[str, Optional[Dim]] = {}
        self.findings: List[RawFinding] = []
        self.fn_dim = classify_name(fn.name).dim
        args = fn.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            self.env[a.arg] = classify_name(a.arg).dim
        if args.vararg:
            self.env[args.vararg.arg] = None
        if args.kwarg:
            self.env[args.kwarg.arg] = None

    def run(self) -> List[RawFinding]:
        for stmt in self.fn.body:
            self.stmt(stmt)
        return self.findings

    def report(self, node, rule, severity, message):
        self.findings.append(RawFinding(node, rule, severity, message))

    # ------------------------------------------------------------ statements
    def stmt(self, s: ast.stmt) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return                          # analyzed independently
        if isinstance(s, ast.Assign):
            v = self.expr(s.value)
            for t in s.targets:
                self.bind(t, v, s.value)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self.bind(s.target, self.expr(s.value), s.value)
        elif isinstance(s, ast.AugAssign):
            self.augassign(s)
        elif isinstance(s, ast.Return):
            if s.value is not None:
                v = self.expr(s.value)
                if (self.fn_dim is not None and v is not None
                        and self.fn_dim.nonscalar and v.nonscalar
                        and v.exp != self.fn_dim.exp):
                    self.report(s, "unit-return", ERROR,
                                f"'{self.fn.name}' is named as "
                                f"{self.fn_dim.name} but returns {v.name}")
        elif isinstance(s, (ast.If, ast.While)):
            self.expr(s.test)
            for b in s.body + s.orelse:
                self.stmt(b)
        elif isinstance(s, ast.For):
            it = self.expr(s.iter)
            self.bind(s.target, it, s.iter, check=False)
            for b in s.body + s.orelse:
                self.stmt(b)
        elif isinstance(s, ast.With):
            for item in s.items:
                self.expr(item.context_expr)
            for b in s.body:
                self.stmt(b)
        elif isinstance(s, ast.Try):
            for b in s.body + s.orelse + s.finalbody:
                self.stmt(b)
            for h in s.handlers:
                for b in h.body:
                    self.stmt(b)
        elif isinstance(s, ast.Expr):
            self.expr(s.value)
        elif isinstance(s, ast.Assert):
            self.expr(s.test)
        elif isinstance(s, (ast.Raise,)):
            if s.exc is not None:
                self.expr(s.exc)
        # Pass/Break/Continue/Import/Global/Delete: nothing dimensional

    def bind(self, target, v: Optional[Dim], value_node, check: bool = True):
        if isinstance(target, ast.Name):
            declared = classify_name(target.id)
            if check:
                self.assign_check(target, target.id, declared, v, value_node)
            if _is_literal(value_node):
                # `x = 0.0` declares nothing: keep the name's own dimension
                # so later `x += e_j` accumulation is still visible
                self.env[target.id] = declared.dim
            else:
                self.env[target.id] = v if v is not None else declared.dim
        elif isinstance(target, ast.Attribute):
            declared = classify_name(target.attr)
            if check:
                self.assign_check(target, target.attr, declared, v, value_node)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value_node, (ast.Tuple, ast.List)) \
                    and len(value_node.elts) == len(target.elts):
                for t, vn in zip(target.elts, value_node.elts):
                    self.bind(t, self.expr_cached(vn), vn, check=check)
            else:
                for t in target.elts:
                    self.bind(t, None, value_node, check=False)
        elif isinstance(target, ast.Subscript):
            self.expr(target.value)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, None, value_node, check=False)

    # Tuple-value elements were already visited by self.expr on the whole
    # value; re-deriving their dim must not double-report, so route through a
    # no-report evaluation.
    def expr_cached(self, node) -> Optional[Dim]:
        mark = len(self.findings)
        d = self.expr(node)
        del self.findings[mark:]
        return d

    def assign_check(self, node, name: str, declared: NameInfo,
                     v: Optional[Dim], value_node) -> None:
        if v is None or not v.nonscalar:
            return
        if _is_literal(value_node):
            return
        if declared.dim is not None and declared.dim.nonscalar:
            if declared.dim.exp != v.exp:
                self.report(node, "unit-assign", ERROR,
                            f"'{name}' is named as {declared.dim.name} but "
                            f"is assigned {v.name}")
            return
        if v.derived and v.exp in _INTERESTING and not declared.has_unit:
            suffix = {TIME_EXP: "_s", ENERGY_EXP: "_j", POWER_EXP: "_w",
                      T_PER_TOK_EXP: "_s_per_token",
                      E_PER_TOK_EXP: "_j_per_token"}[v.exp]
            self.report(node, "unit-derived-name", WARNING,
                        f"{v.name} result assigned to '{name}' which has no "
                        f"unit suffix (expected e.g. '{name}{suffix}')")

    def augassign(self, s: ast.AugAssign) -> None:
        v = self.expr(s.value)
        t: Optional[Dim] = None
        nm = None
        if isinstance(s.target, ast.Name):
            nm = s.target.id
            t = self.env.get(nm, classify_name(nm).dim)
        elif isinstance(s.target, ast.Attribute):
            nm = s.target.attr
            t = classify_name(nm).dim
        if isinstance(s.op, (ast.Add, ast.Sub)):
            r = self.add_combine(t, v, s, "augmented assignment")
            declared = classify_name(nm) if nm is not None else _UNKNOWN
            if (v is not None and v.derived and v.exp in _INTERESTING
                    and declared.dim is None and not declared.has_unit
                    and (t is None or not t.nonscalar)):
                suffix = {TIME_EXP: "_s", ENERGY_EXP: "_j", POWER_EXP: "_w",
                          T_PER_TOK_EXP: "_s_per_token",
                          E_PER_TOK_EXP: "_j_per_token"}[v.exp]
                self.report(s, "unit-derived-name", WARNING,
                            f"{v.name} accumulates into '{nm}' which has no "
                            f"unit suffix (expected e.g. '{nm}{suffix}')")
            if isinstance(s.target, ast.Name) and nm is not None:
                self.env[nm] = r
        elif isinstance(s.op, (ast.Mult, ast.Div)):
            if isinstance(s.target, ast.Name) and nm is not None:
                self.env[nm] = dim_mul(t, v, 1 if isinstance(s.op, ast.Mult)
                                       else -1)

    # ----------------------------------------------------------- expressions
    def expr(self, node) -> Optional[Dim]:
        if node is None:
            return None
        if isinstance(node, ast.Constant):
            if isinstance(node.value, (int, float)) \
                    and not isinstance(node.value, bool):
                return SCALAR
            return None
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            return classify_name(node.id).dim
        if isinstance(node, ast.Attribute):
            self.expr(node.value)
            return classify_name(node.attr).dim
        if isinstance(node, ast.BinOp):
            return self.binop(node)
        if isinstance(node, ast.UnaryOp):
            d = self.expr(node.operand)
            return d if isinstance(node.op, (ast.USub, ast.UAdd)) else None
        if isinstance(node, ast.Compare):
            l = self.expr(node.left)
            for op, comp in zip(node.ops, node.comparators):
                r = self.expr(comp)
                if isinstance(op, (ast.Lt, ast.Gt, ast.LtE, ast.GtE,
                                   ast.Eq, ast.NotEq)):
                    self.add_combine(l, r, node, "comparison")
            return SCALAR
        if isinstance(node, ast.Call):
            return self.call(node)
        if isinstance(node, ast.IfExp):
            self.expr(node.test)
            a, b = self.expr(node.body), self.expr(node.orelse)
            return a if a is not None else b
        if isinstance(node, ast.BoolOp):
            for v in node.values:
                self.expr(v)
            return None
        if isinstance(node, (ast.List, ast.Set)):
            d = None
            for e in node.elts:
                ed = self.expr(e)
                d = d if d is not None else ed
            return d
        if isinstance(node, ast.Tuple):
            for e in node.elts:
                self.expr(e)
            return None
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self.comprehension(node)
        if isinstance(node, ast.DictComp):
            self.bind_comprehension_targets(node.generators)
            self.expr(node.key)
            self.expr(node.value)
            return None
        if isinstance(node, ast.Dict):
            for k in node.keys:
                if k is not None:
                    self.expr(k)
            for v in node.values:
                self.expr(v)
            return None
        if isinstance(node, ast.Subscript):
            d = self.expr(node.value)
            self.expr(node.slice) if not isinstance(node.slice, ast.Slice) \
                else None
            return d
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self.expr(v.value)
            return None
        if isinstance(node, ast.FormattedValue):
            self.expr(node.value)
            return None
        if isinstance(node, ast.Starred):
            return self.expr(node.value)
        if isinstance(node, ast.Lambda):
            return None                     # opaque
        if isinstance(node, ast.Await):
            return self.expr(node.value)
        return None

    def binop(self, node: ast.BinOp) -> Optional[Dim]:
        l, r = self.expr(node.left), self.expr(node.right)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            return self.add_combine(
                l, r, node,
                "addition" if isinstance(node.op, ast.Add) else "subtraction")
        if isinstance(node.op, ast.Mult):
            return dim_mul(l, r, 1)
        if isinstance(node.op, (ast.Div, ast.FloorDiv)):
            return dim_mul(l, r, -1)
        if isinstance(node.op, ast.Mod):
            return l
        return None

    def add_combine(self, a: Optional[Dim], b: Optional[Dim], node,
                    what: str) -> Optional[Dim]:
        if a is None:
            return None if b is None else replace(b, reliable=False)
        if b is None:
            return replace(a, reliable=False)
        if not a.nonscalar:
            return replace(b, reliable=False)
        if not b.nonscalar:
            return replace(a, reliable=False)
        if a.exp != b.exp:
            self.report(node, "unit-add", ERROR,
                        f"{what} mixes {a.name} and {b.name}")
        elif a.reliable and b.reliable and a.scale != b.scale:
            self.report(node, "unit-add", ERROR,
                        f"{what} mixes two {a.name} values with different "
                        f"unit scales (e.g. _s vs _ms)")
        return replace(a, reliable=False, derived=False)

    def call(self, node: ast.Call) -> Optional[Dim]:
        # keyword bindings are assignments in disguise
        for kw in node.keywords:
            v = self.expr(kw.value)
            if kw.arg is not None:
                self.assign_check(kw.value, kw.arg, classify_name(kw.arg), v,
                                  kw.value)
        func = node.func
        callee = dotted_name(func)
        argdims = [self.expr(a) for a in node.args]
        if isinstance(func, (ast.Attribute, ast.Subscript, ast.Call)):
            # visiting the receiver chain (dotted_name doesn't recurse dims)
            self.expr(func.value if not isinstance(func, ast.Call) else func)
        # min/max behave like addition across their arguments
        if callee in ("min", "max") and len(node.args) > 1:
            d: Optional[Dim] = None
            for a, ad in zip(node.args, argdims):
                if _is_literal(a):
                    continue
                d = self.add_combine(d, ad, node, f"{callee}()") \
                    if d is not None else ad
            return None if d is None else replace(d, reliable=False)
        if callee in ("min", "max", "sorted") and len(node.args) == 1:
            return argdims[0] if argdims else None
        if callee in _PASSTHROUGH and len(node.args) >= 1:
            return argdims[0]
        if callee and "." in callee:
            head, leaf = callee.split(".", 1)[0], callee.rsplit(".", 1)[-1]
            if head in _MODULE_RECEIVERS:
                if leaf in _NP_PASSTHROUGH and argdims:
                    return argdims[0]
                return None
            if leaf in _KNOWN_CALLS:
                return _KNOWN_CALLS[leaf]
            return classify_name(leaf).dim
        if callee:
            if callee in _KNOWN_CALLS:
                return _KNOWN_CALLS[callee]
            return classify_name(callee).dim
        return None

    def comprehension(self, node) -> Optional[Dim]:
        self.bind_comprehension_targets(node.generators)
        return self.expr(node.elt)

    def bind_comprehension_targets(self, generators) -> None:
        for gen in generators:
            it = self.expr(gen.iter)
            self.bind(gen.target, it, gen.iter, check=False)
            for cond in gen.ifs:
                self.expr(cond)


def _is_literal(node) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.UnaryOp) and isinstance(node.operand, ast.Constant):
        return True
    return False

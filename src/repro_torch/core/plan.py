"""Placement-plan IR: the one typed value a scheduler hands to its callers.

Nine PRs grew four ad-hoc encodings of "where should this query run" —
bare ``SystemProfile`` returns, ``(prefill, decode)`` tuples from the
disaggregated policy, reservation side-state, and route-now-vs-defer
special-casing inside the carbon scheduler. This module closes that set
into a small IR that every engine and the live router settle identically
(``core.settlement``):

  * ``RunPlan(pool)``                         — run both phases on one pool;
  * ``SplitPlan(pool_prefill, pool_decode)``  — prefill here, migrate the KV
                                                prefix, decode there;
  * ``DeferPlan(until_s, inner)``             — admit the inner plan at a
                                                later clock (batch tiers
                                                riding a green window).

Pools are referenced by **system name** (the key both fleet engines and the
router already map back to their runtime pools), which keeps every plan a
plain JSON-serializable value: ``plan_to_json`` / ``plan_from_json``
round-trip each variant exactly.

Plans carry optional ``PlanTerms`` — the priced energy/runtime/wait
components (from ``CostModel``) behind the decision, plus the Eq. 1 cost
the scheduler minimized. Terms are advisory: settlement re-prices bookings
through the same ``CostModel`` seam, so a stale or absent ``terms`` never
desynchronizes accounting.

Legacy returns (a bare ``SystemProfile`` or an ``(a, b)`` profile tuple)
are coerced by ``as_plan`` one release behind a ``DeprecationWarning`` —
third-party schedulers keep working while they migrate.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Optional, Union

__all__ = ["PlanTerms", "RunPlan", "SplitPlan", "DeferPlan", "Plan",
           "as_plan", "plan_to_json", "plan_from_json"]


@dataclass(frozen=True)
class PlanTerms:
    """Priced components behind a placement decision (Eq. 1 operands):
    request energy and runtime on the chosen pool(s) — for a split, the
    prefill + migration + decode sum — the queue/defer wait the scheduler
    priced in, and the scalar cost it minimized."""
    energy_j: float
    runtime_s: float
    wait_s: float = 0.0
    cost: float = 0.0


@dataclass(frozen=True)
class RunPlan:
    """Run both phases on one pool (referenced by system name)."""
    pool: str
    terms: Optional[PlanTerms] = None

    @property
    def kind(self) -> str:
        return "run"


@dataclass(frozen=True)
class SplitPlan:
    """Disaggregated plan: prefill on ``pool_prefill``, migrate the KV
    prefix (``mig_bytes`` as priced at dispatch time), decode on
    ``pool_decode``. Engines re-derive the migration charge at handoff
    through the same ``CostModel.migration_terms`` seam, so ``mig_bytes``
    here is the plan's priced estimate, not the booked value."""
    pool_prefill: str
    pool_decode: str
    mig_bytes: float = 0.0
    terms: Optional[PlanTerms] = None

    @property
    def kind(self) -> str:
        return "split"


@dataclass(frozen=True)
class DeferPlan:
    """Admit ``inner`` at clock ``until_s`` instead of now (temporal
    arbitrage: batch tiers wait for a low-carbon / low-price window).
    ``inner`` must be a ``RunPlan`` or ``SplitPlan`` — deferrals do not
    nest (one admission clock per request)."""
    until_s: float
    inner: Union[RunPlan, SplitPlan]

    def __post_init__(self):
        if not isinstance(self.inner, (RunPlan, SplitPlan)):
            raise TypeError("DeferPlan.inner must be a RunPlan or SplitPlan, "
                            f"got {type(self.inner).__name__}")

    @property
    def kind(self) -> str:
        return "defer"

    @property
    def terms(self) -> Optional[PlanTerms]:
        return self.inner.terms


Plan = Union[RunPlan, SplitPlan, DeferPlan]

_LEGACY_WARNING = (
    "schedulers returning a bare SystemProfile (or an (a, b) profile tuple) "
    "from dispatch are deprecated; return a core.plan RunPlan/SplitPlan — "
    "the legacy encoding is coerced for one release")


def as_plan(target, *, warn: bool = True) -> Plan:
    """Coerce a scheduler ``dispatch`` return into the plan IR.

    Plans pass through untouched. A bare ``SystemProfile``-like (anything
    with a ``.name``) becomes ``RunPlan(name)``; an ``(a, b)`` tuple of two
    profile-likes becomes ``SplitPlan(a.name, b.name)``. Legacy encodings
    warn (``DeprecationWarning``) unless ``warn=False``."""
    if isinstance(target, (RunPlan, SplitPlan, DeferPlan)):
        return target
    if isinstance(target, tuple) and len(target) == 2 \
            and all(hasattr(x, "name") for x in target):
        if warn:
            warnings.warn(_LEGACY_WARNING, DeprecationWarning, stacklevel=3)
        return SplitPlan(target[0].name, target[1].name)
    name = getattr(target, "name", None)
    if isinstance(name, str):
        if warn:
            warnings.warn(_LEGACY_WARNING, DeprecationWarning, stacklevel=3)
        return RunPlan(name)
    raise TypeError(f"cannot interpret {target!r} as a placement plan")


# ----------------------------------------------------------------- JSON (de)ser
def _terms_to_json(terms: Optional[PlanTerms]) -> Optional[Dict]:
    if terms is None:
        return None
    return {"energy_j": terms.energy_j, "runtime_s": terms.runtime_s,
            "wait_s": terms.wait_s, "cost": terms.cost}


def _terms_from_json(d: Optional[Dict]) -> Optional[PlanTerms]:
    if d is None:
        return None
    return PlanTerms(energy_j=d["energy_j"], runtime_s=d["runtime_s"],
                     wait_s=d.get("wait_s", 0.0), cost=d.get("cost", 0.0))


def plan_to_json(plan: Plan) -> Dict:
    """Kind-tagged plain-dict form of a plan (inverse: ``plan_from_json``)."""
    if isinstance(plan, RunPlan):
        return {"kind": "run", "pool": plan.pool,
                "terms": _terms_to_json(plan.terms)}
    if isinstance(plan, SplitPlan):
        return {"kind": "split", "pool_prefill": plan.pool_prefill,
                "pool_decode": plan.pool_decode, "mig_bytes": plan.mig_bytes,
                "terms": _terms_to_json(plan.terms)}
    if isinstance(plan, DeferPlan):
        return {"kind": "defer", "until_s": plan.until_s,
                "inner": plan_to_json(plan.inner)}
    raise TypeError(f"not a plan: {plan!r}")


def plan_from_json(d: Dict) -> Plan:
    kind = d.get("kind")
    if kind == "run":
        return RunPlan(d["pool"], terms=_terms_from_json(d.get("terms")))
    if kind == "split":
        return SplitPlan(d["pool_prefill"], d["pool_decode"],
                         mig_bytes=d.get("mig_bytes", 0.0),
                         terms=_terms_from_json(d.get("terms")))
    if kind == "defer":
        return DeferPlan(d["until_s"], plan_from_json(d["inner"]))
    raise ValueError(f"unknown plan kind {kind!r}")

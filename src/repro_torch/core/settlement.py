"""Shared plan settlement: one booking path for engines and the live router.

Before this module, the interpretation of a scheduler's placement decision
was hand-duplicated three times — the event engine (``core.fleet``), the
vectorized engine (``core.fleet_vec``), and the live router
(``serving.router``) each re-derived "which pool, which role, what service
time, what migration charge" from ad-hoc returns. This module is the single
settlement seam they all call:

  * ``resolve_plan``   — coerce/validate a ``dispatch`` return into the plan
                         IR (legacy ``SystemProfile`` / tuple returns get a
                         ``DeprecationWarning`` shim for one release);
  * ``plan_legs``      — structural decomposition (first-leg pool, decode
                         pool, enqueue role, admission clock);
  * ``leg_service_s``  — the priced service time for a leg's role;
  * ``migration_charge`` — the KV-prefix migration bytes/seconds/joules with
                         the no-path guard both engines must raise;
  * ``route_bookings`` / ``reconcile_deltas`` / ``reconcile_split_deltas``
                       — the router's expectation-booking rows and EOS
                         reconciliation deltas.

Every float expression here is lifted verbatim from the pre-refactor call
sites — operand order and association preserved — because the
bit-for-bit equivalence gate (same summaries, same records, both engines,
all pinned seeds) is the contract this refactor must not move.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Mapping, Optional, Tuple

from repro_torch.core.plan import (DeferPlan, Plan, RunPlan, SplitPlan, as_plan)

__all__ = ["ROLE_FULL", "ROLE_PF", "ROLE_DEC", "Booking",
           "resolve_plan", "plan_legs", "leg_service_s", "migration_charge",
           "route_bookings", "reconcile_deltas", "reconcile_split_deltas"]

# Execution role of a queued leg: full request, prefill-only (decode happens
# elsewhere after a KV migration), or decode-only (arrived via migration).
# Both engines enqueue (key, seq, rec/rid, svc, role) tuples tagged with one
# of these.
ROLE_FULL, ROLE_PF, ROLE_DEC = 0, 1, 2


def resolve_plan(raw, q, known: Mapping[str, object]) -> Plan:
    """Normalize and validate a scheduler ``dispatch`` return.

    ``known`` maps valid system names to anything truthy about the fleet
    (both engines pass their system-name index; the router passes its
    system-name → pool-name map). Validation and degradation mirror the
    pre-plan engine semantics exactly:

      * a split whose query has no decode phase (``q.n <= 0``) degrades to
        a ``RunPlan`` on the prefill pool — only that pool's name is
        validated, matching the old ``s = a`` path;
      * unknown pool names raise ``KeyError`` with the engines' historical
        message, *before* the scheduler's ``observe`` runs.
    """
    plan = as_plan(raw)
    inner = plan.inner if isinstance(plan, DeferPlan) else plan
    if isinstance(inner, SplitPlan) and q.n <= 0:
        inner = RunPlan(inner.pool_prefill, terms=inner.terms)
        plan = DeferPlan(plan.until_s, inner) \
            if isinstance(plan, DeferPlan) else inner
    if isinstance(inner, SplitPlan):
        names = (inner.pool_prefill, inner.pool_decode)
    else:
        names = (inner.pool,)
    for name in names:
        if name not in known:
            raise KeyError(f"scheduler dispatched to unknown system {name!r}")
    return plan


def plan_legs(plan: Plan, q) -> Tuple[str, Optional[str], int, float]:
    """Decompose a resolved plan into what an engine enqueues.

    Returns ``(pool, decode_pool, role, until_s)``: the system name of the
    first leg's pool, the decode pool's system name (``None`` unless split),
    the enqueue role for the first leg, and the admission clock (0.0 means
    admit on arrival)."""
    until_s = 0.0
    if isinstance(plan, DeferPlan):
        until_s = plan.until_s
        plan = plan.inner
    if isinstance(plan, SplitPlan):
        return plan.pool_prefill, plan.pool_decode, ROLE_PF, until_s
    return plan.pool, None, ROLE_FULL, until_s


def leg_service_s(model, q, system, role: int) -> float:
    """Service time the engines charge a queued leg of ``role`` on ``system``
    (the exact pre-refactor pricing calls)."""
    if role == ROLE_PF:
        return model.split_runtime(q.m, q.n, system)[0]
    if role == ROLE_DEC:
        return model.split_runtime(q.m, q.n, system)[1]
    return model.runtime(q.m, q.n, system)


def migration_charge(model, m: int, src, dst, *, block_size: int, rid):
    """KV-prefix migration (bytes, seconds, joules) for a split handoff,
    with the shared no-path guard both engines raise."""
    nbytes, t_mig_s, e_mig_j = model.migration_terms(
        m, src, dst, block_size=block_size)
    if not math.isfinite(t_mig_s):
        raise ValueError(
            f"split request {rid} has no migration path from "
            f"{src.name!r} to {dst.name!r} (link_bw_gbps <= 0 on an endpoint)")
    return nbytes, t_mig_s, e_mig_j


# ------------------------------------------------------------- router booking
@dataclass(frozen=True)
class Booking:
    """One pool's expectation-booked accounting row for a routed request
    (``pool`` is the system name; the router maps it back to its pool key)."""
    pool: str
    queries: int
    energy_j: float
    runtime_s: float
    tokens: int


def route_bookings(model, plan: Plan, q, systems: Mapping[str, object],
                   *, block_size: int = 0) -> List[Booking]:
    """Expectation bookings for a routed plan — the router's historical
    booking math, one row per pool touched.

    ``systems`` maps system name → ``SystemProfile``. A ``DeferPlan`` books
    as its inner plan (live serving cannot time-shift; the router runs the
    inner placement immediately). Split rows mirror the old
    ``_route_split``: the prefill pool absorbs the migration charge and the
    prompt tokens, the decode pool the decode-phase terms and output tokens.
    """
    if isinstance(plan, DeferPlan):
        plan = plan.inner
    if isinstance(plan, SplitPlan):
        sys_a = systems[plan.pool_prefill]
        sys_b = systems[plan.pool_decode]
        e_pf, _ = model.split_energy(q.m, q.n, sys_a)
        _, e_dec = model.split_energy(q.m, q.n, sys_b)
        r_pf, _ = model.split_runtime(q.m, q.n, sys_a)
        _, r_dec = model.split_runtime(q.m, q.n, sys_b)
        _, mig_s, mig_j = model.migration_terms(
            q.m, sys_a, sys_b, block_size=block_size)
        return [Booking(plan.pool_prefill, 1, e_pf + mig_j, r_pf + mig_s, q.m),
                Booking(plan.pool_decode, 0, e_dec, r_dec, q.n)]
    sys_one = systems[plan.pool]
    e = model.energy(q.m, q.n, sys_one)
    r = model.runtime(q.m, q.n, sys_one)
    return [Booking(plan.pool, 1, e, r, q.m + q.n)]


def reconcile_deltas(model, m: int, expected_n: int, actual_n: int, system):
    """EOS reconciliation for a single-pool booking: the (energy, runtime,
    tokens) corrections to move the expectation rows to actuals."""
    d_e = model.energy(m, actual_n, system) - model.energy(m, expected_n, system)
    d_r = model.runtime(m, actual_n, system) - model.runtime(m, expected_n, system)
    return d_e, d_r, actual_n - expected_n


def reconcile_split_deltas(model, m: int, expected_n: int, actual_n: int,
                           sys_a, sys_b):
    """EOS reconciliation for a split booking: per-pool (energy, runtime)
    corrections — prefill-side terms move with ``n`` only through the
    phase split, decode-side terms carry the output-token delta."""
    da_e = (model.split_energy(m, actual_n, sys_a)[0]
            - model.split_energy(m, expected_n, sys_a)[0])
    da_r = (model.split_runtime(m, actual_n, sys_a)[0]
            - model.split_runtime(m, expected_n, sys_a)[0])
    db_e = (model.split_energy(m, actual_n, sys_b)[1]
            - model.split_energy(m, expected_n, sys_b)[1])
    db_r = (model.split_runtime(m, actual_n, sys_b)[1]
            - model.split_runtime(m, expected_n, sys_b)[1])
    return (da_e, da_r), (db_e, db_r), actual_n - expected_n

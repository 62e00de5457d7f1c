"""Carbon-aware extension of the paper's cost function (beyond paper).

The paper optimizes joules; its related-work section (Radovanović et al.,
Chien et al.) points at *carbon*-aware computing as the real objective.
Joules are time-invariant, grams of CO2 are not: grid carbon intensity CI(t)
swings 2-4x daily. We extend Eq. 1 to

    U(m, n, s, t) = lambda * CI(t_exec) * E(m, n, s) + (1 - lambda) * R(m, n, s)

and add a scheduler that exploits the *temporal* dimension the paper leaves
on the table: deferrable queries (the paper's own "overnight batch" use case,
Section 6.3) wait for low-carbon windows; interactive ones route by the
spatial hybrid rule as before. All pricing goes through the unified
``CostModel`` (with this module's ``CarbonProfile`` attached), so swapping
the perf oracle re-prices carbon decisions too.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import DeferPlan, Plan, RunPlan
from repro_torch.core.pricing import AnalyticOracle, CostModel, CostParams
from repro_torch.core.scheduler import Assignment, FleetState, Scheduler
from repro_torch.core.systems import SystemProfile
from repro_torch.core.workload import Query


@dataclass(frozen=True)
class CarbonProfile:
    """Sinusoidal daily grid carbon intensity (gCO2/kWh), solar-dip shaped."""
    mean_g_per_kwh: float = 400.0
    swing: float = 0.45              # peak-to-mean fractional swing
    trough_hour: float = 13.0        # solar midday dip

    def intensity(self, t_s: float) -> float:
        hours = (t_s / 3600.0) % 24.0
        phase = 2.0 * math.pi * (hours - self.trough_hour) / 24.0
        return self.mean_g_per_kwh * (1.0 - self.swing * math.cos(phase))

    def grams(self, joules: float, t_s: float) -> float:
        return joules / 3.6e6 * self.intensity(t_s)


def next_green_window(carbon: CarbonProfile, t_s: float, *,
                      below: float = 0.85, max_defer_s: float = 24 * 3600.0,
                      step_s: float = 900.0) -> float:
    """Earliest clock >= ``t_s`` at which ``carbon`` dips below ``below`` x
    its mean, scanned at ``step_s`` resolution; ``t_s`` itself when no window
    opens within ``max_defer_s`` (run now). Shared by the single-fleet
    ``CarbonAwareScheduler`` and the multi-region ``GlobalDispatcher``."""
    target = carbon.mean_g_per_kwh * below
    t = t_s
    while t < t_s + max_defer_s:
        if carbon.intensity(t) <= target:
            return t
        t += step_s
    return t_s


class CarbonAwareScheduler(Scheduler):
    """Spatial hybrid routing + temporal deferral.

    Queries with ``n > defer_out_threshold`` output tokens are treated as
    batch work (paper Section 6.3's own example) and deferred to the next
    low-carbon window (intensity below ``defer_below`` x mean); interactive
    queries run immediately on the carbon-cheapest system.

    Online use: ``dispatch(q, fleet_state)`` makes the same route-now vs
    defer decision against the snapshot clock (``fleet_state.time_s``) and
    plans onto the system that is carbon-cheapest at the planned execution
    time — deferrable work is thereby steered to the hardware that will be
    greenest when it actually runs. By default (``defer=False``) the query
    still enters the queue now, preserving the historical single-fleet
    behavior bit-for-bit; with ``defer=True`` dispatch wraps the placement
    in a ``DeferPlan`` so engines hold the request out of the queue until
    the green window actually opens (temporal shifting with idle-inclusive
    fleet accounting).
    """

    def __init__(self, cfg: ModelConfig, systems: Sequence[SystemProfile],
                 carbon: CarbonProfile = CarbonProfile(), *,
                 defer_out_threshold: int = 256, defer_below: float = 0.85,
                 max_defer_s: float = 24 * 3600.0, defer: bool = False,
                 model: Optional[CostModel] = None):
        if model is None:
            model = CostModel(cfg, AnalyticOracle(), CostParams(),
                              carbon=carbon)
        elif model.carbon is None:
            model = CostModel(cfg, model.oracle, model.cp, carbon=carbon,
                              quant=model.quant, memo_size=model.memo_size)
        elif carbon != CarbonProfile() and carbon != model.carbon:
            raise ValueError(
                "conflicting carbon profiles: both carbon= and a "
                "carbon-bearing model= were given and disagree; build the "
                "model with the intended CarbonProfile")
        super().__init__(cfg, systems, model=model)
        # the model's profile is authoritative: window planning (_plan) and
        # pricing (model.grams) must read the SAME carbon curve, so a model
        # passed in with its own CarbonProfile overrides the ctor default
        self.carbon = self.model.carbon
        self.defer_out_threshold = defer_out_threshold
        self.defer_below = defer_below
        self.max_defer_s = max_defer_s
        self.defer = defer

    def _next_green_window(self, t_s: float) -> float:
        return next_green_window(self.carbon, t_s, below=self.defer_below,
                                 max_defer_s=self.max_defer_s)

    def _deferrable(self, q: Query) -> bool:
        return q.n > self.defer_out_threshold

    def _plan(self, q: Query, now: float) -> float:
        """Route-now vs defer: planned execution time for ``q`` seen at
        clock ``now``."""
        return self._next_green_window(now) if self._deferrable(q) else now

    def _greenest(self, q: Query, t_exec: float) -> SystemProfile:
        return min(self.systems,
                   key=lambda s: self.model.grams(q.m, q.n, s, t_exec))

    def choose(self, q: Query) -> SystemProfile:
        """Workload-only decision at the query's own arrival clock."""
        return self._greenest(q, self._plan(q, q.arrival_s))

    def dispatch(self, q: Query, fleet: Optional[FleetState] = None) -> Plan:
        """Online dispatch against the fleet snapshot's clock: a priced
        ``RunPlan`` on the system greenest at the planned execution time —
        wrapped in a ``DeferPlan`` holding admission until the green window
        when deferral is enabled and the window is in the future."""
        now = fleet.time_s if fleet is not None else q.arrival_s
        t_exec = self._plan(q, now)
        s = self._greenest(q, t_exec)
        inner = RunPlan(s.name, self._price_terms(q, s, wait_s=t_exec - now))
        if self.defer and t_exec > now:
            return DeferPlan(until_s=t_exec, inner=inner)
        return inner

    def assign(self, queries: Sequence[Query]) -> List[Assignment]:
        out = []
        for q in queries:
            t_exec = self._plan(q, q.arrival_s)
            best = self._greenest(q, t_exec)
            out.append(Assignment(q, best,
                                  self.model.energy(q.m, q.n, best),
                                  self.model.runtime(q.m, q.n, best),
                                  wait_s=t_exec - q.arrival_s))
        return out


def total_grams(cfg: ModelConfig, assignments: Sequence[Assignment],
                carbon: CarbonProfile) -> float:
    return sum(carbon.grams(a.energy_j, a.query.arrival_s + a.wait_s)
               for a in assignments)

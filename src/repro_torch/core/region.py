"""Region-lifted control plane: named fleets under one global dispatcher.

The paper optimizes placement *within* one heterogeneous cluster; its
motivation (grid carbon intensity, electricity price) is a property of the
*region* the cluster sits in. This module lifts the fleet simulator one
level: a ``Region`` is a named set of pools plus the region's carbon
intensity trace, electricity price trace, and inter-region link.
``simulate_fleet(cfg, queries, regions=[...], scheduler=...)`` flattens the
regions into one pool dict (pool and system names become
``<region>/<name>``) and runs the existing engines unchanged — so fleet
accounting stays idle-inclusive across every region's pools.

``GlobalDispatcher`` is the minimal cross-region policy the plan IR makes
expressible: interactive queries route spatially to the system with the
lowest carbon (optionally price-weighted) cost *right now*; batch-tier
queries (the paper's own "overnight batch" use case) are deferred —
``DeferPlan`` — into the earliest green window across all regions and run
on the system that will be cheapest when that window opens.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core.carbon import CarbonProfile, next_green_window
from repro_torch.core.fleet import PoolSpec
from repro_torch.core.plan import DeferPlan, Plan, RunPlan
from repro_torch.core.pricing import CostModel, CostParams
from repro_torch.core.scheduler import FleetState, Scheduler
from repro_torch.core.systems import SystemProfile
from repro_torch.core.workload import Query

__all__ = ["RegionLink", "PriceProfile", "Region", "flatten_regions",
           "GlobalDispatcher"]


@dataclass(frozen=True)
class RegionLink:
    """Wide-area link out of a region (KV/state migration pricing input)."""
    bw_gbps: float = 100.0


@dataclass(frozen=True)
class PriceProfile:
    """Sinusoidal daily electricity price (USD/kWh), overnight-trough
    shaped — the temporal twin of ``CarbonProfile``."""
    mean_usd_per_kwh: float = 0.10
    swing: float = 0.30              # peak-to-mean fractional swing
    trough_hour: float = 3.0         # overnight demand trough

    def price(self, t_s: float) -> float:
        hours = (t_s / 3600.0) % 24.0
        phase = 2.0 * math.pi * (hours - self.trough_hour) / 24.0
        return self.mean_usd_per_kwh * (1.0 - self.swing * math.cos(phase))


@dataclass(frozen=True)
class Region:
    """A named fleet plus the traces that make its location matter."""
    name: str
    pools: Mapping[str, PoolSpec]
    carbon: CarbonProfile = CarbonProfile()
    price: PriceProfile = PriceProfile()
    link: RegionLink = RegionLink()


def flatten_regions(regions: Sequence[Region]) -> Dict[str, PoolSpec]:
    """One flat pool dict for the single-fleet engines: pool keys AND the
    embedded system names become ``<region>/<name>`` (system names must stay
    unique fleet-wide — dispatch maps systems back to pools by name)."""
    flat: Dict[str, PoolSpec] = {}
    seen = set()
    for reg in regions:
        if reg.name in seen:
            raise ValueError(f"duplicate region name {reg.name!r}")
        seen.add(reg.name)
        for pname, spec in reg.pools.items():
            flat[f"{reg.name}/{pname}"] = replace(
                spec, system=replace(spec.system,
                                     name=f"{reg.name}/{spec.system.name}"))
    return flat


class GlobalDispatcher(Scheduler):
    """Cross-region routing + temporal deferral over a flattened fleet.

    Interactive queries (``n <= defer_out_threshold``) run now on the
    globally cheapest system, where "cheap" is the region-local carbon cost
    of the query's energy (plus ``price_weight`` x its electricity cost).
    Batch-tier queries are deferred into the earliest green window across
    all regions — the window where some region's intensity first dips below
    ``defer_below`` x its own mean — and planned onto the best system of
    that window's region, wrapped in a ``DeferPlan`` so the engines hold
    admission (idle-inclusive fleet accounting still charges every pool's
    idle floor while the work waits).
    """

    def __init__(self, cfg: ModelConfig, regions: Sequence[Region], *,
                 defer_out_threshold: int = 256, defer_below: float = 0.85,
                 max_defer_s: float = 24 * 3600.0, price_weight: float = 0.0,
                 cp: CostParams = CostParams(),
                 model: Optional[CostModel] = None):
        self.regions = list(regions)
        flat = flatten_regions(self.regions)
        systems = [spec.system for spec in flat.values()]
        super().__init__(cfg, systems, cp, model=model)
        self._region_of: Dict[str, Region] = {}
        self._region_systems: Dict[str, List[SystemProfile]] = {}
        by_flat_name = {s.name: s for s in systems}
        for reg in self.regions:
            regional = [by_flat_name[f"{reg.name}/{spec.system.name}"]
                        for spec in reg.pools.values()]
            self._region_systems[reg.name] = regional
            for s in regional:
                self._region_of[s.name] = reg
        self.defer_out_threshold = defer_out_threshold
        self.defer_below = defer_below
        self.max_defer_s = max_defer_s
        self.price_weight = price_weight

    # ------------------------------------------------------------- scoring
    def _score(self, q: Query, s: SystemProfile, t_exec_s: float) -> float:
        """Region-local cost of running ``q`` on ``s`` at ``t_exec_s``:
        grams of CO2, optionally plus weighted electricity dollars."""
        reg = self._region_of[s.name]
        e_j = self.model.energy(q.m, q.n, s)
        score = reg.carbon.grams(e_j, t_exec_s)
        if self.price_weight:
            score += self.price_weight * (e_j / 3.6e6) \
                * reg.price.price(t_exec_s)
        return score

    def _deferrable(self, q: Query) -> bool:
        return q.n > self.defer_out_threshold

    def _green_windows(self, now: float) -> List[Tuple[float, Region]]:
        """Per-region ``(window_s, region)`` rows: the earliest green window
        each region opens after ``now``."""
        return [(next_green_window(reg.carbon, now, below=self.defer_below,
                                   max_defer_s=self.max_defer_s), reg)
                for reg in self.regions]

    # ------------------------------------------------------------ dispatch
    def choose(self, q: Query) -> SystemProfile:
        """Workload-only decision: run-now spatial argmin at the query's own
        arrival clock."""
        return min(self.systems,
                   key=lambda s: self._score(q, s, q.arrival_s))

    def dispatch(self, q: Query, fleet: Optional[FleetState] = None) -> Plan:
        now = fleet.time_s if fleet is not None else q.arrival_s
        if self._deferrable(q):
            # candidate = each region's best system at that region's own
            # green window; judged by actual execution-time score (hardware
            # joules x window intensity), NOT window intensity alone — a
            # dirtier grid with far more efficient hardware can still win.
            # Ties break toward the earlier window.
            best = None
            for w, reg in self._green_windows(now):
                s = min(self._region_systems[reg.name],
                        key=lambda x: self._score(q, x, w))
                key = (self._score(q, s, w), w)
                if best is None or key < best[0]:
                    best = (key, w, s)
            _, w, s = best
            inner = RunPlan(s.name, self._price_terms(q, s, wait_s=w - now))
            if w > now:
                return DeferPlan(until_s=w, inner=inner)
            return inner
        s = min(self.systems, key=lambda x: self._score(q, x, now))
        return RunPlan(s.name, self._price_terms(q, s))

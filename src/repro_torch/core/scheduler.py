"""Schedulers implementing the paper's Eq. 2 partition problem.

  * ThresholdScheduler — the paper's Section 6 heuristic: route by T_in/T_out.
  * CostOptimalScheduler — exact per-query argmin_s U(m,n,s); because Eq. 2's
    objective is separable per query (no capacity coupling), this IS the
    optimal partition for fixed lambda.
  * CapacityAwareScheduler — beyond-paper: accounts for instance counts and
    queueing: the cost of a pool includes the wait until an instance frees up,
    so bursts spill to the other pool instead of queueing indefinitely.
  * Baselines — workload-unaware policies the paper compares against.

Every scheduler prices queries through one ``CostModel`` (``core.pricing``):
pass ``model=`` to swap the perf oracle (analytic / table / calibrated) for
every policy at once; the default is the analytic oracle at the scheduler's
``CostParams``, which reproduces the historical free-function pricing
bit-for-bit.

Every scheduler exposes a uniform online API used by the discrete-event
fleet simulator (``core/fleet.py``), its vectorized twin, and the serving
router:

    dispatch(query, fleet_state) -> Plan       (core.plan IR)

``fleet_state`` is a ``FleetState`` snapshot (per-pool queue depths, busy
instances, estimated wait). Workload-only policies ignore it; queue-aware
policies price the wait in. ``dispatch`` returns a placement plan —
``RunPlan`` for a single pool, ``SplitPlan`` for a prefill/decode
disaggregation, ``DeferPlan`` for a delayed admission — carrying the priced
``PlanTerms`` behind the decision; callers settle it through
``core.settlement``. (Bare ``SystemProfile`` / tuple returns from external
subclasses are coerced there for one release behind a
``DeprecationWarning``.) ``dispatch`` is pure — stateful policies
(reservation heaps, round-robin counters) mutate only in ``observe``, which
callers invoke with the resolved plan after committing to it. The legacy
offline ``assign(queries)`` path is kept for the paper's static Section 6
accounting.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import DeferPlan, Plan, PlanTerms, RunPlan, SplitPlan
from repro_torch.core.pricing import AnalyticOracle, CostModel, CostParams
from repro_torch.core.systems import SystemProfile
from repro_torch.core.workload import Query


def _placed_pool_name(placed) -> Optional[str]:
    """First-leg pool (system name) of a committed placement, for ``observe``
    implementations. Accepts the plan IR and, one release behind, the legacy
    encodings (``SystemProfile`` or a profile pair)."""
    if isinstance(placed, DeferPlan):
        placed = placed.inner
    if isinstance(placed, SplitPlan):
        return placed.pool_prefill
    if isinstance(placed, RunPlan):
        return placed.pool
    if isinstance(placed, tuple) and placed:
        placed = placed[0]
    name = getattr(placed, "name", None)
    return name if isinstance(name, str) else None


@dataclass
class Assignment:
    query: Query
    system: SystemProfile
    energy_j: float
    runtime_s: float
    wait_s: float = 0.0


# ----------------------------------------------------------------- fleet state
def kv_blocks_needed(tokens: int, block_size: int) -> int:
    """ceil(tokens / block_size): worst-case KV blocks for a request whose
    total context is ``tokens``. ONE definition shared by the paged batcher
    (admission), the fleet simulator (capacity), and the schedulers
    (pricing) — these must stay bit-identical or admission desynchronizes
    from pricing."""
    return -(-tokens // block_size)


@dataclass(slots=True)
class PoolSnapshot:
    """Observable state of one pool at dispatch time."""
    system: SystemProfile
    instances: int = 1
    slots_per_instance: int = 1
    busy_slots: int = 0
    queue_len: int = 0
    est_wait_s: float = 0.0      # estimated queueing delay for a new arrival
    # KV-memory state (paged runtimes / block-capped simulator pools), in
    # PER-INSTANCE admission terms: ``free_blocks`` is the headroom of the
    # most-free single instance (a request lives on one instance, so
    # pool-aggregate free blocks overstate admissibility), ``total_blocks``
    # one instance's capacity. None / 0 means the pool reports no memory
    # constraint (slot-bound only), which keeps every pre-paging snapshot
    # producer valid unchanged.
    free_blocks: Optional[int] = None
    total_blocks: Optional[int] = None
    block_size: int = 0
    # Power-management state (energy-proportional fleets). ``awake_instances``
    # counts instances that are awake or already waking (provisioned
    # capacity); None means the pool reports no power management — every
    # instance is awake, which keeps pre-power snapshot producers valid
    # unchanged. ``wake_delay_s`` is the expected extra delay before NEW
    # capacity could serve an arrival (0 with a free awake slot); producers
    # fold it into ``est_wait_s`` as well, so queue-aware policies price a
    # cold pool honestly without double counting.
    awake_instances: Optional[int] = None
    asleep_instances: int = 0
    wake_delay_s: float = 0.0

    @property
    def total_slots(self) -> int:
        return self.instances * self.slots_per_instance

    @property
    def provisioned_instances(self) -> int:
        """Awake + waking instances; all of them absent power management."""
        return (self.awake_instances if self.awake_instances is not None
                else self.instances)

    @property
    def awake_slots(self) -> int:
        """Slot capacity that is provisioned right now (awake or waking)."""
        return self.provisioned_instances * self.slots_per_instance

    @property
    def free_slots(self) -> int:
        return max(0, self.total_slots - self.busy_slots)

    def blocks_needed(self, m: int, n: int) -> int:
        """Worst-case KV blocks for an (m, n) request; 0 if unconstrained."""
        if not self.block_size or not self.total_blocks:
            return 0
        return kv_blocks_needed(m + n, self.block_size)

    def mem_wait_s(self, m: int, n: int, runtime_s: float) -> float:
        """Extra admission delay from KV-memory pressure: when the request's
        worst-case blocks exceed the pool's free blocks, the deficit must
        drain from resident contexts first — approximated as the fraction of
        one service time proportional to the missing share of blocks."""
        needed = self.blocks_needed(m, n)
        if needed <= 0:
            return 0.0
        free = self.free_blocks or 0
        if needed <= free:
            return 0.0
        return runtime_s * (needed - free) / needed


@dataclass(slots=True)
class FleetState:
    """Snapshot handed to ``Scheduler.dispatch`` by the fleet simulator or
    the serving router. Maps pool/system name -> PoolSnapshot."""
    time_s: float = 0.0
    pools: Dict[str, PoolSnapshot] = field(default_factory=dict)

    def for_system(self, s: SystemProfile) -> Optional[PoolSnapshot]:
        for p in self.pools.values():
            if p.system.name == s.name:
                return p
        return None


class Scheduler:
    """Assigns each query to a system. Subclasses override ``choose``
    (workload-only decision) and optionally ``dispatch`` (queue-aware) and
    ``observe`` (post-commit state update)."""

    def __init__(self, cfg: ModelConfig, systems: Sequence[SystemProfile],
                 cp: CostParams = CostParams(), *,
                 model: Optional[CostModel] = None):
        self.cfg = cfg
        self.systems = list(systems)
        if model is not None and cp != CostParams() and cp != model.cp:
            raise ValueError(
                "conflicting pricing: both cp= and model= were given and "
                f"disagree ({cp} vs {model.cp}); build the model with the "
                "intended CostParams (model.with_params(cp))")
        self.model = model if model is not None \
            else CostModel(cfg, AnalyticOracle(), cp)
        self.cp = self.model.cp

    def choose(self, q: Query) -> SystemProfile:
        raise NotImplementedError

    def choose_batch(self, m, n) -> Optional[np.ndarray]:
        """Vectorized ``choose`` over aligned (m, n) token-count arrays:
        indices into ``self.systems``, elementwise identical to calling
        ``choose`` per query — or None when the policy has no batch path.

        Only meaningful for policies whose decision is (m, n)-only (both
        ``dispatch`` and ``observe`` are the base no-ops); the vectorized
        fleet engine uses it to precompute a whole workload's dispatch in
        one pass instead of snapshotting the fleet per arrival."""
        return None

    def _price_terms(self, q: Query, s: SystemProfile, *,
                     wait_s: float = 0.0,
                     cost: Optional[float] = None) -> PlanTerms:
        """Priced ``PlanTerms`` for running ``q`` on ``s`` (pure: reads the
        memoized ``CostModel`` only). Pass ``cost=`` when the Eq. 1 scalar
        was already computed during the candidate scan."""
        if cost is None:
            cost = self.model.cost(q.m, q.n, s, wait_s=wait_s)
        return PlanTerms(energy_j=self.model.energy(q.m, q.n, s),
                         runtime_s=self.model.runtime(q.m, q.n, s),
                         wait_s=wait_s, cost=cost)

    def dispatch(self, q: Query, fleet: Optional[FleetState] = None) -> Plan:
        """Online dispatch under identical queueing dynamics for every policy.
        Default: the workload-only ``choose`` rule, ignoring fleet state,
        wrapped in a priced ``RunPlan``. Must be side-effect free; state
        updates belong in ``observe``."""
        s = self.choose(q)
        return RunPlan(s.name, self._price_terms(q, s))

    def observe(self, q: Query, placed) -> None:
        """Commit hook: the caller settled ``q`` onto ``placed`` (a resolved
        ``Plan``; legacy callers may still pass a ``SystemProfile``).
        Stateful policies (reservation heaps, counters) update internal
        state here — never in ``choose``/``dispatch``."""

    def assign(self, queries: Sequence[Query]) -> List[Assignment]:
        out = []
        for q in queries:
            s = self.choose(q)
            self.observe(q, s)
            out.append(Assignment(q, s, self.model.energy(q.m, q.n, s),
                                  self.model.runtime(q.m, q.n, s)))
        return out


class ThresholdScheduler(Scheduler):
    """Paper Section 6: efficiency pool iff m <= T_in (axis='in'),
    n <= T_out (axis='out'), or both (axis='both')."""

    def __init__(self, cfg, eff: SystemProfile, perf: SystemProfile, *,
                 t_in: int = 32, t_out: int = 32, axis: str = "in",
                 cp: CostParams = CostParams(),
                 model: Optional[CostModel] = None):
        super().__init__(cfg, [eff, perf], cp, model=model)
        self.eff, self.perf = eff, perf
        self.t_in, self.t_out, self.axis = t_in, t_out, axis

    def choose(self, q: Query) -> SystemProfile:
        if self.axis == "in":
            small = q.m <= self.t_in
        elif self.axis == "out":
            small = q.n <= self.t_out
        else:
            small = q.m <= self.t_in and q.n <= self.t_out
        return self.eff if small else self.perf

    def choose_batch(self, m, n) -> np.ndarray:
        m = np.asarray(m)
        n = np.asarray(n)
        if self.axis == "in":
            small = m <= self.t_in
        elif self.axis == "out":
            small = n <= self.t_out
        else:
            small = (m <= self.t_in) & (n <= self.t_out)
        # systems == [eff, perf] (constructor order)
        return np.where(small, 0, 1)


class CostOptimalScheduler(Scheduler):
    """Per-query argmin_s U(m, n, s) — exact for the uncapacitated Eq. 2."""

    def choose(self, q: Query) -> SystemProfile:
        return min(self.systems,
                   key=lambda s: self.model.cost(q.m, q.n, s))

    def choose_batch(self, m, n) -> np.ndarray:
        # np.argmin keeps the first minimum, exactly like min() over the
        # systems list; cost_batch is elementwise bit-identical to cost()
        costs = np.stack([self.model.cost_batch(m, n, s)
                          for s in self.systems])
        return np.argmin(costs, axis=0)


@dataclass
class _Pool:
    system: SystemProfile
    free_at: List[float] = field(default_factory=list)   # heap of instance-free times


class CapacityAwareScheduler(Scheduler):
    """Beyond-paper: cost includes queueing delay given finite instance counts.

    Greedy event-driven assignment in arrival order: each pool keeps a heap of
    instance-free times; candidate cost = lam*E + (1-lam)*(wait + R).

    ``choose``/``dispatch`` are pure — they price the heap (or the fleet
    snapshot) read-only. The reservation itself happens in ``observe`` (or
    the offline ``reserve``/``assign`` path), so pricing with a snapshot and
    later falling back without one can no longer double-book instances.
    """

    def __init__(self, cfg, systems: Sequence[SystemProfile],
                 counts: Dict[str, int], cp: CostParams = CostParams(), *,
                 model: Optional[CostModel] = None):
        super().__init__(cfg, systems, cp, model=model)
        self.pools = {s.name: _Pool(s, [0.0] * counts.get(s.name, 1))
                      for s in systems}
        for p in self.pools.values():
            heapq.heapify(p.free_at)
        self._rid_cost: Dict[str, "np.ndarray"] = {}
        self._rid_runtime_s: Dict[str, "np.ndarray"] = {}
        self._rid_energy_j: Dict[str, "np.ndarray"] = {}

    def prepare_batch(self, m, n) -> None:
        """Precompute per-system wait-free cost, runtime, and energy tables
        over a whole workload's (m, n) arrays, enabling ``dispatch_rid``.
        Called by the vectorized fleet engine before its event loop."""
        for s in self.systems:
            self._rid_cost[s.name] = self.model.cost_batch(m, n, s)
            self._rid_runtime_s[s.name] = self.model.runtime_batch(m, n, s)
            self._rid_energy_j[s.name] = self.model.energy_batch(m, n, s)

    def dispatch_rid(self, rid: int, q: Query,
                     fleet: Optional[FleetState]) -> Plan:
        """Table-backed ``dispatch``: identical decision (the scalar path's
        ``cost(..., wait_s=w)`` equals the wait-free cost plus the wait term,
        in the same float association), with all per-query pricing read from
        the ``prepare_batch`` tables instead of the scalar memo."""
        if fleet is None:
            s = self.choose(q)
            return RunPlan(s.name, self._price_terms(q, s))
        cp = self.cp
        best, best_c, best_wait = None, float("inf"), 0.0
        for s in self.systems:
            snap = fleet.for_system(s)
            wait_s = snap.est_wait_s if snap is not None else 0.0
            if snap is not None:
                wait_s += snap.mem_wait_s(q.m, q.n,
                                          self._rid_runtime_s[s.name][rid])
            c = self._rid_cost[s.name][rid]
            if wait_s:
                c = c + (1.0 - cp.lam) * wait_s / cp.r_norm
            if c < best_c:
                best, best_c, best_wait = s, c, wait_s
        terms = PlanTerms(energy_j=float(self._rid_energy_j[best.name][rid]),
                          runtime_s=float(self._rid_runtime_s[best.name][rid]),
                          wait_s=best_wait, cost=float(best_c))
        return RunPlan(best.name, terms)

    def _price(self, q: Query) -> Tuple[_Pool, float, float, float]:
        """Pure pricing against the internal reservation heaps:
        (best pool, wait_s, runtime_s, energy_j). Does not mutate."""
        best, best_c, best_wait, best_r, best_e = \
            None, float("inf"), 0.0, 0.0, 0.0
        for p in self.pools.values():
            r = self.model.runtime(q.m, q.n, p.system)
            e = self.model.energy(q.m, q.n, p.system)
            wait = max(0.0, p.free_at[0] - q.arrival_s)
            c = self.model.cost(q.m, q.n, p.system, wait_s=wait)
            if c < best_c:
                best, best_c, best_wait, best_r, best_e = p, c, wait, r, e
        return best, best_wait, best_r, best_e

    def reserve(self, q: Query) -> Assignment:
        """Price AND book the chosen instance (offline assignment path)."""
        pool, wait, r, e = self._price(q)
        start = max(q.arrival_s, pool.free_at[0])
        heapq.heapreplace(pool.free_at, start + r)
        return Assignment(q, pool.system, e, r, wait)

    def choose(self, q: Query) -> SystemProfile:
        """Online single-query decision. Pure: see ``observe``."""
        return self._price(q)[0].system

    def observe(self, q: Query, placed) -> None:
        """Book the committed placement's earliest-free instance."""
        pool = self.pools.get(_placed_pool_name(placed))
        if pool is None:
            return
        start = max(q.arrival_s, pool.free_at[0])
        heapq.heapreplace(pool.free_at,
                          start + self.model.runtime(q.m, q.n, pool.system))

    def observe_rid(self, rid: int, q: Query, placed) -> None:
        """``observe`` with the booked runtime read from the ``prepare_batch``
        table (bit-identical to the scalar ``model.runtime``)."""
        pool = self.pools.get(_placed_pool_name(placed))
        if pool is None:
            return
        start = max(q.arrival_s, pool.free_at[0])
        heapq.heapreplace(pool.free_at,
                          start + self._rid_runtime_s[pool.system.name][rid])

    def dispatch(self, q: Query, fleet: Optional[FleetState] = None) -> Plan:
        """Queue-aware dispatch: price each pool's *observed* estimated wait
        (from the fleet snapshot) into the Eq. 1 cost, plus the KV-memory
        pressure term when the pool reports block occupancy — a pool with
        free slots but no free blocks is priced like a backed-up pool, so
        memory-bound pools shed load before head-of-line blocking builds.
        Power-managed pools are priced just as honestly: their snapshot's
        ``est_wait_s`` already folds in ``wake_delay_s`` (the latency of
        waking sleeping capacity), so a cold pool competes at its true
        time-to-first-token, not as if its sleeping instances were free.
        Without a snapshot the internal reservation heap is read (not
        written) for the wait."""
        if fleet is None:
            s = self.choose(q)
            return RunPlan(s.name, self._price_terms(q, s))
        best, best_c, best_wait = None, float("inf"), 0.0
        for s in self.systems:
            snap = fleet.for_system(s)
            wait = snap.est_wait_s if snap is not None else 0.0
            if snap is not None:
                wait += snap.mem_wait_s(q.m, q.n,
                                        self.model.runtime(q.m, q.n, s))
            c = self.model.cost(q.m, q.n, s, wait_s=wait)
            if c < best_c:
                best, best_c, best_wait = s, c, wait
        return RunPlan(best.name,
                       self._price_terms(q, best, wait_s=best_wait,
                                         cost=best_c))

    def assign(self, queries: Sequence[Query]) -> List[Assignment]:
        return [self.reserve(q)
                for q in sorted(queries, key=lambda q: q.arrival_s)]


class DisaggregatedScheduler(Scheduler):
    """Phase-split routing: prefill here, decode there, KV migrates between.

    The paper routes whole queries, but its own Fig 1a/2a phenomenology says
    the two phases have opposite hardware affinities — prefill is
    compute-bound, decode is memory-bound (arXiv 2407.04014, 2504.17674).
    This policy prices, per query, every single-pool assignment (identical
    pricing to ``CapacityAwareScheduler``) AND every ordered pool pair
    (a, b): prefill energy+runtime on ``a``, the priced KV-block migration
    (``CostModel.migration_terms``), decode energy+runtime on ``b``, and both
    queues' estimated waits. ``dispatch`` returns a ``RunPlan`` for a
    single-pool decision or a ``SplitPlan`` for a split — callers that
    support handoff (both fleet engines, the serving router) settle either
    through ``core.settlement``; ``choose``/``assign`` stay single-pool (a
    split is only priceable against queue state, and the offline path has
    none).

    Pairs are only considered when the query decodes (n > 0) and both
    endpoints advertise a positive ``link_bw_gbps``; zero-decode queries
    therefore never hand off. Candidates are scanned singles-first, then
    pairs in systems order, strict ``<`` — so ties go to the simpler
    single-pool plan, and the scan order is shared bit-for-bit with the
    table-backed ``dispatch_rid`` path the vectorized engine uses.
    """

    def __init__(self, cfg, systems: Sequence[SystemProfile],
                 cp: CostParams = CostParams(), *,
                 model: Optional[CostModel] = None):
        super().__init__(cfg, systems, cp, model=model)
        self._rid_cost: Dict[str, "np.ndarray"] = {}
        self._rid_runtime_s: Dict[str, "np.ndarray"] = {}
        self._rid_energy_j: Dict[str, "np.ndarray"] = {}
        self._rid_e_pf_j: Dict[str, "np.ndarray"] = {}
        self._rid_e_dec_j: Dict[str, "np.ndarray"] = {}
        self._rid_r_pf_s: Dict[str, "np.ndarray"] = {}
        self._rid_r_dec_s: Dict[str, "np.ndarray"] = {}

    def choose(self, q: Query) -> SystemProfile:
        """Workload-only fallback: best single system (no queue state, so no
        split — the migration trade is priced in ``dispatch``)."""
        return min(self.systems,
                   key=lambda s: self.model.cost(q.m, q.n, s))

    # ----------------------------------------------------------- scalar path
    def _pair_cost(self, e_pf_j: float, r_pf_s: float, e_dec_j: float,
                   r_dec_s: float, mig_s: float, mig_j: float,
                   wait_s: float) -> float:
        """Eq. 1 over a split plan. One shared float path: the event engine's
        scalar dispatch and the vectorized engine's table-backed
        ``dispatch_rid`` both come through here with the same operands."""
        cp = self.cp
        eterm = (e_pf_j + mig_j + e_dec_j) / cp.e_norm
        rterm = (r_pf_s + mig_s + r_dec_s) / cp.r_norm
        c = cp.lam * eterm + (1.0 - cp.lam) * rterm
        if wait_s:
            c = c + (1.0 - cp.lam) * wait_s / cp.r_norm
        return c

    def _pair_waits(self, q: Query, snap_a: Optional[PoolSnapshot],
                    snap_b: Optional[PoolSnapshot], r_pf_s: float,
                    r_dec_s: float) -> float:
        """Both queues' estimated waits for a split: the prefill pool is
        charged prefill-only block pressure (ceil(m/bs)); the decode pool the
        full-context pressure it will hold (ceil((m+n)/bs))."""
        wait_s = 0.0
        if snap_a is not None:
            wait_s += snap_a.est_wait_s
            wait_s += snap_a.mem_wait_s(q.m, 0, r_pf_s)
        if snap_b is not None:
            wait_s += snap_b.est_wait_s
            wait_s += snap_b.mem_wait_s(q.m, q.n, r_dec_s)
        return wait_s

    def _as_plan(self, q: Query, best, best_c: float, best_wait: float,
                 best_split) -> Plan:
        """Wrap the winning candidate of a dispatch scan: a ``SplitPlan``
        with the pair's priced components when a pair won, else a priced
        ``RunPlan``. Pure — called from ``dispatch``/``dispatch_rid``."""
        if best_split is not None:
            a, b = best
            nbytes, mig_s, mig_j, e_pf_j, r_pf_s, e_dec_j, r_dec_s = best_split
            terms = PlanTerms(energy_j=e_pf_j + mig_j + e_dec_j,
                              runtime_s=r_pf_s + mig_s + r_dec_s,
                              wait_s=best_wait, cost=best_c)
            return SplitPlan(a.name, b.name, mig_bytes=nbytes, terms=terms)
        return RunPlan(best.name,
                       self._price_terms(q, best, wait_s=best_wait,
                                         cost=best_c))

    def dispatch(self, q: Query, fleet: Optional[FleetState] = None) -> Plan:
        if fleet is None:
            s = self.choose(q)
            return RunPlan(s.name, self._price_terms(q, s))
        best, best_c, best_wait = None, float("inf"), 0.0
        best_split = None
        for s in self.systems:
            snap = fleet.for_system(s)
            wait_s = snap.est_wait_s if snap is not None else 0.0
            if snap is not None:
                wait_s += snap.mem_wait_s(q.m, q.n,
                                          self.model.runtime(q.m, q.n, s))
            c = self.model.cost(q.m, q.n, s, wait_s=wait_s)
            if c < best_c:
                best, best_c, best_wait = s, c, wait_s
        if q.n <= 0:
            return self._as_plan(q, best, best_c, best_wait, None)
        for a in self.systems:
            for b in self.systems:
                if a is b or min(a.link_bw_gbps, b.link_bw_gbps) <= 0.0:
                    continue
                snap_a = fleet.for_system(a)
                snap_b = fleet.for_system(b)
                e_pf_j, _ = self.model.split_energy(q.m, q.n, a)
                _, e_dec_j = self.model.split_energy(q.m, q.n, b)
                r_pf_s, _ = self.model.split_runtime(q.m, q.n, a)
                _, r_dec_s = self.model.split_runtime(q.m, q.n, b)
                bs = snap_a.block_size if snap_a is not None else 0
                nbytes, mig_s, mig_j = self.model.migration_terms(
                    q.m, a, b, block_size=bs)
                wait_s = self._pair_waits(q, snap_a, snap_b, r_pf_s, r_dec_s)
                c = self._pair_cost(e_pf_j, r_pf_s, e_dec_j, r_dec_s,
                                    mig_s, mig_j, wait_s)
                if c < best_c:
                    best, best_c, best_wait = (a, b), c, wait_s
                    best_split = (nbytes, mig_s, mig_j,
                                  e_pf_j, r_pf_s, e_dec_j, r_dec_s)
        return self._as_plan(q, best, best_c, best_wait, best_split)

    # ------------------------------------------------------ table-backed path
    def prepare_batch(self, m, n) -> None:
        """Precompute per-system cost/runtime and phase-split tables over the
        workload's (m, n) arrays (vectorized fleet engine)."""
        for s in self.systems:
            self._rid_cost[s.name] = self.model.cost_batch(m, n, s)
            self._rid_runtime_s[s.name] = self.model.runtime_batch(m, n, s)
            self._rid_energy_j[s.name] = self.model.energy_batch(m, n, s)
            e_pf_j, e_dec_j = self.model.split_energy_batch(m, n, s)
            r_pf_s, r_dec_s = self.model.split_runtime_batch(m, n, s)
            self._rid_e_pf_j[s.name] = e_pf_j
            self._rid_e_dec_j[s.name] = e_dec_j
            self._rid_r_pf_s[s.name] = r_pf_s
            self._rid_r_dec_s[s.name] = r_dec_s

    def dispatch_rid(self, rid: int, q: Query,
                     fleet: Optional[FleetState]) -> Plan:
        """``dispatch`` with every per-query price read from the
        ``prepare_batch`` tables (elementwise bit-identical to the scalar
        calls); the migration terms and the candidate scan are the same
        scalar code in the same order."""
        if fleet is None:
            s = self.choose(q)
            return RunPlan(s.name, self._price_terms(q, s))
        cp = self.cp
        best, best_c, best_wait = None, float("inf"), 0.0
        best_split = None
        for s in self.systems:
            snap = fleet.for_system(s)
            wait_s = snap.est_wait_s if snap is not None else 0.0
            if snap is not None:
                wait_s += snap.mem_wait_s(
                    q.m, q.n, float(self._rid_runtime_s[s.name][rid]))
            c = float(self._rid_cost[s.name][rid])
            if wait_s:
                c = c + (1.0 - cp.lam) * wait_s / cp.r_norm
            if c < best_c:
                best, best_c, best_wait = s, c, wait_s
        if q.n <= 0:
            return self._as_plan_rid(rid, q, best, best_c, best_wait, None)
        for a in self.systems:
            for b in self.systems:
                if a is b or min(a.link_bw_gbps, b.link_bw_gbps) <= 0.0:
                    continue
                snap_a = fleet.for_system(a)
                snap_b = fleet.for_system(b)
                e_pf_j = float(self._rid_e_pf_j[a.name][rid])
                e_dec_j = float(self._rid_e_dec_j[b.name][rid])
                r_pf_s = float(self._rid_r_pf_s[a.name][rid])
                r_dec_s = float(self._rid_r_dec_s[b.name][rid])
                bs = snap_a.block_size if snap_a is not None else 0
                nbytes, mig_s, mig_j = self.model.migration_terms(
                    q.m, a, b, block_size=bs)
                wait_s = self._pair_waits(q, snap_a, snap_b, r_pf_s, r_dec_s)
                c = self._pair_cost(e_pf_j, r_pf_s, e_dec_j, r_dec_s,
                                    mig_s, mig_j, wait_s)
                if c < best_c:
                    best, best_c, best_wait = (a, b), c, wait_s
                    best_split = (nbytes, mig_s, mig_j,
                                  e_pf_j, r_pf_s, e_dec_j, r_dec_s)
        return self._as_plan_rid(rid, q, best, best_c, best_wait, best_split)

    def _as_plan_rid(self, rid: int, q: Query, best, best_c: float,
                     best_wait: float, best_split) -> Plan:
        """``_as_plan`` with single-pool terms read from the ``prepare_batch``
        tables instead of the scalar memo. Pure."""
        if best_split is not None:
            return self._as_plan(q, best, best_c, best_wait, best_split)
        terms = PlanTerms(energy_j=float(self._rid_energy_j[best.name][rid]),
                          runtime_s=float(self._rid_runtime_s[best.name][rid]),
                          wait_s=best_wait, cost=best_c)
        return RunPlan(best.name, terms)


# ------------------------------------------------------------------ baselines
class SingleSystemScheduler(Scheduler):
    """Workload-unaware: everything on one system (paper's dashed lines)."""

    def __init__(self, cfg, system: SystemProfile, cp: CostParams = CostParams(),
                 *, model: Optional[CostModel] = None):
        super().__init__(cfg, [system], cp, model=model)
        self.system = system

    def choose(self, q: Query) -> SystemProfile:
        return self.system

    def choose_batch(self, m, n) -> np.ndarray:
        return np.zeros(len(np.asarray(m)), dtype=np.int64)


class RoundRobinScheduler(Scheduler):
    """Workload-unaware hybrid baseline: alternate pools ignoring (m, n)."""

    def __init__(self, cfg, systems: Sequence[SystemProfile],
                 cp: CostParams = CostParams(), *,
                 model: Optional[CostModel] = None):
        super().__init__(cfg, systems, cp, model=model)
        self._i = 0

    def choose(self, q: Query) -> SystemProfile:
        return self.systems[self._i % len(self.systems)]

    def observe(self, q: Query, placed) -> None:
        self._i += 1

"""Vectorized (struct-of-arrays) fleet-sim engine.

``core.fleet`` keeps the reference one-event-at-a-time loop with per-request
``RequestRecord``/``_Resident`` objects; this module is the same discrete-event
system with the hot state transposed into preallocated numpy arrays:

  * request state (arrival/start/decode/done times, token counts, KV blocks,
    energy) lives in rid-indexed arrays, priced ONCE per pool up front via
    ``CostModel.price_batch`` (Eq. 1 over arrays, bypassing the per-call
    LRU memo);
  * instance state (power-machine state, wake deadlines, linger clocks,
    busy slot-seconds, decode-group size) is one array per field per pool;
  * residents are compact per-instance slot rows, so pool-wide settlement
    (``_settle``) advances every busy instance in one batched numpy pass
    instead of a Python loop over instances and residents.

Event *semantics* are unchanged: the same heap orders the same epochs with
the same sequence numbers, FIFO/SJF queue keys, KV-block admission,
power-state transitions and autoscaler CONTROL ticks are transcribed
operation-for-operation, and every float expression keeps the reference
engine's operand order and association — so results are bit-for-bit equal
to ``FleetSimulator`` (the equivalence gate in tests/test_fleet_vec.py runs
both engines across seeds x disciplines x {autoscaler, paged blocks} and
asserts identical ``summary()`` dicts and per-request records).

Use via ``simulate_fleet(..., engine="vectorized")`` or the benchmarks'
``--engine`` flag. Speedup at fleet scale (1M requests, 1k instances) is
tracked in BENCH_fleet.json (benchmarks/fleet_bench.py).
"""
from __future__ import annotations

import heapq
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fleet import (ADMIT, ARRIVAL, AWAKE, CONTROL,
                                    INSTANCE, MIGRATE, OFF, ROLE_DEC,
                                    ROLE_FULL, ROLE_PF, SLEEP, WAKING,
                                    AutoscalerPolicy, FleetSimResult,
                                    PoolResult, PoolSpec)
from repro_torch.core.plan import Plan, RunPlan
from repro_torch.core.pricing import AnalyticOracle, CostModel
from repro_torch.core.scheduler import FleetState, PoolSnapshot, Scheduler
from repro_torch.core.settlement import (migration_charge, plan_legs,
                                         resolve_plan)
from repro_torch.core.workload import Query

# integer power-machine state codes (array-friendly); <= _WAKING means
# "provisioned" (awake_like in the reference engine)
_AWAKE, _WAKING, _SLEEP, _OFF = 0, 1, 2, 3
_STATE_NAME = {_AWAKE: AWAKE, _WAKING: WAKING, _SLEEP: SLEEP, _OFF: OFF}
_STATE_CODE = {v: k for k, v in _STATE_NAME.items()}

# sentinel for masked argmin over instance loads
_HUGE = np.iinfo(np.int64).max


class _VecPool:
    """Struct-of-arrays twin of ``fleet._PoolRuntime`` + its instances."""

    def __init__(self, idx: int, name: str, spec: PoolSpec):
        self.idx = idx
        self.name = name
        self.spec = spec
        self.power_managed = bool(np.isfinite(spec.linger_s))
        self.linger_s = float(spec.linger_s)
        self.linger_finite = math.isfinite(self.linger_s)
        self.target_awake: Optional[int] = None
        n_inst, slots = spec.instances, spec.slots
        self.n_inst = n_inst
        self.slots = slots
        # ---- per-instance arrays ----
        self.state = np.zeros(n_inst, np.int8)           # all start AWAKE
        self.wake_done_s = np.zeros(n_inst)
        self.empty_since_s = np.zeros(n_inst)
        self.last_t_s = np.zeros(n_inst)
        self.busy_slot_s = np.zeros(n_inst)
        self.version = [0] * n_inst        # Python ints: hot scalar reads
        self.n_res = np.zeros(n_inst, np.int64)
        self.blocks_in_use = np.zeros(n_inst, np.int64)
        self.wake_energy_j = np.zeros(n_inst)
        self.n_wakes = np.zeros(n_inst, np.int64)
        self.b_cached = np.zeros(n_inst, np.int64)       # decode group at refresh
        self.timeline: List[List[Tuple[float, str]]] = \
            [[(0.0, AWAKE)] for _ in range(n_inst)]
        # ---- per-resident slot rows (compact: columns 0..n_res-1 in use) ----
        self.r_rid = np.full((n_inst, slots), -1, np.int64)
        self.r_rem = np.zeros((n_inst, slots))           # remaining out tokens
        self.r_pf_end_s = np.zeros((n_inst, slots))      # prefill-done epoch
        self.r_t_tok = np.zeros((n_inst, slots))         # s/token at r_b
        self.r_p_w = np.zeros((n_inst, slots))           # decode power at r_b
        self.r_b = np.zeros((n_inst, slots), np.int64)   # occupancy of cache
        self.r_blocks = np.zeros((n_inst, slots), np.int64)
        self.r_role = np.zeros((n_inst, slots), np.int8)  # ROLE_FULL/_PF/_DEC
        # ---- queue + counters ----
        # (key, seq, rid, svc, role)
        self.queue: List[Tuple[float, int, int, float, int]] = []
        self.queued_service_s = 0.0
        self.busy = 0                                    # total residents
        # O(1) power-state census, maintained at every transition; residents
        # only ever live on AWAKE instances, so the pool's free awake slots
        # are ``n_awake * slots - busy`` without scanning the state array
        self.n_awake = n_inst
        self.n_waking = 0
        self.result = PoolResult()
        # ---- rid-indexed precomputed pricing (price_batch, filled in run) ----
        self.svc_s: Optional[np.ndarray] = None          # batch=1 runtime
        self.pf_s: Optional[np.ndarray] = None           # t_prefill
        self.ov_s: Optional[np.ndarray] = None           # t_overhead
        self.dec_s: Optional[np.ndarray] = None          # t_decode (DEC svc)
        self.svc_pf_s: Optional[np.ndarray] = None       # overhead + prefill
        self.prefill_power_w: Optional[np.ndarray] = None
        self.blocks_need: Optional[np.ndarray] = None
        self.blocks_need_pf: Optional[np.ndarray] = None  # prefill-only need
        # lazy per-occupancy decode tables: batch size b -> rid-indexed
        # (seconds/token, decode utilization) arrays, one price_batch per b
        self.t_tok_by_b: Dict[int, np.ndarray] = {}
        self.p_w_by_b: Dict[int, np.ndarray] = {}


class VectorizedFleetSimulator:
    """Drop-in, bit-for-bit equivalent of ``fleet.FleetSimulator`` with
    numpy-batched event settlement. Same constructor contract; single-shot."""

    def __init__(self, cfg: ModelConfig, pools: Dict[str, PoolSpec],
                 scheduler: Scheduler, *, queue_discipline: str = "fifo",
                 model: Optional[CostModel] = None,
                 autoscaler: Union[AutoscalerPolicy,
                                   Dict[str, AutoscalerPolicy], None] = None):
        if queue_discipline not in ("fifo", "sjf"):
            raise ValueError(f"unknown queue discipline {queue_discipline!r}")
        self.cfg = cfg
        self.model = model if model is not None \
            else getattr(scheduler, "model", None) or CostModel(cfg, AnalyticOracle())
        self.pools: Dict[str, _VecPool] = {
            n: _VecPool(i, n, spec) for i, (n, spec) in enumerate(pools.items())}
        self._pool_list = list(self.pools.values())
        if autoscaler is None:
            self._autoscalers: Dict[str, AutoscalerPolicy] = {}
        elif isinstance(autoscaler, dict):
            unknown = set(autoscaler) - set(pools)
            if unknown:
                raise KeyError(f"autoscaler for unknown pool(s) {sorted(unknown)}")
            self._autoscalers = dict(autoscaler)
        else:
            self._autoscalers = {n: autoscaler for n in pools}
        for name in self._autoscalers:
            self.pools[name].power_managed = True
        self.scheduler = scheduler
        self.queue_discipline = queue_discipline
        self._by_system = {spec.system.name: n for n, spec in pools.items()}
        if len(self._by_system) != len(pools):
            raise ValueError("pools must use distinct SystemProfile names: "
                             "dispatch maps a chosen system back to its pool "
                             "by name")
        self._ran = False
        self.events_processed = 0    # heap pops + arrivals (incl. stale events)

    # ------------------------------------------------------------------ run
    def run(self, queries: Sequence[Query],
            policy_name: Optional[str] = None) -> FleetSimResult:
        if self._ran:
            raise RuntimeError("VectorizedFleetSimulator is single-shot "
                               "(instances hold clock state); build a new "
                               "one per run")
        self._ran = True
        qs = sorted(queries, key=lambda q: q.arrival_s)
        n_req = len(qs)
        self._queries = qs
        self.m_tok = np.fromiter((q.m for q in qs), np.int64, n_req)
        self.n_tok = np.fromiter((q.n for q in qs), np.int64, n_req)
        arrival_s = np.fromiter((q.arrival_s for q in qs), np.float64, n_req)
        self.t_arrival_s = arrival_s
        self.t_start_s = np.zeros(n_req)
        self.t_decode_s = np.zeros(n_req)
        self.t_done_s = np.zeros(n_req)
        self.energy_j = np.zeros(n_req)
        self.pool_code = np.full(n_req, -1, np.int16)
        self.pool2_code = np.full(n_req, -1, np.int16)   # decode pool (split)
        self.mig_bytes = np.zeros(n_req)
        self._n_tok_f = self.n_tok.astype(np.float64)

        # ---- batched pricing: one price_batch per pool over every rid ----
        for pool in self._pool_list:
            self._precompute_pool(pool, n_req)

        # ---- batched dispatch for (m, n)-only policies ----
        # When the policy neither reads fleet state (base dispatch) nor
        # keeps per-commit state (base observe), its choices are a pure
        # function of (m, n): precompute them all in one choose_batch pass
        # and skip the per-arrival FleetState snapshot entirely. Snapshots
        # are pure, so skipping them is unobservable — results stay
        # bit-for-bit those of the event engine.
        sched = self.scheduler
        self._base_dispatch = type(sched).dispatch is Scheduler.dispatch
        self._pre_pool: Optional[np.ndarray] = None
        if (self._base_dispatch and n_req
                and type(sched).observe is Scheduler.observe):
            sys_idx = sched.choose_batch(self.m_tok, self.n_tok)
            if sys_idx is not None:
                pool_of_sys = np.array(
                    [self.pools[name].idx if name is not None else -1
                     for name in (self._by_system.get(s.name)
                                  for s in sched.systems)])
                pre = pool_of_sys[sys_idx]
                # a choice mapping to no pool must raise at the same arrival
                # the event engine raises at: leave it to the scalar path
                if not (pre < 0).any():
                    self._pre_pool = pre

        # Fleet-aware policies that expose table-backed dispatch (e.g.
        # CapacityAware) price every rid once up front; per-arrival work
        # drops to table reads plus the queue-state terms.
        self._rid_dispatch = self._rid_observe = None
        if (not self._base_dispatch and n_req
                and callable(getattr(sched, "prepare_batch", None))
                and callable(getattr(sched, "dispatch_rid", None))):
            sched.prepare_batch(self.m_tok, self.n_tok)
            self._rid_dispatch = sched.dispatch_rid
            self._rid_observe = getattr(sched, "observe_rid", None)

        # arrivals are pre-sorted and merged against the heap instead of
        # being pushed individually; they own sequence numbers 0..n_req-1
        # conceptually, so the counter starts at n_req and an arrival wins
        # every same-epoch tie (exactly the reference heap order)
        seq = itertools.count(n_req)
        events: List[Tuple[float, int, int, object]] = []
        self._next_idx = 0
        self._n_req = n_req
        self._horizon_s = 0.0

        for pool in self._pool_list:
            if pool.power_managed and np.isfinite(pool.spec.linger_s):
                for i in range(pool.n_inst):
                    self._reschedule(pool, i, 0.0, events, seq)
        for name, policy in self._autoscalers.items():
            heapq.heappush(events, (policy.period_s, next(seq), CONTROL, name))

        arrivals = arrival_s.tolist()      # Python floats: faster merge loop
        while events or self._next_idx < n_req:
            if self._next_idx < n_req and (
                    not events or arrivals[self._next_idx] <= events[0][0]):
                rid = self._next_idx
                self._next_idx += 1
                self.events_processed += 1
                self._arrival(rid, arrivals[rid], events, seq)
                continue
            t, _, kind, payload = heapq.heappop(events)
            self.events_processed += 1
            if kind == INSTANCE:
                pool, i, version = payload
                if version != pool.version[i]:
                    continue                             # stale event
                # a WAKING instance holds no residents, so finishing the
                # wake before the (no-op) advance+complete is order-neutral
                if pool.n_waking and pool.state[i] == _WAKING \
                        and t >= pool.wake_done_s[i] - 1e-12:
                    self._finish_wake(pool, i, t)
                self._advance_complete_row(pool, i, t, events, seq)
                if pool.queue:
                    self._refill(pool, t, events, seq)
                if pool.power_managed:
                    self._maybe_descend(pool, i, t)
                self._reschedule(pool, i, t, events, seq)
            elif kind == MIGRATE:                        # KV handoff landed
                rid = payload
                pool = self._pool_list[self.pool2_code[rid]]
                svc_s = float(pool.dec_s[rid])
                key = svc_s if self.queue_discipline == "sjf" else t
                heapq.heappush(pool.queue,
                               (key, next(seq), rid, svc_s, ROLE_DEC))
                pool.queued_service_s += svc_s
                self._refill(pool, t, events, seq)
            elif kind == ADMIT:                          # DeferPlan clock
                pool, rid, svc_s, role = payload
                key = svc_s if self.queue_discipline == "sjf" else t
                heapq.heappush(pool.queue, (key, next(seq), rid, svc_s, role))
                pool.queued_service_s += svc_s
                self._refill(pool, t, events, seq)
            else:                                        # CONTROL tick
                self._control(self.pools[payload], t, events, seq)

        return self._finalize(policy_name or type(self.scheduler).__name__)

    # ------------------------------------------------------------ precompute
    def _precompute_pool(self, pool: _VecPool, n_req: int) -> None:
        spec = pool.spec
        s = spec.system
        if n_req == 0:
            zero = np.zeros(0)
            pool.svc_s = pool.pf_s = pool.ov_s = pool.prefill_power_w = zero
            pool.dec_s = pool.svc_pf_s = zero
            pool.blocks_need = np.zeros(0, np.int64)
            pool.blocks_need_pf = np.zeros(0, np.int64)
            return
        ph = self.model.price_batch(self.m_tok, self.n_tok, s, batch=1)
        pool.pf_s = ph.t_prefill
        pool.ov_s = ph.t_overhead
        pool.svc_s = (ph.t_prefill + ph.t_decode) + ph.t_overhead
        # split-phase service times, associated exactly as the scalar
        # CostModel.split_runtime the event engine prices queue entries with
        pool.dec_s = ph.t_decode
        pool.svc_pf_s = ph.t_overhead + ph.t_prefill
        # blended overhead+prefill power (same expression as _Instance.advance)
        u = np.minimum(np.maximum(ph.util_prefill, 0.0), 1.0)
        p_pf_w = s.chips * (s.power_idle_w
                            + (s.power_peak_w - s.power_idle_w) * u)
        t_total_s = ph.t_overhead + ph.t_prefill
        pool.prefill_power_w = (
            (ph.t_overhead * s.power(0.0) + ph.t_prefill * p_pf_w)
            / np.maximum(t_total_s, 1e-12))
        if spec.kv_blocks:
            tokens = self.m_tok + self.n_tok
            pool.blocks_need = -(-tokens // spec.block_size)
            pool.blocks_need_pf = -(-self.m_tok // spec.block_size)
        else:
            pool.blocks_need = np.zeros(n_req, np.int64)
            pool.blocks_need_pf = np.zeros(n_req, np.int64)

    # --------------------------------------------------------------- arrival
    def _arrival(self, rid: int, t: float, events, seq) -> None:
        q = self._queries[rid]
        if self._pre_pool is not None:
            # precomputed (m, n)-only decision: pool known without a plan
            # object (the choose_batch fast path is run-now, single-pool)
            pool = self._pool_list[self._pre_pool[rid]]
            dst, role, until_s = None, ROLE_FULL, 0.0
        else:
            plan = self._plan(q, rid, t)
            pool_sys, dec_sys, role, until_s = plan_legs(plan, q)
            pool = self.pools[self._by_system[pool_sys]]
            dst = (self.pools[self._by_system[dec_sys]]
                   if dec_sys is not None else None)
        if dst is not None:                      # split: prefill here...
            self._check_admissible(pool, int(pool.blocks_need_pf[rid]), q)
            self._check_admissible(dst, int(dst.blocks_need[rid]), q)
            self.pool2_code[rid] = dst.idx
            svc_s = float(pool.svc_pf_s[rid])
        else:
            self._check_admissible(pool, int(pool.blocks_need[rid]), q)
            svc_s = float(pool.svc_s[rid])
        self.pool_code[rid] = pool.idx
        pool.result.queries += 1
        if until_s > t:                          # deferred admission
            heapq.heappush(events, (until_s, next(seq), ADMIT,
                                    (pool, rid, svc_s, role)))
            return
        key = svc_s if self.queue_discipline == "sjf" else t
        heapq.heappush(pool.queue, (key, next(seq), rid, svc_s, role))
        pool.queued_service_s += svc_s
        self._refill(pool, t, events, seq)

    @staticmethod
    def _check_admissible(pool: _VecPool, need: int, q: Query) -> None:
        if need > pool.spec.kv_blocks > 0:
            raise ValueError(
                f"query (m={q.m}, n={q.n}) needs {need} KV blocks but "
                f"pool {pool.name!r} instances hold only "
                f"{pool.spec.kv_blocks}: it can never be admitted")

    def _fleet_state(self, now: float) -> FleetState:
        return FleetState(time_s=now,
                          pools={p.name: self._snapshot(p, now)
                                 for p in self._pool_list})

    def _plan(self, q: Query, rid: int, now: float) -> Plan:
        """Twin of ``fleet.FleetSimulator._dispatch``: same settlement seam
        (``resolve_plan`` + ``observe``), with the engine's fast paths in
        front — a base-dispatch policy's ``choose`` skips the (pure,
        unobserved) snapshot and wraps directly into a ``RunPlan``; a
        table-backed policy dispatches through ``dispatch_rid``."""
        if self._base_dispatch:
            raw: object = RunPlan(self.scheduler.choose(q).name)
        elif self._rid_dispatch is not None:
            raw = self._rid_dispatch(rid, q, self._fleet_state(now))
        else:
            raw = self.scheduler.dispatch(q, self._fleet_state(now))
        plan = resolve_plan(raw, q, self._by_system)
        if self._rid_observe is not None:
            self._rid_observe(rid, q, plan)
        else:
            self.scheduler.observe(q, plan)
        return plan

    # ------------------------------------------------------------- snapshots
    def _snapshot(self, pool: _VecPool, now: float) -> PoolSnapshot:
        spec = pool.spec
        kv = spec.kv_blocks
        n_prov = pool.n_awake + pool.n_waking
        free_awake = pool.n_awake * spec.slots - pool.busy
        wake_delay_s = self._wake_delay(pool, now, free_awake)
        return PoolSnapshot(
            system=spec.system,
            instances=spec.instances,
            slots_per_instance=spec.slots,
            busy_slots=pool.busy,
            queue_len=len(pool.queue),
            est_wait_s=self._est_wait(pool, now, n_prov, free_awake,
                                      wake_delay_s),
            free_blocks=int(kv - pool.blocks_in_use.min()) if kv else None,
            total_blocks=kv if kv else None,
            block_size=spec.block_size if kv else 0,
            awake_instances=n_prov,
            asleep_instances=spec.instances - n_prov,
            wake_delay_s=wake_delay_s,
        )

    def _wake_delay(self, pool: _VecPool, now: float,
                    free_awake: int) -> float:
        if free_awake > 0:
            return 0.0
        st = pool.state
        cands: List[float] = []
        if pool.n_waking:
            waking = st == _WAKING
            cands.append(float(np.maximum(
                0.0, pool.wake_done_s[waking] - now).min()))
        if pool.n_inst - pool.n_awake - pool.n_waking:
            table = pool.spec.system.states()
            if (st == _SLEEP).any():
                cands.append(table.state(SLEEP).wake_s)
            if (st == _OFF).any():
                cands.append(table.state(OFF).wake_s)
        return min(cands) if cands else 0.0

    def _est_wait(self, pool: _VecPool, now: float,
                  n_prov: int, free_awake: int, wake_delay_s: float) -> float:
        total_slots = n_prov * pool.spec.slots
        backlog_s = pool.queued_service_s / max(1, total_slots)
        if free_awake > 0:
            return backlog_s
        nxt = self._next_event_times(pool, now)
        cand = nxt[pool.state <= _WAKING]
        cand = cand[np.isfinite(cand)]
        vals = cand.tolist()
        if wake_delay_s > 0:
            vals.append(now + wake_delay_s)
        next_free_s = (min(vals) - now) if vals else 0.0
        return max(0.0, next_free_s) + backlog_s

    def _next_event_times(self, pool: _VecPool, now: float) -> np.ndarray:
        """Per-instance ``next_event_time`` (inf = none), with the decode
        group recomputed at ``now`` — an arrival landing exactly on a
        resident's prefill_end sees it decoding before the instance's own
        crossing event runs, so stale cached per-token times are fixed up
        (into temporaries: the caches stay keyed to each instance's last
        settle epoch, which pending advances still need)."""
        out = np.full(pool.n_inst, np.inf)
        st = pool.state
        waking = st == _WAKING
        out[waking] = pool.wake_done_s[waking]
        awake = st == _AWAKE
        empty = awake & (pool.n_res == 0)
        if pool.power_managed and np.isfinite(pool.spec.linger_s) and empty.any():
            out[empty] = pool.empty_since_s[empty] + pool.spec.linger_s
        busy_idx = np.where(awake & (pool.n_res > 0))[0]
        if len(busy_idx) == 0:
            return out
        pf = pool.r_pf_end_s[busy_idx]
        valid = np.arange(pool.slots) < pool.n_res[busy_idx, None]
        dec = valid & (pf <= now + 1e-12)
        b_now = dec.sum(1)
        t_tok = pool.r_t_tok[busy_idx]
        stale = np.where(b_now != pool.b_cached[busy_idx])[0]
        if len(stale):
            t_tok = t_tok.copy()
            for j in stale:
                ks = dec[j]
                t_tab, _ = self._decode_table(pool, int(b_now[j]))
                t_tok[j, ks] = t_tab[pool.r_rid[busy_idx[j], ks]]
        cand = np.where(dec, now + pool.r_rem[busy_idx] * t_tok,
                        np.where(valid, pf, np.inf))
        out[busy_idx] = cand.min(1)
        return out

    def _decode_table(self, pool: _VecPool,
                      b: int) -> Tuple[np.ndarray, np.ndarray]:
        """rid-indexed (s/token, decode power W) at occupancy ``b`` — the
        pool analogue of ``_Resident.tok_time_util``'s per-b memo, computed
        for every rid in one ``price_batch`` pass the first time ``b``
        occurs. Power is pre-applied (``s.power(util)`` elementwise) so the
        settle loops never call the scalar ``power``."""
        t_tab = pool.t_tok_by_b.get(b)
        if t_tab is None:
            s = pool.spec.system
            ph = self.model.price_batch(self.m_tok, self.n_tok, s, batch=b)
            t_tab = ph.t_decode / np.maximum(1, self.n_tok)
            u = np.minimum(np.maximum(ph.util_decode, 0.0), 1.0)
            pool.t_tok_by_b[b] = t_tab
            pool.p_w_by_b[b] = s.chips * (
                s.power_idle_w + (s.power_peak_w - s.power_idle_w) * u)
        return t_tab, pool.p_w_by_b[b]

    # ------------------------------------------------------------ settlement
    def _advance_row(self, pool: _VecPool, i: int, now: float) -> None:
        """Scalar-row twin of ``_Instance.advance`` (one instance). Row
        slices are pulled into Python lists once: per-element float math on
        lists is several times faster than repeated numpy scalar indexing
        and bitwise identical (``tolist`` round-trips float64 exactly)."""
        t0 = float(pool.last_t_s[i])
        dt = now - t0
        pool.last_t_s[i] = now
        nr = int(pool.n_res[i])
        if dt <= 0 or nr == 0:
            return
        pool.busy_slot_s[i] += nr * dt
        thr = t0 + 1e-12
        pf = pool.r_pf_end_s[i, :nr].tolist()
        dec_ks = [k for k in range(nr) if pf[k] <= thr]
        b = len(dec_ks)
        if b:
            rids = pool.r_rid[i, :nr].tolist()
            t_toks = pool.r_t_tok[i, :nr].tolist()
            rems = pool.r_rem[i, :nr].tolist()
            # math.ulp == np.spacing for positive finite floats
            snap_eps = 4.0 * math.ulp(max(now, 1.0))
            energy_j = self.energy_j
            stale = [k for k in dec_ks if pool.r_b[i, k] != b]
            if stale:
                t_tab, p_tab = self._decode_table(pool, b)
                for k in stale:
                    rid = rids[k]
                    t_toks[k] = float(t_tab[rid])
                    pool.r_t_tok[i, k] = t_toks[k]
                    pool.r_p_w[i, k] = p_tab[rid]
                    pool.r_b[i, k] = b
            p_ws = pool.r_p_w[i, :nr].tolist()
            for k in dec_ks:
                t_tok = t_toks[k]
                rem = rems[k]
                steps = dt / t_tok if t_tok > 0 else rem
                steps = min(steps, rem)
                rem -= steps
                energy_j[rids[k]] += steps * t_tok * p_ws[k] / b
                if rem * t_tok <= snap_eps:
                    rem = 0.0
                pool.r_rem[i, k] = rem
        if b < nr:
            energy_j = self.energy_j
            prefill_power_w = pool.prefill_power_w
            for k in range(nr):
                if pf[k] > thr:                     # overhead+prefill phase
                    span = min(now, pf[k]) - t0
                    if span > 0:
                        rid = int(pool.r_rid[i, k])
                        inc_j = span * prefill_power_w[rid]
                        # target is the rid-indexed energy_j array
                        energy_j[rid] += inc_j  # repro-lint: allow[unit-derived-name]

    def _advance_batch(self, pool: _VecPool, idx: np.ndarray,
                       now: float) -> None:
        """Batched ``advance`` over many instances at once (same elementwise
        float ops as ``_advance_row``; each rid receives at most one decode
        and one prefill increment per settle, so scatter order is moot)."""
        t0 = pool.last_t_s[idx].copy()
        pool.last_t_s[idx] = now
        act = (now - t0 > 0) & (pool.n_res[idx] > 0)
        idx, t0 = idx[act], t0[act]
        if len(idx) == 0:
            return
        dt = now - t0
        pool.busy_slot_s[idx] += pool.n_res[idx] * dt
        valid = np.arange(pool.slots) < pool.n_res[idx, None]
        pf = pool.r_pf_end_s[idx]
        dec = valid & (pf <= t0[:, None] + 1e-12)
        b = dec.sum(1)
        t_tok = pool.r_t_tok[idx]
        p_w = pool.r_p_w[idx]
        rids = pool.r_rid[idx]
        stale = dec & (pool.r_b[idx] != b[:, None])
        if stale.any():
            rb = pool.r_b[idx]
            for bb in np.unique(b[stale.any(1)]):
                sel = stale & (b[:, None] == bb)
                t_tab, p_tab = self._decode_table(pool, int(bb))
                t_tok[sel] = t_tab[rids[sel]]
                p_w[sel] = p_tab[rids[sel]]
                rb[sel] = bb
            pool.r_t_tok[idx] = t_tok
            pool.r_p_w[idx] = p_w
            pool.r_b[idx] = rb
        rem = pool.r_rem[idx]
        pos = dec & (t_tok > 0)
        steps = np.where(dec, rem, 0.0)             # t_tok == 0 -> rem
        np.divide(np.broadcast_to(dt[:, None], steps.shape), t_tok,
                  out=steps, where=pos)
        steps = np.minimum(steps, rem)
        new_rem = rem - steps
        with np.errstate(invalid="ignore"):
            inc_j = steps * t_tok * p_w / b[:, None]
        np.add.at(self.energy_j, rids[dec], inc_j[dec])
        snap_eps = 4.0 * np.spacing(max(now, 1.0))
        new_rem = np.where(dec & (new_rem * t_tok <= snap_eps), 0.0, new_rem)
        pool.r_rem[idx] = np.where(dec, new_rem, rem)
        pre = valid & ~dec
        if pre.any():
            span = np.minimum(now, pf) - t0[:, None]
            hot = pre & (span > 0)
            if hot.any():
                inc_pf_j = span[hot] * pool.prefill_power_w[rids[hot]]
                np.add.at(self.energy_j, rids[hot], inc_pf_j)

    def _advance_complete_row(self, pool: _VecPool, i: int, now: float,
                              events, seq) -> bool:
        """``_advance_row`` followed by ``_complete_row``, sharing one read
        of the resident rows (the hot per-event path; same float ops)."""
        t0 = float(pool.last_t_s[i])
        dt = now - t0
        pool.last_t_s[i] = now
        nr = int(pool.n_res[i])
        if nr == 0:
            return False
        pf = pool.r_pf_end_s[i, :nr].tolist()
        rems = pool.r_rem[i, :nr].tolist()
        if dt > 0:
            pool.busy_slot_s[i] += nr * dt
            thr0 = t0 + 1e-12
            dec_ks = [k for k in range(nr) if pf[k] <= thr0]
            b = len(dec_ks)
            if b:
                rids = pool.r_rid[i, :nr].tolist()
                t_toks = pool.r_t_tok[i, :nr].tolist()
                rbs = pool.r_b[i, :nr].tolist()
                p_ws = pool.r_p_w[i, :nr].tolist()
                snap_eps = 4.0 * math.ulp(max(now, 1.0))
                energy_j = self.energy_j
                stale = [k for k in dec_ks if rbs[k] != b]
                if stale:
                    t_tab, p_tab = self._decode_table(pool, b)
                    for k in stale:
                        rid = rids[k]
                        t_toks[k] = float(t_tab[rid])
                        p_ws[k] = float(p_tab[rid])
                        rbs[k] = b
                    pool.r_t_tok[i, :nr] = t_toks
                    pool.r_p_w[i, :nr] = p_ws
                    pool.r_b[i, :nr] = rbs
                for k in dec_ks:
                    t_tok = t_toks[k]
                    rem = rems[k]
                    steps = dt / t_tok if t_tok > 0 else rem
                    steps = min(steps, rem)
                    rem -= steps
                    energy_j[rids[k]] += steps * t_tok * p_ws[k] / b
                    if rem * t_tok <= snap_eps:
                        rem = 0.0
                    rems[k] = rem
                pool.r_rem[i, :nr] = rems
            if b < nr:
                energy_j = self.energy_j
                prefill_power_w = pool.prefill_power_w
                for k in range(nr):
                    if pf[k] > thr0:                # overhead+prefill phase
                        span = min(now, pf[k]) - t0
                        if span > 0:
                            rid = int(pool.r_rid[i, k])
                            inc_j = span * prefill_power_w[rid]
                            # target is the rid-indexed energy_j array
                            energy_j[rid] += inc_j  # repro-lint: allow[unit-derived-name]
        thr = now + 1e-12
        done = [k for k in range(nr)
                if rems[k] <= 1e-6 and pf[k] <= thr]
        if not done:
            return False
        self._pop_done(pool, i, nr, done, now, events, seq)
        return True

    def _complete_row(self, pool: _VecPool, i: int, now: float,
                      events, seq) -> bool:
        """``pop_finished`` + ``_complete`` for one instance; True if any
        resident finished (slots/blocks freed)."""
        nr = int(pool.n_res[i])
        if nr == 0:
            return False
        rem = pool.r_rem[i, :nr].tolist()
        pf = pool.r_pf_end_s[i, :nr].tolist()
        thr = now + 1e-12
        done = [k for k in range(nr)
                if rem[k] <= 1e-6 and pf[k] <= thr]
        if not done:
            return False
        self._pop_done(pool, i, nr, done, now, events, seq)
        return True

    def _pop_done(self, pool: _VecPool, i: int, nr: int, done: List[int],
                  now: float, events, seq) -> None:
        """Finish the ``done`` slots of one instance row and compact it —
        the shared tail of both completion paths (reference: the ``done``
        loop in ``fleet.FleetSimulator._complete`` + ``pop_finished``'s
        removal). Prefill-only residents hand off instead of finishing."""
        for k in done:
            rid = int(pool.r_rid[i, k])
            if pool.r_role[i, k] == ROLE_PF:
                self._handoff(rid, pool, now, events, seq)
            else:
                self.t_done_s[rid] = now
                self._horizon_s = max(self._horizon_s, now)
            pool.blocks_in_use[i] -= pool.r_blocks[i, k]
        keep = [k for k in range(nr) if k not in done]
        for dst, src in enumerate(keep):
            if dst != src:
                pool.r_rid[i, dst] = pool.r_rid[i, src]
                pool.r_rem[i, dst] = pool.r_rem[i, src]
                pool.r_pf_end_s[i, dst] = pool.r_pf_end_s[i, src]
                pool.r_t_tok[i, dst] = pool.r_t_tok[i, src]
                pool.r_p_w[i, dst] = pool.r_p_w[i, src]
                pool.r_b[i, dst] = pool.r_b[i, src]
                pool.r_blocks[i, dst] = pool.r_blocks[i, src]
                pool.r_role[i, dst] = pool.r_role[i, src]
        pool.r_rid[i, len(keep):nr] = -1
        pool.n_res[i] = len(keep)
        pool.busy -= len(done)
        if not keep:
            pool.empty_since_s[i] = now        # linger clock starts on drain

    def _handoff(self, rid: int, src: _VecPool, now: float,
                 events, seq) -> None:
        """Transcribed ``FleetSimulator._handoff``: the SAME shared
        ``migration_charge`` settlement call, so the priced
        bytes/seconds/joules are bit-identical between engines."""
        q = self._queries[rid]
        spec = src.spec
        bs = spec.block_size if spec.kv_blocks else 0
        dst = self._pool_list[self.pool2_code[rid]]
        nbytes, t_mig, e_mig = migration_charge(
            self.model, q.m, spec.system, dst.spec.system,
            block_size=bs, rid=rid)
        self.energy_j[rid] += e_mig
        self.mig_bytes[rid] = nbytes
        heapq.heappush(events, (now + t_mig, next(seq), MIGRATE, rid))

    def _refill(self, pool: _VecPool, now: float, events, seq) -> None:
        """Transcribed ``FleetSimulator._refill``: admit queue head to the
        least-loaded awake instance that fits (slots AND blocks), settle the
        pool on a stuck head, demand-wake if still stuck."""
        spec = pool.spec
        kv = spec.kv_blocks
        while pool.queue:
            head_rid, head_role = pool.queue[0][2], pool.queue[0][4]
            need = int((pool.blocks_need_pf if head_role == ROLE_PF
                        else pool.blocks_need)[head_rid])
            if pool.n_awake * spec.slots - pool.busy <= 0:
                i = -1              # no awake slot free: provably stuck
            elif not kv and pool.n_awake == pool.n_inst:
                # every instance is awake and a free slot exists, so the
                # globally least-loaded instance is admissible — and argmin
                # is the first minimal one, exactly min() over instance order
                i = int(pool.n_res.argmin())
            else:
                ready = (pool.state == _AWAKE) & (pool.n_res < spec.slots)
                if kv:
                    ready &= need <= kv - pool.blocks_in_use
                if ready.any():
                    load = np.where(ready, pool.n_res, _HUGE)
                    i = int(np.argmin(load))    # first least-loaded, as min()
                else:
                    i = -1
            if i < 0:
                if self._settle(pool, now, events, seq):
                    continue        # freed capacity: re-evaluate the head
                self._demand_wake(pool, now, events, seq)
                break
            key, _, rid, svc_s, role = heapq.heappop(pool.queue)
            pool.queued_service_s -= svc_s
            self._advance_complete_row(pool, i, now, events, seq)
            slot = int(pool.n_res[i])
            pool.r_rid[i, slot] = rid
            pool.r_role[i, slot] = role
            if role == ROLE_PF:     # twin of _Resident's role branches
                pool.r_rem[i, slot] = 0.0
                pf_end_s = (now + float(pool.ov_s[rid])) + float(pool.pf_s[rid])
            elif role == ROLE_DEC:
                pool.r_rem[i, slot] = float(self._n_tok_f[rid])
                pf_end_s = now
            else:
                pool.r_rem[i, slot] = float(self._n_tok_f[rid])
                pf_end_s = (now + float(pool.ov_s[rid])) + float(pool.pf_s[rid])
            pool.r_pf_end_s[i, slot] = pf_end_s
            pool.r_b[i, slot] = -1              # t_tok not yet priced
            pool.r_blocks[i, slot] = need
            if role != ROLE_DEC:    # DEC keeps the prefill pool's anchors
                self.t_start_s[rid] = now
                self.t_decode_s[rid] = pf_end_s
            pool.n_res[i] += 1
            pool.blocks_in_use[i] += need
            pool.busy += 1
            if pool.busy > pool.result.peak_residents:
                pool.result.peak_residents = pool.busy
            self._reschedule(pool, i, now, events, seq)

    def _settle(self, pool: _VecPool, now: float, events, seq) -> bool:
        """Advance + complete every resident-holding instance to ``now``
        (batched) and report whether any slot or block freed; changed
        instances are rescheduled in index order (the reference engine's
        sequence-number order)."""
        idx = np.where(pool.n_res > 0)[0]
        if len(idx) == 0:
            return False
        if len(idx) > 8:
            self._advance_batch(pool, idx, now)
        else:
            for i in idx:
                self._advance_row(pool, int(i), now)
        freed = False
        for i in idx:
            if self._complete_row(pool, int(i), now, events, seq):
                self._reschedule(pool, int(i), now, events, seq)
                freed = True
        return freed

    # ----------------------------------------------------------- power moves
    def _demand_wake(self, pool: _VecPool, now: float, events, seq) -> None:
        if not pool.power_managed or not pool.queue:
            return
        incoming = pool.n_waking * pool.slots
        self._wake_sleeping(pool, len(pool.queue) - incoming, now, events, seq)

    def _wake_sleeping(self, pool: _VecPool, slot_deficit: int,
                       now: float, events, seq) -> None:
        if slot_deficit <= 0:
            return
        if pool.n_inst - pool.n_awake - pool.n_waking == 0:
            return
        table = pool.spec.system.states()
        asleep = np.where(pool.state >= _SLEEP)[0]
        if len(asleep) == 0:
            return
        wake_s = np.where(pool.state[asleep] == _SLEEP,
                          table.state(SLEEP).wake_s, table.state(OFF).wake_s)
        for i in asleep[np.argsort(wake_s, kind="stable")]:
            if slot_deficit <= 0:
                break
            self._begin_wake(pool, int(i), now)
            self._reschedule(pool, int(i), now, events, seq)
            slot_deficit -= pool.slots

    def _begin_wake(self, pool: _VecPool, i: int, now: float) -> None:
        st = pool.spec.system.states().state(_STATE_NAME[int(pool.state[i])])
        pool.wake_done_s[i] = now + st.wake_s
        pool.wake_energy_j[i] += st.wake_j
        pool.n_wakes[i] += 1
        pool.state[i] = _WAKING
        pool.n_waking += 1
        pool.timeline[i].append((now, WAKING))

    def _finish_wake(self, pool: _VecPool, i: int, now: float) -> None:
        pool.state[i] = _AWAKE
        pool.n_waking -= 1
        pool.n_awake += 1
        pool.empty_since_s[i] = now
        pool.timeline[i].append((now, AWAKE))

    def _go_sleep(self, pool: _VecPool, i: int, now: float) -> None:
        pool.last_t_s[i] = now
        pool.state[i] = _STATE_CODE[pool.spec.sleep_state]
        pool.n_awake -= 1
        pool.timeline[i].append((now, pool.spec.sleep_state))

    def _maybe_descend(self, pool: _VecPool, i: int, now: float) -> None:
        if (not pool.power_managed or pool.state[i] != _AWAKE
                or pool.n_res[i] or pool.queue):
            return
        if (pool.target_awake is not None
                and pool.n_awake + pool.n_waking > pool.target_awake):
            self._go_sleep(pool, i, now)
            return
        linger_s = pool.spec.linger_s
        if np.isfinite(linger_s) and now >= pool.empty_since_s[i] + linger_s - 1e-12:
            self._go_sleep(pool, i, now)

    def _control(self, pool: _VecPool, now: float, events, seq) -> None:
        policy = self._autoscalers[pool.name]
        snap = self._snapshot(pool, now)
        lo = max(0, min(policy.min_instances, pool.spec.instances))
        target = max(lo, min(pool.spec.instances, policy.desired_awake(snap)))
        pool.target_awake = target
        n_awake_like = pool.n_awake + pool.n_waking
        if n_awake_like < target:
            self._wake_sleeping(pool, (target - n_awake_like) * pool.slots,
                                now, events, seq)
        elif n_awake_like > target and not pool.queue:
            surplus = n_awake_like - target
            idlers = np.where((pool.state == _AWAKE) & (pool.n_res == 0))[0]
            order = np.argsort(pool.empty_since_s[idlers], kind="stable")
            for i in idlers[order][:surplus]:
                self._go_sleep(pool, int(i), now)
                self._reschedule(pool, int(i), now, events, seq)
        if self._work_remaining():
            nxt = now + policy.period_s
            if not self._fleet_busy():
                nxt = max(nxt, self._next_arrival_s())
            heapq.heappush(events, (nxt, next(seq), CONTROL, pool.name))

    # ------------------------------------------------------------ scheduling
    def _fleet_busy(self) -> bool:
        return any(p.queue or p.busy > 0 for p in self._pool_list)

    def _next_arrival_s(self) -> float:
        if self._next_idx >= self._n_req:
            return 0.0
        return float(self.t_arrival_s[self._next_idx])

    def _work_remaining(self) -> bool:
        return self._next_idx < self._n_req or self._fleet_busy()

    def _reschedule(self, pool: _VecPool, i: int, now: float,
                    events, seq) -> None:
        """Bump the instance's version (staling pending events), re-key its
        cached per-token times to the decode group at ``now`` (twin of
        ``_Resident.tok_time_util``'s per-b memo), and push its next event.
        The refresh and the next-event scan share one pass over the row —
        residents only live on AWAKE instances, so the resident branch never
        has to consult the power state."""
        pool.version[i] += 1
        nr = int(pool.n_res[i])
        if nr == 0:
            pool.b_cached[i] = 0
            if not pool.power_managed:
                return         # non-managed pools are always AWAKE, no linger
            st = int(pool.state[i])
            if st == _WAKING:
                nxt = float(pool.wake_done_s[i])
            elif st >= _SLEEP:
                return
            elif pool.linger_finite:
                nxt = float(pool.empty_since_s[i]) + pool.linger_s
            else:
                return
        else:
            thr = now + 1e-12
            pf = pool.r_pf_end_s[i, :nr].tolist()
            dec_ks = [k for k in range(nr) if pf[k] <= thr]
            b = len(dec_ks)
            pool.b_cached[i] = b
            nxt = math.inf
            if b:
                t_toks = pool.r_t_tok[i, :nr].tolist()
                rbs = pool.r_b[i, :nr].tolist()
                stale = [k for k in dec_ks if rbs[k] != b]
                if stale:
                    t_tab, p_tab = self._decode_table(pool, b)
                    p_ws = pool.r_p_w[i, :nr].tolist()
                    rids = pool.r_rid[i, :nr].tolist()
                    for k in stale:
                        rid = rids[k]
                        t_toks[k] = float(t_tab[rid])
                        p_ws[k] = float(p_tab[rid])
                        rbs[k] = b
                    pool.r_t_tok[i, :nr] = t_toks
                    pool.r_p_w[i, :nr] = p_ws
                    pool.r_b[i, :nr] = rbs
                rems = pool.r_rem[i, :nr].tolist()
                for k in range(nr):
                    t = pf[k] if pf[k] > thr else now + rems[k] * t_toks[k]
                    if t < nxt:
                        nxt = t
            else:
                for k in range(nr):
                    if pf[k] < nxt:
                        nxt = pf[k]
            if nxt == math.inf:
                return
        heapq.heappush(events, (max(nxt, now), next(seq), INSTANCE,
                                (pool, i, pool.version[i])))

    # -------------------------------------------------------------- finalize
    def _finalize(self, policy: str) -> FleetSimResult:
        horizon_s = self._horizon_s
        per_pool: Dict[str, PoolResult] = {}
        for pool in self._pool_list:
            spec = pool.spec
            total_slots = spec.instances * spec.slots
            busy = sum(pool.busy_slot_s.tolist())      # left-fold, as sum()
            pool.result.busy_slot_seconds = busy
            pool.result.energy_j = sum(
                self.energy_j[self.pool_code == pool.idx].tolist())
            if horizon_s > 0:
                pool.result.utilization = busy / (total_slots * horizon_s)
                if all(len(tl) == 1 for tl in pool.timeline):
                    idle_slot_s = total_slots * horizon_s - busy
                    pool.result.idle_energy_j = (
                        idle_slot_s * spec.system.power(0.0) / spec.slots)
                else:
                    self._integrate_power(pool, horizon_s)
            per_pool[pool.name] = pool.result
        arrays = {"t_arrival_s": self.t_arrival_s, "t_start_s": self.t_start_s,
                  "t_decode_s": self.t_decode_s, "t_done_s": self.t_done_s,
                  "energy_j": self.energy_j, "mig_bytes": self.mig_bytes}
        return FleetSimResult.from_arrays(
            policy, self._queries, self.pool_code,
            [p.name for p in self._pool_list], arrays, per_pool, horizon_s,
            pool2_code=self.pool2_code)

    def _integrate_power(self, pool: _VecPool, horizon_s: float) -> None:
        """Transcription of ``FleetSimulator._integrate_power`` over the
        array-backed per-instance accounting (same accumulation order)."""
        s = pool.spec.system
        p_idle_w = s.power(0.0)
        idle_j = sleep_s = wake_j = 0.0
        wakes = 0
        for i in range(pool.n_inst):
            segs = pool.timeline[i] + [(horizon_s, "end")]
            for (t0, st), (t1, _) in zip(segs, segs[1:]):
                dur = min(t1, horizon_s) - min(t0, horizon_s)
                if dur <= 0:
                    continue
                if st in (AWAKE, WAKING):
                    idle_j += dur * p_idle_w
                else:
                    idle_j += dur * s.state_power(st)
                    sleep_s += dur
            idle_j -= float(pool.busy_slot_s[i]) * p_idle_w / pool.slots
            idle_j += float(pool.wake_energy_j[i])
            wake_j += float(pool.wake_energy_j[i])
            wakes += int(pool.n_wakes[i])
        pool.result.idle_energy_j = idle_j
        pool.result.sleep_s = sleep_s
        pool.result.wake_energy_j = wake_j
        pool.result.wake_count = wakes

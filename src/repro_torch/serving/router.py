"""FleetRouter: the paper's scheduler as a serving feature (counterpart of
``repro/serving/router.py``).

A fleet is a set of *pools*; each pool is (SystemProfile, engine-or-batcher,
instance count). Incoming requests carry (m, expected_n); the router prices
them with the unified ``CostModel`` and dispatches through the same
``Scheduler.dispatch(query, fleet_state)`` API as the fleet simulators.
Every pool executes on the engine it was given (on this port: one H100, or
the host when the engine was built with ``device="cpu"``); energy and
runtime are accounted analytically per the assigned pool's profile —
exactly the quantity the paper optimizes.

Execution backends per pool:
  * engine  — immediate, blocking ``generate`` per request;
  * batcher — a ``ContinuousBatcher`` or ``PagedContinuousBatcher``:
    requests queue, ``drain()`` runs all pools' loops to completion.

A ``DeferPlan`` runs its inner plan at once (live serving cannot time-shift
a request). Under ``policy="disaggregated"`` a ``SplitPlan`` prefills on one
pool and decodes on another: when both are paged batchers with equal block
sizes the request is held after prefill and ``drain()`` hands its KV blocks
to the decode pool (``adopt_lane``); otherwise it runs wholly on the prefill
pool and keeps the split booking.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import DeferPlan, SplitPlan
from repro_torch.core.pricing import CostModel, CostParams, PerfOracle
from repro_torch.core.scheduler import (CapacityAwareScheduler,
                                        CostOptimalScheduler,
                                        DisaggregatedScheduler, FleetState,
                                        PoolSnapshot, Scheduler,
                                        ThresholdScheduler)
from repro_torch.core.settlement import (reconcile_deltas,
                                         reconcile_split_deltas, resolve_plan,
                                         route_bookings)
from repro_torch.core.systems import SystemProfile
from repro_torch.core.workload import Query
from repro_torch.serving.batching import (ContinuousBatcher,
                                          PagedContinuousBatcher, Request)
from repro_torch.serving.engine import InferenceEngine

POLICIES = ("threshold", "cost_optimal", "capacity_aware", "disaggregated")


@dataclass
class PoolStats:
    """Per-pool accounting. ``expected_*`` is booked at routing time from the
    request's declared (m, expected_n); the unprefixed totals are reconciled
    against the tokens actually emitted (EOS can retire a request early)."""
    queries: int = 0
    energy_j: float = 0.0
    runtime_s: float = 0.0
    tokens: int = 0
    expected_energy_j: float = 0.0
    expected_runtime_s: float = 0.0
    expected_tokens: int = 0


@dataclass
class RoutedRequest:
    rid: int
    pool: str
    energy_j: float
    runtime_s: float
    output: Optional[np.ndarray] = None
    request: Optional[Request] = None     # set when executed via a batcher


class FleetRouter:
    def __init__(self, cfg: ModelConfig, pools: Dict[str, SystemProfile],
                 engines: Optional[Dict[str, InferenceEngine]] = None, *,
                 policy: str = "threshold", t_in: int = 32, t_out: int = 32,
                 axis: str = "in", lam: float = 1.0,
                 counts: Optional[Dict[str, int]] = None,
                 oracle: Optional[PerfOracle] = None,
                 model: Optional[CostModel] = None):
        self.cfg = cfg
        self.pools = pools
        self.engines = engines or {}
        self.batchers: Dict[str, ContinuousBatcher] = {}
        self.counts = counts or {s.name: 1 for s in pools.values()}
        self.stats = {name: PoolStats() for name in pools}
        systems = list(pools.values())
        if model is not None:
            if oracle is not None:
                raise ValueError("pass either model= or oracle=, not both "
                                 "(the model already carries its oracle)")
            if lam != 1.0 and lam != model.cp.lam:
                raise ValueError(f"conflicting lam: lam={lam} but the given "
                                 f"model prices with lam={model.cp.lam}")
        else:
            model = CostModel(cfg, oracle, CostParams(lam=lam))
        self.model = model
        if policy == "threshold":
            eff = next(s for s in systems if s.kind == "eff")
            perf = next(s for s in systems if s.kind == "perf")
            self.scheduler: Scheduler = ThresholdScheduler(
                cfg, eff, perf, t_in=t_in, t_out=t_out, axis=axis, model=model)
        elif policy == "cost_optimal":
            self.scheduler = CostOptimalScheduler(cfg, systems, model=model)
        elif policy == "capacity_aware":
            self.scheduler = CapacityAwareScheduler(cfg, systems, self.counts,
                                                    model=model)
        elif policy == "disaggregated":
            self.scheduler = DisaggregatedScheduler(cfg, systems, model=model)
        else:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        self._name_of = {s.name: n for n, s in pools.items()}
        self._system_of = {s.name: s for s in pools.values()}
        if len(self._name_of) != len(pools):
            raise ValueError("pools must use distinct SystemProfile names: "
                             "dispatch maps a chosen system back to its pool "
                             "by name")
        self._rid = 0
        # batcher-executed requests awaiting actual-token reconciliation:
        # (pool, m, expected_n, Request, decode-pool-or-None)
        self._pending: List[tuple] = []
        # decode pool chosen by the most recent route() when it picked a
        # split plan, else None — submit() reads it to arm the handoff
        self._last_split: Optional[str] = None
        # rid -> (prefill pool, decode pool, Request) awaiting KV handoff
        self._handoffs: Dict[int, tuple] = {}

    # ------------------------------------------------------------- batchers
    def attach_batchers(self, slots: int = 4, *, paged: bool = False,
                        num_blocks: int = 64, block_size: int = 16,
                        chunk: int = 32, prefix_sharing: bool = True) -> None:
        """Give every engine-backed pool a continuous-batching backend.

        ``paged=True`` attaches ``PagedContinuousBatcher`` instances; their
        block occupancy is then exported to schedulers via the
        ``PoolSnapshot`` free/total-block fields. Each pool gets its own
        batcher (and KV pool), even where pools share one engine."""
        for name, eng in self.engines.items():
            if paged:
                self.batchers[name] = PagedContinuousBatcher(
                    eng, slots=slots, num_blocks=num_blocks,
                    block_size=block_size, chunk=chunk,
                    prefix_sharing=prefix_sharing)
            else:
                self.batchers[name] = ContinuousBatcher(eng, slots=slots)

    def _fleet_state(self, now: float = 0.0) -> FleetState:
        """Observable per-pool queue state for the dispatch API: queued
        backlog plus the residual decode of active lanes, spread over the
        slots; paged batchers also report block occupancy."""
        snaps = {}
        for name, sysp in self.pools.items():
            cb = self.batchers.get(name)
            busy = queue_len = 0
            slots = cb.slots if cb is not None else 1
            est_wait = 0.0
            if cb is not None:
                busy = sum(1 for r in cb.active if r is not None)
                queue_len = len(cb.queue)
                # batched pricing; summing the per-request terms left to
                # right in queue-then-active order reproduces the scalar
                # accumulation bit-for-bit
                vals: List[float] = []
                if cb.queue:
                    m_arr = np.fromiter((len(r.tokens) for r in cb.queue),
                                        np.int64, queue_len)
                    n_arr = np.fromiter((r.max_new_tokens for r in cb.queue),
                                        np.int64, queue_len)
                    vals += self.model.runtime_batch(m_arr, n_arr,
                                                     sysp).tolist()
                act = [r for r in cb.active if r is not None]
                if act:                        # residual decode of residents
                    m_arr = np.fromiter((len(r.tokens) for r in act),
                                        np.int64, len(act))
                    n_arr = np.fromiter((r.max_new_tokens for r in act),
                                        np.int64, len(act))
                    rem = np.fromiter(
                        (max(0, r.max_new_tokens - len(r.out_tokens))
                         for r in act), np.int64, len(act))
                    ph = self.model.price_batch(m_arr, n_arr, sysp, batch=1)
                    vals += (ph.t_decode / np.maximum(1, n_arr)
                             * rem).tolist()
                est_wait = sum(vals) / max(1, slots)
            # serving pools run hot: every instance awake, no wake pending
            n_inst = self.counts.get(sysp.name, 1)
            snaps[name] = PoolSnapshot(
                system=sysp, instances=n_inst,
                slots_per_instance=slots, busy_slots=busy,
                queue_len=queue_len, est_wait_s=est_wait,
                free_blocks=getattr(cb, "free_blocks", None),
                total_blocks=getattr(cb, "total_blocks", None),
                block_size=getattr(cb, "block_size", 0),
                awake_instances=n_inst, asleep_instances=0,
                wake_delay_s=0.0)
        return FleetState(time_s=now, pools=snaps)

    # --------------------------------------------------------------- routing
    def route(self, m: int, expected_n: int, arrival_s: float = 0.0) -> str:
        """Pick a pool for an (m, n) request; book it at ``expected_n`` in
        both the expected and the actual totals (execution reconciles the
        actual ones to the emitted token count)."""
        q = Query(m, expected_n, arrival_s)
        # snapshot only when the policy reads it
        fleet = None
        if self.batchers and type(self.scheduler).dispatch is not Scheduler.dispatch:
            fleet = self._fleet_state(arrival_s)
        plan = resolve_plan(self.scheduler.dispatch(q, fleet), q, self._name_of)
        self.scheduler.observe(q, plan)
        self._last_split = None
        if isinstance(plan, DeferPlan):
            # live serving cannot time-shift a request: the inner placement
            # runs at once (the defer window is a simulation / global
            # dispatch concern)
            plan = plan.inner
        if isinstance(plan, SplitPlan):
            name_a = self._name_of[plan.pool_prefill]
            self._last_split = self._name_of[plan.pool_decode]
            bs = getattr(self.batchers.get(name_a), "block_size", 0)
        else:
            name_a = self._name_of[plan.pool]
            bs = 0
        for b in route_bookings(self.model, plan, q, self._system_of,
                                block_size=bs):
            st = self.stats[self._name_of[b.pool]]
            st.queries += b.queries
            st.energy_j += b.energy_j
            st.runtime_s += b.runtime_s
            st.tokens += b.tokens
            st.expected_energy_j += b.energy_j
            st.expected_runtime_s += b.runtime_s
            st.expected_tokens += b.tokens
        return name_a

    def _reconcile_split(self, name_a: str, name_b: str, m: int,
                         expected_n: int, actual_n: int) -> None:
        """Split-plan analogue of ``_reconcile``: re-book each phase term on
        its own pool at the emitted token count. Migration depends only on
        ``m`` and needs no adjustment."""
        if actual_n == expected_n:
            return
        (da_e, da_r), (db_e, db_r), dn = reconcile_split_deltas(
            self.model, m, expected_n, actual_n,
            self.pools[name_a], self.pools[name_b])
        st_a, st_b = self.stats[name_a], self.stats[name_b]
        st_a.energy_j += da_e
        st_a.runtime_s += da_r
        st_b.energy_j += db_e
        st_b.runtime_s += db_r
        st_b.tokens += dn

    def _reconcile(self, name: str, m: int, expected_n: int,
                   actual_n: int) -> None:
        """Replace a request's expected-(m, n) booking in the ACTUAL totals
        with its emitted token count."""
        if actual_n == expected_n:
            return
        d_e, d_r, dn = reconcile_deltas(self.model, m, expected_n, actual_n,
                                        self.pools[name])
        st = self.stats[name]
        st.energy_j += d_e
        st.runtime_s += d_r
        st.tokens += dn

    def submit(self, tokens: np.ndarray, max_new_tokens: int,
               arrival_s: float = 0.0,
               eos_id: Optional[int] = None) -> RoutedRequest:
        """Route AND execute.

        With a batcher attached to the pool the request is queued (call
        ``drain()`` to run the loops); otherwise, with an engine, it
        generates immediately. A split plan between two paged batchers of
        equal block size arms the KV handoff: the request is held after
        prefill and ``drain()`` moves it to the decode pool."""
        self._rid += 1
        name = self.route(len(tokens), max_new_tokens, arrival_s)
        split_to = self._last_split
        out, req = None, None
        if name in self.batchers:
            req = Request(self._rid, np.asarray(tokens), max_new_tokens,
                          eos_id=eos_id)
            src, dst = self.batchers[name], self.batchers.get(split_to)
            if (split_to is not None
                    and isinstance(src, PagedContinuousBatcher)
                    and isinstance(dst, PagedContinuousBatcher)
                    and src.block_size == dst.block_size):
                # live handoff: prefill on `name`, hold, then adopt_lane
                # migrates the KV blocks to `split_to` during drain()
                req.hold = True
                self._handoffs[self._rid] = (name, split_to, req)
            else:
                # split plan priced and booked but not executable on these
                # backends (dense batcher or block-size mismatch): the
                # request runs wholly on the prefill pool, the booking keeps
                # the priced plan
                split_to = None
            src.submit(req)
            self._pending.append((name, len(tokens), max_new_tokens, req,
                                  split_to))
        elif name in self.engines:
            eng = self.engines[name]
            prompt = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                                     device=eng.device)[None]
            res = eng.generate({"tokens": prompt}, max_new_tokens,
                               eos_id=eos_id)
            out = res.tokens[0]
            if split_to is not None:
                self._reconcile_split(name, split_to, len(tokens),
                                      max_new_tokens, len(out))
            else:
                self._reconcile(name, len(tokens), max_new_tokens, len(out))
        sysp = self.pools[name]
        return RoutedRequest(self._rid, name,
                             self.model.energy(len(tokens), max_new_tokens, sysp),
                             self.model.runtime(len(tokens), max_new_tokens, sysp),
                             out, req)

    def drain(self, max_ticks: int = 10_000) -> None:
        """Run every pool's continuous-batching loop until all requests are
        done, then reconcile PoolStats against the tokens actually emitted.

        With handoffs pending the pools are ticked in lock-step so a held
        request can finish prefill on one pool and resume decode on another
        mid-drain; without any, each pool just runs to completion."""
        if self._handoffs:
            ticks = 0
            while ticks < max_ticks and (
                    self._handoffs
                    or any(cb.busy for cb in self.batchers.values())):
                for cb in self.batchers.values():
                    if cb.busy:
                        cb.step()
                if self._handoffs:
                    self._do_handoffs()
                ticks += 1
        else:
            for cb in self.batchers.values():
                cb.run(max_ticks)
        for name, m, expected_n, req, split_to in self._pending:
            if req.done:
                if split_to is None:
                    self._reconcile(name, m, expected_n, len(req.out_tokens))
                else:
                    self._reconcile_split(name, split_to, m, expected_n,
                                          len(req.out_tokens))
        self._pending = [p for p in self._pending if not p[3].done]

    def _do_handoffs(self) -> None:
        """Adopt every held request whose prefill has finished: the decode
        pool copies its KV blocks (``adopt_lane``) and the prefill-side lane
        is released. A lane-starved or block-starved decode pool leaves the
        handoff pending — retried next tick, after its own retirements have
        freed capacity."""
        remaining: Dict[int, tuple] = {}
        for rid, (src_name, dst_name, req) in self._handoffs.items():
            src = self.batchers[src_name]
            if req.done:
                # EOS on the very first token, mid-prefill: nothing decodes
                # and the booked migration never happens — undo it in the
                # execution-faithful totals (expected_* keeps the plan)
                bs = getattr(src, "block_size", 0)
                _, mig_s, mig_j = self.model.migration_terms(
                    len(req.tokens), self.pools[src_name],
                    self.pools[dst_name], block_size=bs)
                self.stats[src_name].energy_j -= mig_j
                self.stats[src_name].runtime_s -= mig_s
                continue
            src_i = next((i for i, r in enumerate(src.active) if r is req),
                         None)
            if src_i is None or not req.out_tokens or \
                    src._lane[src_i].prefilled < len(req.tokens):
                remaining[rid] = (src_name, dst_name, req)   # still prefilling
                continue
            if self.batchers[dst_name].adopt_lane(req, src, src_i) is None:
                remaining[rid] = (src_name, dst_name, req)   # target starved
                continue
            src.release_lane(src_i)
        self._handoffs = remaining

    def fleet_report(self) -> Dict[str, Dict]:
        return {n: vars(s) for n, s in self.stats.items()}

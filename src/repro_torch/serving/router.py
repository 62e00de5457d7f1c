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

``policy="disaggregated"`` (prefill on one pool, KV handoff, decode on
another) is not ported yet: it raises (ROADMAP Queue 1 item 5b). The three
ported policies place every request with a ``RunPlan`` on one pool, so the
split and defer plans of ``core.plan`` do not reach this router yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pricing import CostModel, CostParams, PerfOracle
from repro_torch.core.scheduler import (CapacityAwareScheduler,
                                        CostOptimalScheduler, FleetState,
                                        PoolSnapshot, Scheduler,
                                        ThresholdScheduler)
from repro_torch.core.settlement import (reconcile_deltas, resolve_plan,
                                         route_bookings)
from repro_torch.core.systems import SystemProfile
from repro_torch.core.workload import Query
from repro_torch.serving.batching import (ContinuousBatcher,
                                          PagedContinuousBatcher, Request)
from repro_torch.serving.engine import InferenceEngine

POLICIES = ("threshold", "cost_optimal", "capacity_aware")


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
            raise NotImplementedError(
                "policy='disaggregated' (KV handoff between pools: adopt_lane, "
                "release_lane, migrate_kv_blocks) is not ported yet; see "
                "ROADMAP Queue 1 item 5b")
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
        # (pool, m, expected_n, Request)
        self._pending: List[tuple] = []

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
        for b in route_bookings(self.model, plan, q, self._system_of):
            st = self.stats[self._name_of[b.pool]]
            st.queries += b.queries
            st.energy_j += b.energy_j
            st.runtime_s += b.runtime_s
            st.tokens += b.tokens
            st.expected_energy_j += b.energy_j
            st.expected_runtime_s += b.runtime_s
            st.expected_tokens += b.tokens
        return self._name_of[plan.pool]

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
        generates immediately."""
        self._rid += 1
        name = self.route(len(tokens), max_new_tokens, arrival_s)
        out, req = None, None
        if name in self.batchers:
            req = Request(self._rid, np.asarray(tokens), max_new_tokens,
                          eos_id=eos_id)
            self.batchers[name].submit(req)
            self._pending.append((name, len(tokens), max_new_tokens, req))
        elif name in self.engines:
            eng = self.engines[name]
            prompt = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                                     device=eng.device)[None]
            res = eng.generate({"tokens": prompt}, max_new_tokens,
                               eos_id=eos_id)
            out = res.tokens[0]
            self._reconcile(name, len(tokens), max_new_tokens, len(out))
        sysp = self.pools[name]
        return RoutedRequest(self._rid, name,
                             self.model.energy(len(tokens), max_new_tokens, sysp),
                             self.model.runtime(len(tokens), max_new_tokens, sysp),
                             out, req)

    def drain(self, max_ticks: int = 10_000) -> None:
        """Run every pool's continuous-batching loop until all requests are
        done, then reconcile PoolStats against the tokens actually emitted."""
        for cb in self.batchers.values():
            cb.run(max_ticks)
        for name, m, expected_n, req in self._pending:
            if req.done:
                self._reconcile(name, m, expected_n, len(req.out_tokens))
        self._pending = [p for p in self._pending if not p[3].done]

    def fleet_report(self) -> Dict[str, Dict]:
        return {n: vars(s) for n, s in self.stats.items()}

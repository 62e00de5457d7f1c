"""Discrete-event fleet simulator: time-aware evaluation of dispatch policies.

The static path (``simulator.simulate``) prices each query independently —
correct for the paper's Section 6 accounting, but blind to arrivals,
queueing, batching, and finite instance counts. This module simulates the
fleet as a discrete-event system so every ``Scheduler`` policy is compared
under identical queueing dynamics via the uniform online
``dispatch(query, fleet_state)`` API.

Event loop (heap-ordered, deterministic under a fixed workload seed):

  * **arrival**    — a query arrives; the policy dispatches it to a pool
                     (given a ``FleetState`` snapshot) and it joins the pool's
                     FIFO or priority queue.
  * **dispatch**   — a queued request is admitted to a free slot on the
                     least-loaded instance; per-request overhead + prefill
                     begin (prefill runs per-request, as in
                     ``serving.batching.ContinuousBatcher``).
  * **batch-step** — an instance's decode group advances. Decode steps are
                     shared across co-resident requests (the batcher's slot
                     model): each resident's per-token time is the priced
                     ``model.phases(..., batch=b).t_decode / n`` at the current
                     occupancy ``b``, so weight streaming amortizes across the
                     batch. The loop re-linearizes on every occupancy change
                     instead of emitting one event per token.

All pricing flows through one ``CostModel`` (``core.pricing``) — by default
the dispatch policy's own, so simulator and scheduler agree on phase times
whichever perf oracle (analytic / table / calibrated) is plugged in.
  * **completion** — a resident finishes its output tokens; the slot frees
                     and the queue refills it.

Energy accounting attributes instance power to residents (power at the
resident's utilization, split ``1/b`` across the batch), which makes the
zero-load / infinite-capacity limit reduce *exactly* to the static
``simulate()`` totals: batch=1 service reproduces ``energy(cfg, m, n, s)``
and ``runtime(cfg, m, n, s)`` term by term. Idle (allocated-but-unused)
energy over the makespan is reported separately as ``idle_energy_j`` so the
request-attributed total stays comparable to the static path.

Energy-proportional fleets: each instance additionally runs a power-state
machine over the profile's ``active``/``idle``/``sleep``/``off`` table
(``core.systems``). An instance drained of residents descends to
``PoolSpec.sleep_state`` after ``linger_s`` of idleness; ``_refill`` wakes
sleeping instances on demand (latency ``wake_s``, transition energy
``wake_j`` — both charged into ``idle_energy_j``, where allocated-but-idle
draw already lives). An optional ``AutoscalerPolicy`` (target-utilization or
queue-depth variant) additionally drives each pool's awake-instance count
between ``min_instances`` and ``PoolSpec.instances`` at a fixed control-loop
cadence, emitting scale events into the same heap. With ``linger_s=inf``
and no autoscaler the machine never engages and the simulation — per-request
energies AND fleet totals — is bit-for-bit the static-fleet behavior (the
equivalence invariant gated by tests and CI).
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import Plan
from repro_torch.core.pricing import AnalyticOracle, CostModel
from repro_torch.core.scheduler import (FleetState, PoolSnapshot,
                                        Scheduler, kv_blocks_needed)
# roles are defined by the shared settlement layer (re-exported here for the
# historical import path); both engines enqueue legs tagged with them
from repro_torch.core.settlement import (ROLE_DEC, ROLE_FULL, ROLE_PF,
                                         leg_service_s, migration_charge,
                                         plan_legs, resolve_plan)
from repro_torch.core.systems import SystemProfile
from repro_torch.core.workload import Query

# event kinds: INSTANCE = batch-step/completion/wake/linger, CONTROL =
# autoscaler tick, MIGRATE = a disaggregated request's KV handoff landing on
# its decode pool after the priced link transit time, ADMIT = a deferred
# request's admission clock arriving (DeferPlan.until_s)
ARRIVAL, INSTANCE, CONTROL, MIGRATE, ADMIT = 0, 1, 2, 3, 4

# instance power-machine states. AWAKE/WAKING draw idle power when unused;
# SLEEP/OFF names match the profile's PowerStateTable rows.
AWAKE, WAKING, SLEEP, OFF = "awake", "waking", "sleep", "off"


# ------------------------------------------------------------------ fleet spec
@dataclass(frozen=True)
class PoolSpec:
    """One pool: a system profile replicated ``instances`` times, each
    instance running ``slots`` continuous-batching decode lanes.

    ``kv_blocks`` bounds each instance's KV memory in blocks of
    ``block_size`` tokens (the paged serving runtime's unit): a request is
    admitted only when its worst-case context ``ceil((m + n) / block_size)``
    fits in the instance's free blocks, so decode occupancy is bounded by
    memory, not just the slot count. 0 = unbounded (pre-paging behavior).

    ``linger_s`` arms the power-state machine: an instance empty for that
    long descends to ``sleep_state`` (``"sleep"`` or ``"off"`` in the
    profile's power table) and is woken on demand. The default ``inf``
    keeps every instance awake forever — the pre-power-management fleet."""
    system: SystemProfile
    instances: int = 1
    slots: int = 1
    kv_blocks: int = 0
    block_size: int = 16
    linger_s: float = math.inf
    sleep_state: str = SLEEP

    def __post_init__(self):
        if self.sleep_state not in (SLEEP, OFF):
            raise ValueError(f"sleep_state must be {SLEEP!r} or {OFF!r}, "
                             f"got {self.sleep_state!r}")
        if self.linger_s < 0:
            raise ValueError(f"linger_s must be >= 0, got {self.linger_s}")

    def blocks_needed(self, q: Query) -> int:
        if not self.kv_blocks:
            return 0
        return kv_blocks_needed(q.m + q.n, self.block_size)

    def blocks_needed_prefill(self, q: Query) -> int:
        """Blocks a prefill-only (pre-handoff) residency holds: the prompt's
        context, not the worst-case decoded context — the decode pool pays
        for that after migration."""
        if not self.kv_blocks:
            return 0
        return kv_blocks_needed(q.m, self.block_size)


# --------------------------------------------------------------------- records
@dataclass
class RequestRecord:
    rid: int
    query: Query
    pool: str
    t_arrival: float
    t_start: float = 0.0          # admitted to an instance (queue wait ends)
    t_decode: float = 0.0         # prefill done, decoding begins
    t_done: float = 0.0
    energy_j: float = 0.0
    # disaggregated requests only: the pool that ran decode (``pool`` is then
    # the prefill pool, which also carries the per-pool energy attribution),
    # and the KV bytes the handoff moved over the inter-pool link
    pool_decode: str = ""
    mig_bytes: float = 0.0

    @property
    def wait_s(self) -> float:
        return self.t_start - self.t_arrival

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def service_s(self) -> float:
        return self.t_done - self.t_start


@dataclass
class PoolResult:
    queries: int = 0
    energy_j: float = 0.0
    idle_energy_j: float = 0.0    # allocated idle + sleep draw + wake energy
    busy_slot_seconds: float = 0.0
    utilization: float = 0.0      # busy slot-seconds / (slots * horizon)
    peak_residents: int = 0       # max concurrent residents (occupancy bound)
    wake_count: int = 0           # sleep/off -> awake transitions
    wake_energy_j: float = 0.0    # one-shot transition energy (inside idle_energy_j)
    sleep_s: float = 0.0          # instance-seconds spent in sleep/off (<= horizon)


class FleetSimResult:
    """Simulation outcome: request records (or their struct-of-arrays
    equivalent from the vectorized engine), per-pool accounting, horizon.

    Backed either by a list of ``RequestRecord`` (event engine) or by
    rid-indexed numpy arrays (``from_arrays``, vectorized engine); each view
    is materialized lazily from the other, so metrics are computed one way —
    over the arrays — whichever engine produced the result. Every metric is
    bit-for-bit what the historical list-comprehension code computed (same
    float values elementwise, same reduction order/algorithm).
    """

    def __init__(self, policy: str, records: Optional[List[RequestRecord]],
                 per_pool: Dict[str, PoolResult], horizon_s: float, *,
                 _queries: Optional[Sequence[Query]] = None,
                 _pool_code: Optional[np.ndarray] = None,
                 _pool_names: Optional[Sequence[str]] = None,
                 _arrays: Optional[Dict[str, np.ndarray]] = None,
                 _pool2_code: Optional[np.ndarray] = None):
        self.policy = policy
        self.per_pool = per_pool
        self.horizon_s = horizon_s
        self._records = records
        self._queries = _queries          # rid-ordered (array-backed results)
        self._pool_code = _pool_code      # rid -> index into _pool_names
        self._pool_names = _pool_names
        self._arrays = _arrays            # rid-indexed t_*/energy arrays
        self._pool2_code = _pool2_code    # rid -> decode pool (-1 = no split)
        self._sorted_latency_s: Optional[np.ndarray] = None
        self._sorted_ttft_s: Optional[np.ndarray] = None
        self._sorted_tpot_s: Optional[np.ndarray] = None

    @classmethod
    def from_arrays(cls, policy: str, queries: Sequence[Query],
                    pool_code: np.ndarray, pool_names: Sequence[str],
                    arrays: Dict[str, np.ndarray],
                    per_pool: Dict[str, PoolResult],
                    horizon_s: float,
                    pool2_code: Optional[np.ndarray] = None) -> "FleetSimResult":
        """Array-backed result (vectorized engine): ``arrays`` holds
        ``t_arrival_s``/``t_start_s``/``t_decode_s``/``t_done_s``/``energy_j``
        /``mig_bytes`` indexed by rid; ``pool_code[rid]`` indexes
        ``pool_names`` (``pool2_code`` likewise for split requests' decode
        pool, -1 where the request never split)."""
        return cls(policy, None, per_pool, horizon_s, _queries=queries,
                   _pool_code=pool_code, _pool_names=pool_names,
                   _arrays=arrays, _pool2_code=pool2_code)

    @property
    def records(self) -> List[RequestRecord]:
        if self._records is None:
            a = self._arrays
            p2 = self._pool2_code
            self._records = [
                RequestRecord(rid, q, self._pool_names[self._pool_code[rid]],
                              t_arrival=float(a["t_arrival_s"][rid]),
                              t_start=float(a["t_start_s"][rid]),
                              t_decode=float(a["t_decode_s"][rid]),
                              t_done=float(a["t_done_s"][rid]),
                              energy_j=float(a["energy_j"][rid]),
                              pool_decode=(self._pool_names[p2[rid]]
                                           if p2 is not None and p2[rid] >= 0
                                           else ""),
                              mig_bytes=float(a["mig_bytes"][rid])
                              if "mig_bytes" in a else 0.0)
                for rid, q in enumerate(self._queries)]
        return self._records

    def _metric_arrays(self) -> Dict[str, np.ndarray]:
        if self._arrays is None:
            recs = self._records
            self._arrays = {
                "t_arrival_s": np.array([r.t_arrival for r in recs]),
                "t_start_s": np.array([r.t_start for r in recs]),
                "t_decode_s": np.array([r.t_decode for r in recs]),
                "t_done_s": np.array([r.t_done for r in recs]),
                "energy_j": np.array([r.energy_j for r in recs]),
                "mig_bytes": np.array([r.mig_bytes for r in recs]),
            }
        return self._arrays

    def _out_tokens(self) -> np.ndarray:
        if self._queries is not None:
            return np.array([q.n for q in self._queries])
        return np.array([r.query.n for r in self._records])

    def __len__(self) -> int:
        if self._queries is not None:
            return len(self._queries)
        return len(self._records)

    @property
    def total_energy_j(self) -> float:
        # sequential left-fold, as the historical sum over records
        return sum(self._metric_arrays()["energy_j"].tolist())

    @property
    def idle_energy_j(self) -> float:
        return sum(p.idle_energy_j for p in self.per_pool.values())

    @property
    def fleet_energy_j(self) -> float:
        """Request-attributed + allocated-idle energy over the makespan."""
        return self.total_energy_j + self.idle_energy_j

    @property
    def tokens(self) -> int:
        if self._queries is not None:
            return sum(q.m + q.n for q in self._queries)
        return sum(r.query.m + r.query.n for r in self._records)

    @property
    def j_per_token(self) -> float:
        """Request-attributed J/token only — EXCLUDES allocated-idle energy.
        Comparable to the static per-query accounting, but it understates a
        poorly-utilized fleet; use ``fleet_j_per_token`` to rank policies."""
        return self.total_energy_j / max(1, self.tokens)

    @property
    def fleet_j_per_token(self) -> float:
        """Idle-inclusive J/token: (attributed + allocated-idle + wake)
        energy over the makespan, per token — the headline fleet metric."""
        return self.fleet_energy_j / max(1, self.tokens)

    def slo_attainment(self, slo_s: float) -> float:
        """Fraction of requests whose end-to-end latency met ``slo_s``."""
        if not len(self):
            return 1.0
        a = self._metric_arrays()
        return float(np.mean((a["t_done_s"] - a["t_arrival_s"]) <= slo_s))

    def latency_percentile(self, p: float) -> float:
        if not len(self):
            return 0.0
        if self._sorted_latency_s is None:
            # sorted once per result: p50 + p99 + any further percentile
            # reuse it instead of re-sorting per call
            a = self._metric_arrays()
            self._sorted_latency_s = np.sort(a["t_done_s"] - a["t_arrival_s"])
        return float(np.percentile(self._sorted_latency_s, p))

    def ttft_percentile(self, p: float) -> float:
        """Time-to-first-token percentile: prefill completion minus arrival
        (``t_decode_s`` is when decoding begins — for a split request, when
        the prefill pool finished, so a handoff does not inflate TTFT)."""
        if not len(self):
            return 0.0
        if self._sorted_ttft_s is None:
            # sorted once per result, as latency_percentile does
            a = self._metric_arrays()
            self._sorted_ttft_s = np.sort(a["t_decode_s"] - a["t_arrival_s"])
        return float(np.percentile(self._sorted_ttft_s, p))

    def tpot_percentile(self, p: float) -> float:
        """Time-per-output-token percentile: the decode span spread over the
        request's output tokens. For a split request the span includes the
        migration transit and the decode pool's queue — the handoff's
        latency cost lands here, not in TTFT."""
        if not len(self):
            return 0.0
        if self._sorted_tpot_s is None:
            a = self._metric_arrays()
            span_s = a["t_done_s"] - a["t_decode_s"]
            self._sorted_tpot_s = np.sort(
                span_s / np.maximum(1, self._out_tokens()))
        return float(np.percentile(self._sorted_tpot_s, p))

    @property
    def p50_latency_s(self) -> float:
        return self.latency_percentile(50)

    @property
    def p99_latency_s(self) -> float:
        return self.latency_percentile(99)

    @property
    def p99_ttft_s(self) -> float:
        return self.ttft_percentile(99)

    @property
    def mig_bytes(self) -> float:
        """Total KV bytes moved by prefill->decode handoffs (0 when the
        policy never split a request)."""
        # sequential left-fold, as total_energy_j
        return sum(self._metric_arrays()["mig_bytes"].tolist())

    @property
    def mean_wait_s(self) -> float:
        if not len(self):
            return 0.0
        a = self._metric_arrays()
        return float(np.mean(a["t_start_s"] - a["t_arrival_s"]))

    def summary(self) -> Dict[str, float]:
        """Flat scalar summary (one CSV row): per-pool utilization appears
        as ``util_<pool>`` keys, never as a nested dict."""
        out = {
            "energy_j": self.total_energy_j,
            "fleet_energy_j": self.fleet_energy_j,
            "j_per_token": self.j_per_token,
            "fleet_j_per_token": self.fleet_j_per_token,
            "p50_latency_s": self.p50_latency_s,
            "p99_latency_s": self.p99_latency_s,
            "p99_ttft_s": self.p99_ttft_s,
            "mean_wait_s": self.mean_wait_s,
            "mig_bytes": self.mig_bytes,
            "horizon_s": self.horizon_s,
        }
        for n, p in self.per_pool.items():
            out[f"util_{n}"] = p.utilization
        return out


# ----------------------------------------------------------------- autoscaling
@dataclass
class AutoscalerPolicy:
    """SLO-aware control loop over a pool's awake-instance count.

    Every ``period_s`` the simulator snapshots the pool and asks
    ``desired_awake``; the answer is clamped to
    [``min_instances``, ``PoolSpec.instances``], then sleeping instances are
    woken (scale-up) or drained idle instances are put to sleep
    (scale-down). Demand wake in ``_refill`` can always override a low
    target — the autoscaler shapes provisioned capacity, it never blocks
    admission of queued work."""
    period_s: float = 30.0
    min_instances: int = 1

    def desired_awake(self, snap: PoolSnapshot) -> int:
        raise NotImplementedError


@dataclass
class TargetUtilizationAutoscaler(AutoscalerPolicy):
    """Provision so current demand (busy slots + queued requests) lands at
    ``target_util`` of the awake slot capacity."""
    target_util: float = 0.6

    def desired_awake(self, snap: PoolSnapshot) -> int:
        demand = snap.busy_slots + snap.queue_len
        per_instance = max(snap.slots_per_instance * self.target_util, 1e-9)
        return int(math.ceil(demand / per_instance))


@dataclass
class QueueDepthAutoscaler(AutoscalerPolicy):
    """Hysteresis on queue depth: wake one more instance when the queue
    exceeds ``high`` requests per awake instance; sleep one when the queue
    is at most ``low`` and a whole instance's worth of slots is idle."""
    high: int = 2
    low: int = 0

    def desired_awake(self, snap: PoolSnapshot) -> int:
        awake = snap.provisioned_instances
        if snap.queue_len > self.high * max(1, awake):
            return awake + 1
        if (snap.queue_len <= self.low
                and snap.busy_slots <= (awake - 1) * snap.slots_per_instance):
            return awake - 1
        return awake


# ------------------------------------------------------------------- internals
class _Resident:
    """A request occupying one slot (and its KV blocks) of an instance."""
    __slots__ = ("rec", "phases1", "rem_tokens", "prefill_end", "_t_tok",
                 "blocks", "role")

    def __init__(self, model: CostModel, rec: RequestRecord, s: SystemProfile,
                 now: float, blocks: int = 0, role: int = ROLE_FULL):
        self.rec = rec
        self.role = role
        q = rec.query
        self.phases1 = model.phases(q.m, q.n, s, batch=1)
        # overhead + per-request prefill run before the resident joins the
        # decode group (ContinuousBatcher: prefill per-request, decode batched)
        self.prefill_end = now + self.phases1.t_overhead + self.phases1.t_prefill
        self.rem_tokens = float(q.n)
        if role == ROLE_PF:
            # prefill-only residency: completes at prefill_end, the output
            # tokens decode elsewhere after the KV handoff
            self.rem_tokens = 0.0
        elif role == ROLE_DEC:
            # decode-only residency: prefill already ran on the source pool,
            # so no prefill window (and no prefill energy) accrues here
            self.prefill_end = now
        self.blocks = blocks
        self._t_tok: Dict[int, Tuple[float, float]] = {}

    def tok_time_util(self, model: CostModel, s: SystemProfile,
                      b: int) -> Tuple[float, float]:
        """(seconds per output token, decode utilization) at occupancy b."""
        hit = self._t_tok.get(b)
        if hit is None:
            ph = model.phases(self.rec.query.m, self.rec.query.n, s, batch=b)
            hit = (ph.t_decode / max(1, self.rec.query.n), ph.util_decode)
            self._t_tok[b] = hit
        return hit


class _Instance:
    __slots__ = ("pool", "iid", "slots", "residents", "last_t", "version",
                 "busy_slot_seconds", "blocks_in_use", "state", "wake_done",
                 "empty_since", "timeline", "wake_energy_j", "n_wakes")

    def __init__(self, pool: "_PoolRuntime", iid: int, slots: int):
        self.pool = pool
        self.iid = iid
        self.slots = slots
        self.residents: List[_Resident] = []
        self.last_t = 0.0
        self.version = 0
        self.busy_slot_seconds = 0.0
        self.blocks_in_use = 0
        # power-state machine: every instance starts awake (so a fleet with
        # the machine disengaged IS the static fleet). ``timeline`` records
        # (t, state) transitions for exact idle-power integration; a
        # single-entry timeline means the instance never left AWAKE.
        self.state = AWAKE
        self.wake_done = 0.0
        self.empty_since = 0.0
        self.timeline: List[Tuple[float, str]] = [(0.0, AWAKE)]
        self.wake_energy_j = 0.0
        self.n_wakes = 0

    @property
    def free_slots(self) -> int:
        return self.slots - len(self.residents)

    # ------------------------------------------------------ power transitions
    def begin_wake(self, now: float) -> None:
        """sleep/off -> waking: charge the one-shot transition energy and
        hold the instance for the table's wake latency (idle draw is accrued
        for the window by the timeline integration)."""
        st = self.pool.spec.system.states().state(self.state)
        self.wake_done = now + st.wake_s
        self.wake_energy_j += st.wake_j
        self.n_wakes += 1
        self.state = WAKING
        self.timeline.append((now, WAKING))

    def finish_wake(self, now: float) -> None:
        self.state = AWAKE
        self.empty_since = now
        self.timeline.append((now, AWAKE))

    def go_sleep(self, now: float, state: str) -> None:
        """awake -> sleep/off. Only drained instances descend."""
        assert not self.residents and self.state == AWAKE
        self.last_t = now
        self.state = state
        self.timeline.append((now, state))

    @property
    def free_blocks(self) -> int:
        kv = self.pool.spec.kv_blocks
        return kv - self.blocks_in_use if kv else 0

    def fits(self, blocks: int) -> bool:
        return not self.pool.spec.kv_blocks or blocks <= self.free_blocks

    def advance(self, model: CostModel, now: float) -> None:
        """Progress decode/prefill state from last_t to now.

        Event scheduling guarantees no resident crosses prefill->decode
        strictly inside the interval: every prefill_end and every admission
        is itself an event boundary, so the decode batch size b is constant
        over [last_t, now].
        """
        t0, dt = self.last_t, now - self.last_t
        self.last_t = now
        if dt <= 0 or not self.residents:
            return
        self.busy_slot_seconds += len(self.residents) * dt
        decoding = [r for r in self.residents if r.prefill_end <= t0 + 1e-12]
        b = len(decoding)
        s = self.pool.spec.system
        for r in decoding:
            t_tok, util = r.tok_time_util(model, s, b)
            steps = dt / t_tok if t_tok > 0 else r.rem_tokens
            steps = min(steps, r.rem_tokens)
            r.rem_tokens -= steps
            # instance power at this resident's utilization, split across batch
            r.rec.energy_j += steps * t_tok * s.power(util) / b
            # snap float dust: a remainder whose decode time is below the
            # representable time resolution at `now` would schedule an event
            # that rounds onto `now` and never progresses (livelock)
            if r.rem_tokens * t_tok <= 4.0 * np.spacing(max(now, 1.0)):
                r.rem_tokens = 0.0
        for r in self.residents:
            if r.prefill_end > t0 + 1e-12:       # in overhead+prefill phase
                span = min(now, r.prefill_end) - t0
                if span > 0:
                    ph = r.phases1
                    t_total = ph.t_overhead + ph.t_prefill
                    # blended power over the window: overhead draws idle
                    # power, prefill draws power at util_prefill — integrates
                    # to exactly the static per-query prefill+overhead energy
                    p_w = (ph.t_overhead * s.power(0.0) + ph.t_prefill
                           * s.power(ph.util_prefill)) / max(t_total, 1e-12)
                    r.rec.energy_j += span * p_w

    def pop_finished(self, now: float) -> List[_Resident]:
        """Remove and return residents that have emitted all output tokens
        (a residual microtoken counts as done — its service time and energy
        are below float resolution at fleet time scales)."""
        done = [r for r in self.residents
                if r.rem_tokens <= 1e-6 and r.prefill_end <= now + 1e-12]
        for r in done:
            self.residents.remove(r)
            self.blocks_in_use -= r.blocks
        return done

    def next_event_time(self, model: CostModel, now: float) -> Optional[float]:
        """Earliest upcoming prefill-finish or decode completion; for the
        power machine, the wake completion (waking) or the linger deadline
        (empty + awake + finite linger). Sleeping instances are event-free
        until woken."""
        if self.state == WAKING:
            return self.wake_done
        if self.state in (SLEEP, OFF):
            return None
        if not self.residents:
            linger = self.pool.spec.linger_s
            if self.pool.power_managed and np.isfinite(linger):
                return self.empty_since + linger
            return None
        t = float("inf")
        decoding = [r for r in self.residents if r.prefill_end <= now + 1e-12]
        b = len(decoding)
        for r in self.residents:
            if r.prefill_end > now + 1e-12:
                t = min(t, r.prefill_end)
            else:
                t_tok, _ = r.tok_time_util(model, self.pool.spec.system, b)
                t = min(t, now + r.rem_tokens * t_tok)
        return t if np.isfinite(t) else None


class _PoolRuntime:
    def __init__(self, name: str, spec: PoolSpec):
        self.name = name
        self.spec = spec
        # finite linger engages the power machine; the simulator also sets
        # this for autoscaled pools. Disengaged = static-fleet behavior.
        self.power_managed = bool(np.isfinite(spec.linger_s))
        self.target_awake: Optional[int] = None   # autoscaler's current target
        self.instances = [_Instance(self, i, spec.slots)
                          for i in range(spec.instances)]
        # heap of (priority, seq, record, batch=1 service time, role)
        self.queue: List[Tuple[float, int, RequestRecord, float, int]] = []
        self.queued_service_s = 0.0      # running sum of queued service times
        self.result = PoolResult()

    def awake_like(self) -> List[_Instance]:
        """Provisioned capacity: awake plus already-waking instances."""
        return [i for i in self.instances if i.state in (AWAKE, WAKING)]

    def wake_delay(self, now: float) -> float:
        """Expected extra delay before NEW capacity could serve an arrival:
        0 with a free awake slot; else the soonest wake completion among
        waking instances, or the fastest wake latency among sleeping ones
        (a stuck arrival triggers a demand wake). 0 again when the pool has
        nothing asleep — then the only path to a slot is a completion."""
        if any(i.state == AWAKE and i.free_slots > 0 for i in self.instances):
            return 0.0
        cands = []
        for i in self.instances:
            if i.state == WAKING:
                cands.append(max(0.0, i.wake_done - now))
            elif i.state in (SLEEP, OFF):
                cands.append(self.spec.system.states().state(i.state).wake_s)
        return min(cands) if cands else 0.0

    def enqueue(self, key: float, seqno: int, rec: RequestRecord,
                service_s: float, role: int = ROLE_FULL) -> None:
        heapq.heappush(self.queue, (key, seqno, rec, service_s, role))
        self.queued_service_s += service_s

    def dequeue(self) -> Tuple[RequestRecord, int]:
        _, _, rec, service_s, role = heapq.heappop(self.queue)
        self.queued_service_s -= service_s
        return rec, role

    def snapshot(self, model: CostModel, now: float) -> PoolSnapshot:
        busy = sum(len(i.residents) for i in self.instances)
        kv = self.spec.kv_blocks
        provisioned = self.awake_like()
        # per-instance admission terms (see PoolSnapshot): a request lands on
        # ONE instance, so the admissibility signal is the most-free
        # instance's headroom, not the pool aggregate. Sleeping instances
        # COUNT: a demand wake makes their blocks reachable within
        # wake_delay_s (already folded into est_wait_s), so reporting a cold
        # pool as block-starved would double-penalize it — the mem_wait_s
        # pressure term prices ~a full service time on top of the wake.
        return PoolSnapshot(
            system=self.spec.system,
            instances=self.spec.instances,
            slots_per_instance=self.spec.slots,
            busy_slots=busy,
            queue_len=len(self.queue),
            est_wait_s=self.est_wait(model, now),
            free_blocks=max(i.free_blocks for i in self.instances) if kv else None,
            total_blocks=kv if kv else None,
            block_size=self.spec.block_size if kv else 0,
            awake_instances=len(provisioned),
            asleep_instances=self.spec.instances - len(provisioned),
            wake_delay_s=self.wake_delay(now),
        )

    def est_wait(self, model: CostModel, now: float) -> float:
        """Estimated queueing delay for a new arrival: time until the next
        slot frees, plus the queued backlog spread over the provisioned
        (awake + waking) slots. A cold pool is priced honestly: when no
        awake slot is free the wake path — a waking instance's completion,
        or the demand-wake latency of a sleeping one — competes with the
        next decode completion for ``next_free``."""
        provisioned = self.awake_like()
        total_slots = len(provisioned) * self.spec.slots
        free = sum(i.free_slots for i in provisioned if i.state == AWAKE)
        backlog = self.queued_service_s / max(1, total_slots)
        if free > 0:
            return backlog
        nxt = [i.next_event_time(model, now) for i in provisioned]
        nxt = [t for t in nxt if t is not None]
        wake = self.wake_delay(now)
        if wake > 0:
            nxt.append(now + wake)
        next_free = (min(nxt) - now) if nxt else 0.0
        return max(0.0, next_free) + backlog


# ------------------------------------------------------------------- simulator
class FleetSimulator:
    """Discrete-event simulation of a heterogeneous pool fleet under an
    online dispatch policy.

    queue_discipline: 'fifo' (arrival order) or 'sjf' (shortest expected
    service first — priority queue on the analytic batch=1 runtime).

    autoscaler: one ``AutoscalerPolicy`` applied to every pool, or a
    {pool name: policy} mapping for a subset. Autoscaled pools get CONTROL
    events at the policy's cadence; pools left out (and all pools when None)
    keep static provisioning unless their ``linger_s`` is finite.
    """

    def __init__(self, cfg: ModelConfig, pools: Dict[str, PoolSpec],
                 scheduler: Scheduler, *, queue_discipline: str = "fifo",
                 model: Optional[CostModel] = None,
                 autoscaler: Union[AutoscalerPolicy,
                                   Dict[str, AutoscalerPolicy], None] = None):
        if queue_discipline not in ("fifo", "sjf"):
            raise ValueError(f"unknown queue discipline {queue_discipline!r}")
        self.cfg = cfg
        # one pricing seam for the whole simulation: default to the policy's
        # own CostModel so simulator and scheduler price identically
        self.model = model if model is not None \
            else getattr(scheduler, "model", None) or CostModel(cfg, AnalyticOracle())
        self.pools = {n: _PoolRuntime(n, spec) for n, spec in pools.items()}
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
        self.events_processed = 0    # heap pops, incl. arrivals/stale events

    # ------------------------------------------------------------------ run
    def run(self, queries: Sequence[Query],
            policy_name: Optional[str] = None) -> FleetSimResult:
        if self._ran:
            raise RuntimeError("FleetSimulator is single-shot (instances hold "
                               "clock state); build a new one per run")
        self._ran = True
        model = self.model
        seq = itertools.count()
        events: List[Tuple[float, int, int, object]] = []
        for rid, q in enumerate(sorted(queries, key=lambda q: q.arrival_s)):
            heapq.heappush(events, (q.arrival_s, next(seq), ARRIVAL, (rid, q)))

        records: List[RequestRecord] = []
        self._horizon = 0.0
        self._arrival_times = [e[0] for e in sorted(events)]
        self._arrivals_left = len(events)

        # arm the power machine: linger timers for initially-empty instances
        # and the first control tick per autoscaled pool. Disengaged pools
        # (infinite linger, no autoscaler) schedule nothing here.
        for pool in self.pools.values():
            if pool.power_managed and np.isfinite(pool.spec.linger_s):
                for inst in pool.instances:
                    self._reschedule(inst, 0.0, events, seq)
        for name, policy in self._autoscalers.items():
            heapq.heappush(events, (policy.period_s, next(seq), CONTROL, name))

        while events:
            t, _, kind, payload = heapq.heappop(events)
            self.events_processed += 1
            if kind == ARRIVAL:
                self._arrivals_left -= 1
                rid, q = payload
                plan = self._dispatch(q, t)
                pool_sys, dec_sys, role, until_s = plan_legs(plan, q)
                pool = self.pools[self._by_system[pool_sys]]
                if dec_sys is not None:             # split: prefill here...
                    dst = self.pools[self._by_system[dec_sys]]
                    self._check_admissible(pool,
                                           pool.spec.blocks_needed_prefill(q),
                                           q)
                    self._check_admissible(dst, dst.spec.blocks_needed(q), q)
                    rec = RequestRecord(rid, q, pool.name, t_arrival=t,
                                        pool_decode=dst.name)
                else:
                    self._check_admissible(pool, pool.spec.blocks_needed(q), q)
                    rec = RequestRecord(rid, q, pool.name, t_arrival=t)
                svc = leg_service_s(model, q, pool.spec.system, role)
                records.append(rec)
                pool.result.queries += 1
                if until_s > t:                     # deferred admission
                    heapq.heappush(events, (until_s, next(seq), ADMIT,
                                            (pool, rec, svc, role)))
                else:
                    key = svc if self.queue_discipline == "sjf" else t
                    pool.enqueue(key, next(seq), rec, svc, role)
                    self._refill(pool, t, events, seq)
            elif kind == ADMIT:                     # DeferPlan clock arrived
                pool, rec, svc, role = payload
                key = svc if self.queue_discipline == "sjf" else t
                pool.enqueue(key, next(seq), rec, svc, role)
                self._refill(pool, t, events, seq)
            elif kind == INSTANCE:                  # batch-step/wake/linger
                inst, version = payload
                if version != inst.version:
                    continue                        # stale event
                inst.advance(model, t)
                if inst.state == WAKING and t >= inst.wake_done - 1e-12:
                    inst.finish_wake(t)
                self._complete(inst, t, events, seq)
                self._refill(inst.pool, t, events, seq)
                self._maybe_descend(inst, t)
                self._reschedule(inst, t, events, seq)
            elif kind == MIGRATE:                   # ...decode there
                rec = payload
                pool = self.pools[rec.pool_decode]
                q = rec.query
                svc = leg_service_s(model, q, pool.spec.system, ROLE_DEC)
                key = svc if self.queue_discipline == "sjf" else t
                pool.enqueue(key, next(seq), rec, svc, ROLE_DEC)
                self._refill(pool, t, events, seq)
            else:                                   # CONTROL autoscaler tick
                self._control(self.pools[payload], t, events, seq)

        return self._finalize(records, self._horizon,
                              policy_name or type(self.scheduler).__name__)

    # ------------------------------------------------------------- internals
    def _fleet_state(self, now: float) -> FleetState:
        return FleetState(time_s=now,
                          pools={n: p.snapshot(self.model, now)
                                 for n, p in self.pools.items()})

    def _dispatch(self, q: Query, now: float) -> Plan:
        """Route one arrival through the shared settlement seam: resolve the
        policy's return into the plan IR (legacy encodings coerce behind a
        ``DeprecationWarning``; a split for a zero-decode query degrades to
        the prefill pool — there is nothing to hand off), validate its pool
        names, then commit it to the scheduler via ``observe``."""
        plan = resolve_plan(self.scheduler.dispatch(q, self._fleet_state(now)),
                            q, self._by_system)
        self.scheduler.observe(q, plan)
        return plan

    @staticmethod
    def _check_admissible(pool: _PoolRuntime, need: int, q: Query) -> None:
        if need > pool.spec.kv_blocks > 0:
            raise ValueError(
                f"query (m={q.m}, n={q.n}) needs {need} KV blocks but "
                f"pool {pool.name!r} instances hold only "
                f"{pool.spec.kv_blocks}: it can never be admitted")

    def _complete(self, inst: _Instance, now: float, events, seq) -> None:
        done = inst.pop_finished(now)
        for r in done:
            if r.role == ROLE_PF:
                self._handoff(r.rec, inst.pool, now, events, seq)
            else:
                r.rec.t_done = now
                self._horizon = max(self._horizon, now)
        if done and not inst.residents:
            inst.empty_since = now      # linger clock starts on drain

    def _handoff(self, rec: RequestRecord, src: _PoolRuntime, now: float,
                 events, seq) -> None:
        """Prefill finished on the source pool: price the KV-block migration
        (one scalar ``migration_terms`` call — the seam shared with the
        scheduler and the vectorized engine), charge its energy to the
        request, and deliver it to the decode pool's queue after the link
        transit time via a MIGRATE event."""
        q = rec.query
        spec = src.spec
        bs = spec.block_size if spec.kv_blocks else 0
        dst = self.pools[rec.pool_decode]
        nbytes, t_mig, e_mig = migration_charge(
            self.model, q.m, spec.system, dst.spec.system, block_size=bs,
            rid=rec.rid)
        rec.energy_j += e_mig
        rec.mig_bytes = nbytes
        heapq.heappush(events, (now + t_mig, next(seq), MIGRATE, rec))

    def _refill(self, pool: _PoolRuntime, now: float, events, seq) -> None:
        """Admit queued requests into free slots (least-loaded awake
        instance); the admissibility set is re-evaluated after every
        admission — ``_complete`` on the chosen instance may have freed
        blocks only after the previous check.

        Block-capacity admission: with ``kv_blocks`` set, the head request is
        admitted only to an instance whose free blocks cover its worst-case
        context — a free slot alone is not capacity. Before the head is made
        to wait, completions due at exactly ``now`` on *other* instances are
        settled (``_settle``) so capacity freed in the same tick is used in
        the same tick; if the pool is still stuck, sleeping instances are
        demand-woken to cover the queue."""
        while pool.queue:
            head_rec, head_role = pool.queue[0][2], pool.queue[0][4]
            need = (pool.spec.blocks_needed_prefill(head_rec.query)
                    if head_role == ROLE_PF
                    else pool.spec.blocks_needed(head_rec.query))
            ready = [i for i in pool.instances
                     if i.state == AWAKE and i.free_slots > 0 and i.fits(need)]
            if not ready:
                if self._settle(pool, now, events, seq):
                    continue            # freed capacity: re-evaluate the head
                self._demand_wake(pool, now, events, seq)
                break
            inst = min(ready, key=lambda i: len(i.residents))
            rec, role = pool.dequeue()
            inst.advance(self.model, now)
            self._complete(inst, now, events, seq)
            res = _Resident(self.model, rec, pool.spec.system, now, need,
                            role=role)
            if role != ROLE_DEC:        # a DEC admission keeps the original
                rec.t_start = now       # queue-wait and TTFT anchors from
                rec.t_decode = res.prefill_end      # the prefill pool
            inst.residents.append(res)
            inst.blocks_in_use += need
            pool.result.peak_residents = max(
                pool.result.peak_residents,
                sum(len(i.residents) for i in pool.instances))
            self._reschedule(inst, now, events, seq)

    def _settle(self, pool: _PoolRuntime, now: float, events, seq) -> bool:
        """Advance + complete every resident-holding instance to ``now`` and
        report whether any slot or block freed. A completion due at exactly
        ``now`` can still sit in the event heap (same timestamp, later
        sequence number) while the head-of-line request is evaluated — its
        slots/blocks must count as capacity in this tick, not the next.
        Advancing here is exact: ``now`` is an event boundary, so no
        resident crosses prefill->decode strictly inside the interval."""
        freed = False
        for i in pool.instances:
            if not i.residents:
                continue
            before = (len(i.residents), i.blocks_in_use)
            i.advance(self.model, now)
            self._complete(i, now, events, seq)
            if (len(i.residents), i.blocks_in_use) != before:
                self._reschedule(i, now, events, seq)
                freed = True
        return freed

    def _demand_wake(self, pool: _PoolRuntime, now: float, events, seq) -> None:
        """Wake sleeping instances to cover the queue. Demand overrides the
        autoscaler target (SLO protection): the control loop shapes
        provisioned capacity, it never strands queued work. Reached only
        when no awake instance can admit the head — whether slot-bound or
        block-bound — so a block-bound stall wakes a (block-free) sleeping
        instance instead of waiting out a resident's decode."""
        if not pool.power_managed or not pool.queue:
            return
        # no awake free-slot capacity can fit the head here (that is what
        # made _refill stick), so the queue's only incoming capacity is
        # instances already waking
        incoming = sum(i.slots for i in pool.instances if i.state == WAKING)
        self._wake_sleeping(pool, len(pool.queue) - incoming, now, events, seq)

    def _wake_sleeping(self, pool: _PoolRuntime, slot_deficit: int,
                       now: float, events, seq) -> None:
        """Begin waking sleeping/off instances, fastest wake first, until
        their slots cover ``slot_deficit``."""
        if slot_deficit <= 0:
            return
        table = pool.spec.system.states()
        asleep = sorted((i for i in pool.instances if i.state in (SLEEP, OFF)),
                        key=lambda i: table.state(i.state).wake_s)
        for i in asleep:
            if slot_deficit <= 0:
                break
            i.begin_wake(now)
            self._reschedule(i, now, events, seq)
            slot_deficit -= i.slots

    def _maybe_descend(self, inst: _Instance, now: float) -> None:
        """Drained-instance descent: immediately when the pool is over its
        autoscaler target, at the linger deadline otherwise. The caller
        reschedules, which also invalidates any pending timer."""
        pool = inst.pool
        if (not pool.power_managed or inst.state != AWAKE or inst.residents
                or pool.queue):
            return
        if (pool.target_awake is not None
                and len(pool.awake_like()) > pool.target_awake):
            inst.go_sleep(now, pool.spec.sleep_state)
            return
        linger = pool.spec.linger_s
        if np.isfinite(linger) and now >= inst.empty_since + linger - 1e-12:
            inst.go_sleep(now, pool.spec.sleep_state)

    def _control(self, pool: _PoolRuntime, now: float, events, seq) -> None:
        """One autoscaler tick: clamp the policy's desired awake count to
        [min_instances, instances], wake or drain toward it, and keep
        ticking while work remains anywhere in the fleet (the loop must not
        hold the event heap open forever on an idle fleet)."""
        policy = self._autoscalers[pool.name]
        snap = pool.snapshot(self.model, now)
        lo = max(0, min(policy.min_instances, pool.spec.instances))
        target = max(lo, min(pool.spec.instances, policy.desired_awake(snap)))
        pool.target_awake = target
        awake = pool.awake_like()
        if len(awake) < target:
            self._wake_sleeping(pool, (target - len(awake)) * pool.spec.slots,
                                now, events, seq)
        elif len(awake) > target and not pool.queue:
            surplus = len(awake) - target
            idlers = sorted((i for i in awake
                             if i.state == AWAKE and not i.residents),
                            key=lambda i: i.empty_since)
            for i in idlers[:surplus]:
                i.go_sleep(now, pool.spec.sleep_state)
                self._reschedule(i, now, events, seq)
        if self._work_remaining():
            nxt = now + policy.period_s
            if not self._fleet_busy():
                # fleet fully drained, only future arrivals remain: skip the
                # empty gap instead of ticking through it (a trace with an
                # hours-long lull would otherwise cost thousands of no-op
                # snapshots)
                nxt = max(nxt, self._next_arrival_s())
            heapq.heappush(events, (nxt, next(seq), CONTROL, pool.name))

    def _fleet_busy(self) -> bool:
        return any(p.queue or any(i.residents for i in p.instances)
                   for p in self.pools.values())

    def _next_arrival_s(self) -> float:
        if self._arrivals_left <= 0:
            return 0.0
        return self._arrival_times[len(self._arrival_times)
                                   - self._arrivals_left]

    def _work_remaining(self) -> bool:
        return self._arrivals_left > 0 or self._fleet_busy()

    def _reschedule(self, inst: _Instance, now: float, events, seq) -> None:
        inst.version += 1
        nxt = inst.next_event_time(self.model, now)
        if nxt is not None:
            heapq.heappush(events, (max(nxt, now), next(seq), INSTANCE,
                                    (inst, inst.version)))

    def _finalize(self, records, horizon, policy) -> FleetSimResult:
        per_pool = {}
        for n, p in self.pools.items():
            total_slots = p.spec.instances * p.spec.slots
            busy = sum(i.busy_slot_seconds for i in p.instances)
            p.result.busy_slot_seconds = busy
            p.result.energy_j = sum(r.energy_j for r in records if r.pool == n)
            if horizon > 0:
                p.result.utilization = busy / (total_slots * horizon)
                if all(len(i.timeline) == 1 for i in p.instances):
                    # power machine never engaged: the historical pooled
                    # formula, bit-for-bit (the static-fleet equivalence
                    # invariant). Allocated-idle power per slot: instance
                    # idle power / slots.
                    idle_slot_s = total_slots * horizon - busy
                    p.result.idle_energy_j = (
                        idle_slot_s * p.spec.system.power(0.0) / p.spec.slots)
                else:
                    self._integrate_power(p, horizon)
            per_pool[n] = p.result
        return FleetSimResult(policy, records, per_pool, horizon)

    def _integrate_power(self, p: _PoolRuntime, horizon: float) -> None:
        """Exact idle-side energy over [0, horizon] from each instance's
        power-state timeline: awake/waking segments draw instance idle power
        (minus the busy share already attributed to residents), sleep/off
        segments draw the table's state power, and each wake adds its
        one-shot transition energy. Transitions after the horizon (e.g. a
        linger descent scheduled past the last completion) fall outside the
        accounting window and contribute nothing."""
        s = p.spec.system
        p_idle = s.power(0.0)
        idle_j = sleep_s = wake_j = 0.0
        wakes = 0
        for i in p.instances:
            segs = i.timeline + [(horizon, "end")]
            for (t0, st), (t1, _) in zip(segs, segs[1:]):
                dur = min(t1, horizon) - min(t0, horizon)
                if dur <= 0:
                    continue
                if st in (AWAKE, WAKING):
                    idle_j += dur * p_idle
                else:
                    idle_j += dur * s.state_power(st)
                    sleep_s += dur
            idle_j -= i.busy_slot_seconds * p_idle / p.spec.slots
            idle_j += i.wake_energy_j
            wake_j += i.wake_energy_j
            wakes += i.n_wakes
        p.result.idle_energy_j = idle_j
        p.result.sleep_s = sleep_s
        p.result.wake_energy_j = wake_j
        p.result.wake_count = wakes


FLEET_ENGINES = ("event", "vectorized")


def simulate_fleet(cfg: ModelConfig, queries: Sequence[Query],
                   pools: Optional[Dict[str, PoolSpec]] = None,
                   scheduler: Optional[Scheduler] = None, *,
                   regions: Optional[Sequence] = None,
                   queue_discipline: str = "fifo",
                   policy_name: Optional[str] = None,
                   model: Optional[CostModel] = None,
                   autoscaler: Union[AutoscalerPolicy,
                                     Dict[str, AutoscalerPolicy],
                                     None] = None,
                   engine: str = "vectorized") -> FleetSimResult:
    """One-call wrapper: build a fleet simulator and run the workload.

    Pass exactly one of ``pools`` (a flat {name: PoolSpec} fleet — the
    historical single-region form) or ``regions`` (a sequence of
    ``core.region.Region``: each a named fleet with its own carbon/price
    trace). Regions are flattened into one pool mapping with
    ``<region>/<pool>`` names (``core.region.flatten_regions``), so every
    engine, metric, and record works unchanged; a region-aware policy
    (``core.region.GlobalDispatcher``) can then route or defer across them
    through the same plan IR as any single-region scheduler.

    ``engine="vectorized"`` (the default) is the struct-of-arrays engine
    (``core.fleet_vec``), ~20-40x faster at fleet scale;
    ``engine="event"`` is the reference one-event-at-a-time loop above.
    The engines are bit-for-bit equivalent (gated by
    tests/test_fleet_vec.py and ``benchmarks/fleet_bench.py --smoke``)."""
    if (pools is None) == (regions is None):
        raise ValueError("pass exactly one of pools= or regions=")
    if scheduler is None:
        raise TypeError("simulate_fleet requires a scheduler")
    if regions is not None:
        # deferred import: region builds on this module's PoolSpec
        from repro_torch.core.region import flatten_regions
        pools = flatten_regions(regions)
    if engine not in FLEET_ENGINES:
        raise ValueError(f"unknown engine {engine!r}; "
                         f"choose from {FLEET_ENGINES}")
    if engine == "vectorized":
        from repro_torch.core.fleet_vec import VectorizedFleetSimulator
        return VectorizedFleetSimulator(
            cfg, pools, scheduler, queue_discipline=queue_discipline,
            model=model, autoscaler=autoscaler).run(queries, policy_name)
    return FleetSimulator(cfg, pools, scheduler,
                          queue_discipline=queue_discipline, model=model,
                          autoscaler=autoscaler).run(queries, policy_name)

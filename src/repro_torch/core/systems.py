"""System profiles for the hybrid heterogeneous fleet.

A ``SystemProfile`` is one *serving instance*: a set of chips that together
host one model replica. Profiles carry the hardware constants the analytic
perf/energy model needs. The paper's systems (M1-Pro, A100 node, V100 node)
are included so its experiments can be replayed; the TPU classes are the
deployment target of this framework.

Power constants: vendor TDP where published, otherwise documented estimates
(marked ~). The paper's central phenomenon — an efficiency-class device with
lower J/token below a workload threshold — depends on the *ratio* of idle
power to peak and on per-query software overhead, not on exact wattages.

Power states: allocated-but-idle draw dominates fleet energy at low
utilization (Samsi et al., "From Words to Watts"), so a profile also carries
a four-state power table (``active`` / ``idle`` / ``sleep`` / ``off``) with
per-state draw, wake latency, and wake energy. The fleet simulator's
power-state machine (``core.fleet``) descends drained instances into
``sleep``/``off`` and charges the transition costs on wake; with no table
attached, ``default_power_states`` derives one from the profile's
peak/idle constants.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

POWER_STATES = ("active", "idle", "sleep", "off")


@dataclass(frozen=True)
class PowerState:
    """One row of a profile's power-state table.

    ``power_w`` is per chip (multiply by ``SystemProfile.chips`` for the
    instance draw, as with ``power_peak_w``/``power_idle_w``). ``wake_s`` /
    ``wake_j`` are the latency and one-shot energy (per *instance*) of the
    transition from this state back to ``idle``; during that window the
    instance additionally draws idle power (it is powering up), so
    ``wake_j`` is only the above-idle transition surcharge."""
    name: str
    power_w: float
    wake_s: float = 0.0
    wake_j: float = 0.0


@dataclass(frozen=True)
class PowerStateTable:
    """Per-profile ``active``/``idle``/``sleep``/``off`` table.

    ``active``/``idle`` draws must agree with the profile's
    ``power_peak_w``/``power_idle_w`` (the utilization-linear ``power()`` model
    interpolates between them); ``sleep``/``off`` are the states the fleet
    power machine can descend a drained instance into."""
    active: PowerState
    idle: PowerState
    sleep: PowerState
    off: PowerState

    def state(self, name: str) -> PowerState:
        if name not in POWER_STATES:
            raise KeyError(f"unknown power state {name!r}; "
                           f"choose from {POWER_STATES}")
        return getattr(self, name)


@dataclass(frozen=True)
class SystemProfile:
    name: str
    kind: str                 # "eff" | "perf"
    chips: int                # chips per serving instance
    peak_flops: float         # FLOP/s per chip (bf16/fp16 dense)
    hbm_bw: float             # bytes/s per chip
    ici_bw: float             # bytes/s per inter-chip link
    power_peak_w: float       # W per chip, full utilization
    power_idle_w: float       # W per chip, idle but allocated
    overhead_s: float         # per-query software overhead (tokenize/schedule/launch)
    mem_eff: float = 0.8      # achievable fraction of peak HBM bandwidth
    compute_eff: float = 0.5  # achievable fraction of peak FLOPs at B=1 inference
    # Workload-saturation constant (tokens). Efficiency-class devices degrade
    # superlinearly as the working set grows (cache thrash, unified-memory
    # contention, thermal limits): effective service time is multiplied by
    # (1 + ctx/sat_ctx). None = no degradation (datacenter parts). This models
    # the paper's Fig 1a/2a observation that the M1-Pro's runtime escalates
    # "with the most significant magnitude" and it cannot generate >512 tokens
    # without "significant runtime penalties".
    sat_ctx: Optional[float] = None
    max_out_tokens: int = 0   # advisory output cap (0 = unlimited)
    # Inter-pool migration link bandwidth (gigabits/s) from/to this instance
    # class: the DCN/PCIe path a disaggregated KV handoff rides, as opposed to
    # ``ici_bw`` (the intra-instance chip interconnect). 0.0 = no migration
    # path; the DisaggregatedScheduler never splits a query across a pool
    # pair unless both endpoints advertise a positive link bandwidth.
    link_bw_gbps: float = 0.0
    # Optional explicit power-state table; None = derive on demand from the
    # peak/idle constants (``default_power_states``). Kept Optional so every
    # pre-power-management profile (and its hash/equality) is unchanged.
    power_states: Optional[PowerStateTable] = None

    def degradation(self, ctx: float) -> float:
        if self.sat_ctx is None:
            return 1.0
        return 1.0 + ctx / self.sat_ctx

    @property
    def instance_peak_flops(self) -> float:
        return self.chips * self.peak_flops

    @property
    def instance_hbm_bw(self) -> float:
        return self.chips * self.hbm_bw

    def power(self, util: float) -> float:
        """Instance power draw (W) at compute utilization in [0, 1]."""
        util = min(max(util, 0.0), 1.0)
        return self.chips * (self.power_idle_w
                              + (self.power_peak_w - self.power_idle_w) * util)

    def states(self) -> PowerStateTable:
        """This profile's power-state table (explicit or derived)."""
        if self.power_states is not None:
            return self.power_states
        return default_power_states(self)

    def state_power(self, name: str) -> float:
        """Instance draw (W) in the named power state."""
        return self.chips * self.states().state(name).power_w


@functools.lru_cache(maxsize=None)
def default_power_states(profile: SystemProfile, *,
                         sleep_frac: float = 0.12,
                         sleep_wake_s: float = 5.0,
                         off_wake_s: float = 60.0) -> PowerStateTable:
    """Derive a power-state table from a profile's peak/idle constants
    (memoized — profiles are frozen/hashable and the fleet simulator asks
    per arrival).

    Estimates (marked ~ like the profile wattages themselves): ``sleep``
    retains ~12% of idle draw (suspended host, powered links, self-refresh
    HBM); ``off`` draws nothing but takes a full reboot to return. Wake
    energy is the above-idle surcharge of re-initializing the part, modeled
    as half the idle-to-peak gap sustained over the wake latency — the fleet
    machine separately charges idle draw for the wake window, so the table
    stays consistent whichever latency is configured."""
    idle_w, peak_w = profile.power_idle_w, profile.power_peak_w
    surge_w = 0.5 * (peak_w - idle_w) * profile.chips     # per instance
    return PowerStateTable(
        active=PowerState("active", peak_w),
        idle=PowerState("idle", idle_w),
        sleep=PowerState("sleep", sleep_frac * idle_w,
                         wake_s=sleep_wake_s, wake_j=surge_w * sleep_wake_s),
        off=PowerState("off", 0.0,
                       wake_s=off_wake_s, wake_j=surge_w * off_wake_s),
    )


# --------------------------------------------------------------------------- TPU
# v5e: 197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI (the repo's roofline target)
TPU_V5E_PERF = SystemProfile(
    name="tpu-v5e-perf", kind="perf", chips=4,
    peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
    power_peak_w=170.0,         # ~ per-chip board power under load
    power_idle_w=55.0,          # ~ allocated-idle
    overhead_s=0.04,
    link_bw_gbps=100.0,         # ~ per-host DCN NIC
)

# efficiency class: down-clocked v5e-lite-like single chip. Half clock ->
# slightly better than half peak power (voltage scaling), much lower idle.
TPU_V5LITE_EFF = SystemProfile(
    name="tpu-v5lite-eff", kind="eff", chips=1,
    peak_flops=98.5e12, hbm_bw=819e9, ici_bw=50e9,
    power_peak_w=70.0, power_idle_w=8.0,
    overhead_s=0.08,          # weaker host, slower launch path
    sat_ctx=2048.0,           # single chip: VMEM/HBM pressure at long context
    max_out_tokens=4096,
    link_bw_gbps=100.0,       # same DCN fabric as the perf class
)

# --------------------------------------------------------------------------- paper replay
M1_PRO = SystemProfile(
    name="m1-pro", kind="eff", chips=1,
    peak_flops=5.2e12,        # 14-core M1 Pro GPU fp16
    hbm_bw=200e9,             # unified memory bandwidth
    ici_bw=0.0,
    power_peak_w=30.0, power_idle_w=2.0,
    overhead_s=0.35,          # macOS + python serving stack (paper Fig 1a intercept)
    compute_eff=0.4,
    sat_ctx=10.0,             # calibrated: reproduces the paper's T*=32 optimum
                              # on BOTH axes under the Eq. 9/10 methodology
    max_out_tokens=512,       # paper: M1 "could only generate up to 512 tokens"
)

A100_NODE = SystemProfile(
    name="swing-a100", kind="perf", chips=8,   # 8x A100-40GB (paper's Swing node)
    peak_flops=312e12, hbm_bw=1555e9, ici_bw=300e9,
    power_peak_w=400.0, power_idle_w=55.0,
    overhead_s=0.06,
    link_bw_gbps=200.0,       # HDR InfiniBand host fabric
)

V100_NODE = SystemProfile(
    name="palmetto-v100", kind="perf", chips=2,  # 2x V100-16GB
    peak_flops=125e12, hbm_bw=900e9, ici_bw=150e9,
    power_peak_w=300.0, power_idle_w=45.0,
    overhead_s=0.10,
    link_bw_gbps=100.0,       # EDR InfiniBand host fabric
)

PROFILES: Dict[str, SystemProfile] = {
    p.name: p for p in
    (TPU_V5E_PERF, TPU_V5LITE_EFF, M1_PRO, A100_NODE, V100_NODE)
}


def get_profile(name: str) -> SystemProfile:
    return PROFILES[name]


def paper_fleet() -> Tuple[SystemProfile, SystemProfile]:
    """(efficiency, performance) pair the paper's Section 6 analyses."""
    return M1_PRO, A100_NODE


def tpu_fleet() -> Tuple[SystemProfile, SystemProfile]:
    """TPU-native hybrid fleet (our deployment adaptation)."""
    return TPU_V5LITE_EFF, TPU_V5E_PERF

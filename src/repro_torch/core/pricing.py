"""Unified pricing layer: pluggable ``PerfOracle`` backends behind one
``CostModel``.

Every component that prices a query — the Eq. 1 cost function, all
schedulers, the carbon extension, the discrete-event fleet simulator, and
the serving router — goes through this seam. A ``PerfOracle`` answers one
question (per-phase seconds + utilization for a query on a system); the
``CostModel`` turns phases into energy (J), runtime (s), grams of CO2, and
the paper's U(m, n, s) = lambda*E + (1-lambda)*R, with an optional
quantized-(m, n) LRU memo for simulation hot paths.

Backends:
  * ``AnalyticOracle``   — the roofline model (``perf_model.query_phases``),
                           bit-for-bit identical to the historical
                           ``energy()``/``runtime()`` free functions.
  * ``TableOracle``      — bilinear interpolation over a log-spaced (m, n)
                           grid of per-phase times; grids are precomputed
                           from another oracle or loaded from measurements.
  * ``CalibratedOracle`` — the analytic form with ``compute_eff`` /
                           ``mem_eff`` / ``sat_ctx`` / ``overhead_s`` FIT to
                           measured kernel timings (``fit_calibration``, fed
                           by ``benchmarks/microbench.kernel_phase_samples``
                           timing the real Pallas kernels). Artifacts live
                           under ``experiments/calibration/``.

Why calibration: *Offline Energy-Optimal LLM Serving* (arXiv 2407.04014) and
*Energy Considerations of LLM Inference* (arXiv 2504.17674) both find that
workload-based energy models only transfer across hardware when fit to
measured runtimes; hand-tuned roofline efficiencies do not.
"""
from __future__ import annotations

import json
import math
from collections import OrderedDict
from dataclasses import asdict, dataclass, replace
from typing import (TYPE_CHECKING, Dict, Iterable, List, Optional, Protocol,
                    Sequence, Tuple, runtime_checkable)

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.perf_model import (BatchPhases, QueryPhases, query_phases,
                                         query_phases_batch)
from repro_torch.core.systems import SystemProfile

if TYPE_CHECKING:   # avoid a runtime cycle: carbon imports pricing
    from repro_torch.core.carbon import CarbonProfile


@dataclass(frozen=True)
class CostParams:
    """Eq. 1 parameters (historically defined in the deleted
    ``core.cost`` module)."""
    lam: float = 1.0                     # 1.0 = pure energy (paper's Section 6)
    e_norm: float = 1.0                  # J scale
    r_norm: float = 1.0                  # s scale


# ------------------------------------------------------------------ protocol
@runtime_checkable
class PerfOracle(Protocol):
    """Answers: how long does query (m, n) take on ``system``, per phase?"""

    def phases(self, cfg: ModelConfig, m: int, n: int, system: SystemProfile,
               batch: int = 1) -> QueryPhases: ...


class AnalyticOracle:
    """The repo's roofline model, moved behind the oracle interface.

    ``phases`` delegates verbatim to ``perf_model.query_phases`` so energy
    and runtime derived from it are bit-for-bit identical to the historical
    free functions (asserted in ``tests/test_pricing.py``).
    """

    name = "analytic"

    def phases(self, cfg: ModelConfig, m: int, n: int, system: SystemProfile,
               batch: int = 1) -> QueryPhases:
        return query_phases(cfg, m, n, system, batch)

    def phases_batch(self, cfg: ModelConfig, m, n, system: SystemProfile,
                     batch: int = 1) -> BatchPhases:
        """Vectorized ``phases`` — elementwise bit-identical to the scalar path."""
        return query_phases_batch(cfg, m, n, system, batch)

    def __repr__(self) -> str:
        return "AnalyticOracle()"


# --------------------------------------------------------------- table oracle
def default_grid(lo: int = 1, hi: int = 4096) -> np.ndarray:
    """Log2-spaced token grid: lo, 2*lo, 4*lo, ... up to hi (inclusive)."""
    ks = range(int(math.floor(math.log2(max(1, lo)))),
               int(math.floor(math.log2(hi))) + 1)
    return np.array([1 << k for k in ks if lo <= (1 << k) <= hi], dtype=float)


@dataclass(frozen=True)
class PhaseTable:
    """Per-phase values sampled on an (m, n) grid for one (system, batch).

    Prefill and decode are stored *per token* (t_prefill/m, t_decode/n): both
    are near-linear in their own token count, so interpolating the per-token
    rate and rescaling is far more accurate than interpolating totals.
    """
    m_grid: np.ndarray                 # (M,) ascending
    n_grid: np.ndarray                 # (N,) ascending
    tp_tok: np.ndarray                 # (M, N) prefill seconds per input token
    td_tok: np.ndarray                 # (M, N) decode seconds per output token
    util_prefill: np.ndarray           # (M, N)
    util_decode: np.ndarray            # (M, N)
    t_overhead: float

    def _coords(self, grid: np.ndarray, x: float) -> Tuple[int, int, float]:
        """Clamped bracketing indices + interpolation weight in log space."""
        lx = math.log(max(x, 1e-12))
        lg = np.log(grid)
        if lx <= lg[0]:
            return 0, 0, 0.0
        if lx >= lg[-1]:
            return len(grid) - 1, len(grid) - 1, 0.0
        j = int(np.searchsorted(lg, lx)) - 1
        w = (lx - lg[j]) / (lg[j + 1] - lg[j])
        return j, j + 1, w

    def interp(self, m: float, n: float) -> Tuple[float, float, float, float]:
        """Bilinear (in log m, log n) -> (tp_tok, td_tok, util_pf, util_dec)."""
        i0, i1, wm = self._coords(self.m_grid, m)
        j0, j1, wn = self._coords(self.n_grid, n)

        def bil(a: np.ndarray) -> float:
            top = a[i0, j0] * (1 - wn) + a[i0, j1] * wn
            bot = a[i1, j0] * (1 - wn) + a[i1, j1] * wn
            return float(top * (1 - wm) + bot * wm)

        return (bil(self.tp_tok), bil(self.td_tok),
                bil(self.util_prefill), bil(self.util_decode))


class TableOracle:
    """Phase times by bilinear interpolation over (m, n) log-grids.

    Tables are keyed by (system name, batch) and built lazily from ``base``
    (default: the analytic oracle) — or injected via ``add_table`` when they
    come from measurements. One oracle serves one ``ModelConfig``.
    """

    name = "table"

    def __init__(self, cfg: ModelConfig, base: Optional[PerfOracle] = None, *,
                 m_grid: Optional[Sequence[float]] = None,
                 n_grid: Optional[Sequence[float]] = None):
        self.cfg = cfg
        self.base: PerfOracle = base if base is not None else AnalyticOracle()
        self.m_grid = np.asarray(m_grid if m_grid is not None
                                 else default_grid(), dtype=float)
        self.n_grid = np.asarray(n_grid if n_grid is not None
                                 else default_grid(), dtype=float)
        self._tables: Dict[Tuple[SystemProfile, int], PhaseTable] = {}
        self.version = 0        # bumped on mutation so CostModel memos refresh
        self.calibration: Optional["Calibration"] = None  # set by from_autotune

    def add_table(self, system: SystemProfile, table: PhaseTable,
                  batch: int = 1) -> None:
        self._tables[(system, batch)] = table
        self.version += 1

    @classmethod
    def from_autotune(cls, cfg: ModelConfig, system: SystemProfile, cache, *,
                      batch: int = 1,
                      m_grid: Optional[Sequence[float]] = None,
                      n_grid: Optional[Sequence[float]] = None,
                      fit_sat_ctx: bool = True) -> "TableOracle":
        """Rebuild the phase grids from autotuned kernel timings.

        ``cache`` is anything with a ``tuned_samples() -> [KernelSample]``
        method (``kernels.autotune.AutotuneCache``) or a plain sample
        sequence. The tuned timings are fit to roofline constants
        (``fit_calibration``, noise-weighted) and the (m, n) grid is built
        eagerly from the resulting ``CalibratedOracle`` — so every scheduler
        pricing through this oracle prices the kernels *as tuned*. The fit
        is exposed as ``.calibration`` for CI gating (tuned-grid pricing
        must stay within the calibration tolerance of re-measured tuned
        kernels — see ``benchmarks/autotune_sweep.py``).
        """
        samples = (cache.tuned_samples() if hasattr(cache, "tuned_samples")
                   else list(cache))
        cal = fit_calibration(system, samples, fit_sat_ctx=fit_sat_ctx)
        oracle = cls(cfg, CalibratedOracle([cal]), m_grid=m_grid,
                     n_grid=n_grid)
        oracle.add_table(system, oracle._build(system, batch), batch)
        oracle.calibration = cal
        return oracle

    def _build(self, system: SystemProfile, batch: int) -> PhaseTable:
        M, N = len(self.m_grid), len(self.n_grid)
        tp = np.zeros((M, N))
        td = np.zeros((M, N))
        up = np.zeros((M, N))
        ud = np.zeros((M, N))
        for i, m in enumerate(self.m_grid):
            for j, n in enumerate(self.n_grid):
                ph = self.base.phases(self.cfg, int(m), int(n), system, batch)
                tp[i, j] = ph.t_prefill / max(m, 1.0)
                td[i, j] = ph.t_decode / max(n, 1.0)
                up[i, j] = ph.util_prefill
                ud[i, j] = ph.util_decode
        oh = self.base.phases(self.cfg, int(self.m_grid[0]),
                              int(self.n_grid[0]), system, batch).t_overhead
        return PhaseTable(self.m_grid, self.n_grid, tp, td, up, ud, oh)

    def phases(self, cfg: ModelConfig, m: int, n: int, system: SystemProfile,
               batch: int = 1) -> QueryPhases:
        if cfg != self.cfg:
            raise ValueError(f"TableOracle built for {self.cfg.name!r}, "
                             f"asked to price {cfg.name!r} (or a same-name "
                             "variant with different dimensions)")
        key = (system, batch)
        table = self._tables.get(key)
        if table is None:
            table = self._build(system, batch)
            self._tables[key] = table
        tp_tok, td_tok, up, ud = table.interp(m, n)
        return QueryPhases(t_prefill=tp_tok * m, t_decode=td_tok * n,
                           t_overhead=table.t_overhead,
                           util_prefill=up, util_decode=ud)

    def __repr__(self) -> str:
        return (f"TableOracle(cfg={self.cfg.name!r}, "
                f"grid={len(self.m_grid)}x{len(self.n_grid)}, "
                f"tables={len(self._tables)})")


# --------------------------------------------------------- calibrated oracle
@dataclass(frozen=True)
class KernelSample:
    """One measured kernel invocation, with its analytic work counts.

    ``flops``/``bytes`` are the kernel's arithmetic and memory traffic for the
    timed shape; ``ctx`` is the context length that drives the profile's
    saturation degradation (0 for context-independent kernels such as the
    SSD scan, whose running state is constant-size).
    """
    kernel: str                 # "flash_attention" | "decode_attention" | ...
    flops: float
    bytes: float
    ctx: float
    t_s: float                  # measured wall seconds (best-of-k)
    noise_frac: float = 0.0     # (median - best) / best across the k reps


@dataclass(frozen=True)
class Calibration:
    """Fitted roofline constants for one ``SystemProfile``."""
    profile: str
    compute_eff: float
    mem_eff: float
    sat_ctx: Optional[float]
    overhead_s: float
    fit_rel_rmse: float         # sqrt(mean(((pred - t) / t)^2)) over samples
    n_samples: int
    source: str = "microbench"

    def apply(self, system: SystemProfile) -> SystemProfile:
        if system.name != self.profile:
            raise ValueError(f"calibration for {self.profile!r} applied to "
                             f"{system.name!r}")
        return replace(system, compute_eff=self.compute_eff,
                       mem_eff=self.mem_eff, sat_ctx=self.sat_ctx,
                       overhead_s=self.overhead_s)


def _predict(samples: Sequence[KernelSample], system: SystemProfile,
             ce: float, me: float, sat: Optional[float],
             overhead: float) -> np.ndarray:
    f = np.array([s.flops for s in samples])
    b = np.array([s.bytes for s in samples])
    ctx = np.array([s.ctx for s in samples])
    base = np.maximum(f / (system.instance_peak_flops * ce),
                      b / (system.instance_hbm_bw * me))
    if sat is not None:
        base = base * (1.0 + ctx / sat)
    return overhead + base


def _rel_rmse(pred: np.ndarray, t: np.ndarray) -> float:
    return float(np.sqrt(np.mean(((pred - t) / t) ** 2)))


def fit_calibration(system: SystemProfile, samples: Sequence[KernelSample], *,
                    fit_sat_ctx: bool = True,
                    refine_rounds: int = 3) -> Calibration:
    """Least-squares fit of (compute_eff, mem_eff, sat_ctx, overhead_s).

    The model ``t = overhead + max(F/(peak*ce), B/(bw*me)) * (1 + ctx/sat)``
    is nonlinear in (ce, me, sat), so those are found by a deterministic
    coarse-to-fine log-grid search; ``overhead`` has a closed form given the
    rest (weighted least squares on relative error, clipped at >= 0). The
    objective is relative RMSE, so short and long kernels weigh equally.

    Samples carrying measurement noise (``KernelSample.noise_frac`` from the
    microbench best-of-k spread) are down-weighted in the search objective by
    1/(1+noise)^2 — a noisy cell steers the fit less. The *reported*
    ``fit_rel_rmse`` stays unweighted so recovery bounds keep their meaning
    (and synthetic samples, noise 0, fit exactly as before).
    """
    if not samples:
        raise ValueError("need at least one KernelSample to calibrate")
    t = np.array([s.t_s for s in samples])
    if np.any(t <= 0):
        raise ValueError("measured times must be positive")
    noise = np.array([max(0.0, getattr(s, "noise_frac", 0.0)) for s in samples])
    wgt = 1.0 / (1.0 + noise) ** 2

    def overhead_for(ce: float, me: float, sat: Optional[float]) -> float:
        base = _predict(samples, system, ce, me, sat, 0.0)
        w = wgt / t ** 2
        return float(max(0.0, np.sum(w * (t - base)) / np.sum(w)))

    def weighted_err(pred: np.ndarray) -> float:
        r2 = ((pred - t) / t) ** 2
        return float(np.sqrt(np.sum(wgt * r2) / np.sum(wgt)))

    sat_grid: List[Optional[float]] = [None]
    if fit_sat_ctx:
        sat_grid += list(np.geomspace(32.0, 65536.0, 12))

    ce_grid = np.geomspace(1e-6, 1.0, 25)
    me_grid = np.geomspace(1e-6, 1.0, 25)
    best = (float("inf"), 1.0, 1.0, None, 0.0)
    for _ in range(1 + refine_rounds):
        for ce in ce_grid:
            for me in me_grid:
                for sat in sat_grid:
                    oh = overhead_for(ce, me, sat)
                    err = weighted_err(_predict(samples, system, ce, me, sat, oh))
                    if err < best[0]:
                        best = (err, float(ce), float(me),
                                None if sat is None else float(sat), oh)
        # refine around the incumbent (keep sat candidates incl. None)
        _, ce0, me0, sat0, _ = best
        ce_grid = np.geomspace(ce0 / 3, min(1.0, ce0 * 3), 15)
        me_grid = np.geomspace(me0 / 3, min(1.0, me0 * 3), 15)
        if fit_sat_ctx and sat0 is not None:
            sat_grid = [None] + list(np.geomspace(sat0 / 3, sat0 * 3, 9))

    _, ce, me, sat, oh = best
    err = _rel_rmse(_predict(samples, system, ce, me, sat, oh), t)
    return Calibration(profile=system.name, compute_eff=ce, mem_eff=me,
                       sat_ctx=sat, overhead_s=oh, fit_rel_rmse=err,
                       n_samples=len(samples))


class CalibratedOracle:
    """Analytic roofline with per-profile fitted constants.

    Systems without a stored calibration fall back to their hand-tuned
    constants (``strict=True`` raises instead), so one oracle can price a
    mixed fleet where only some profiles have been measured.
    """

    name = "calibrated"

    def __init__(self, calibrations: Iterable[Calibration] = (), *,
                 strict: bool = False):
        self.calibrations: Dict[str, Calibration] = {
            c.profile: c for c in calibrations}
        self.strict = strict
        self._applied: Dict[SystemProfile, SystemProfile] = {}
        self.version = 0        # bumped on mutation so CostModel memos refresh

    def add(self, calibration: Calibration) -> None:
        self.calibrations[calibration.profile] = calibration
        self._applied = {s: a for s, a in self._applied.items()
                         if s.name != calibration.profile}
        self.version += 1

    def resolve(self, system: SystemProfile) -> SystemProfile:
        cal = self.calibrations.get(system.name)
        if cal is None:
            if self.strict:
                raise KeyError(f"no calibration for profile {system.name!r}")
            return system
        hit = self._applied.get(system)
        if hit is None:
            hit = cal.apply(system)
            self._applied[system] = hit
        return hit

    def phases(self, cfg: ModelConfig, m: int, n: int, system: SystemProfile,
               batch: int = 1) -> QueryPhases:
        return query_phases(cfg, m, n, self.resolve(system), batch)

    def phases_batch(self, cfg: ModelConfig, m, n, system: SystemProfile,
                     batch: int = 1) -> BatchPhases:
        """Vectorized ``phases``: resolve the calibrated profile once, then
        evaluate the roofline over arrays (bit-identical elementwise)."""
        return query_phases_batch(cfg, m, n, self.resolve(system), batch)

    # ------------------------------------------------------------- artifacts
    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"calibrations": [asdict(c) for c in
                                        self.calibrations.values()]},
                      f, indent=2, sort_keys=True)

    @classmethod
    def load(cls, path: str, *, strict: bool = False) -> "CalibratedOracle":
        with open(path) as f:
            data = json.load(f)
        return cls([Calibration(**c) for c in data["calibrations"]],
                   strict=strict)

    def __repr__(self) -> str:
        return f"CalibratedOracle(profiles={sorted(self.calibrations)})"


# ------------------------------------------------------------- kv migration
def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: float = 4.0) -> float:
    """Resident KV-cache footprint per token in the paged serving pools.

    This is the *stored* state a disaggregated handoff must move (K and V for
    every layer at the pool dtype — float32 by default, matching
    ``models.model.init_paged_cache``), not the per-token *read* traffic of
    ``perf_model.kv_bytes_per_token_ctx``. Attention-free stacks keep a
    constant-size SSM state instead of per-token KV; migration for them is
    priced at the same per-token rate over the head geometry they declare.
    """
    return 2.0 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim \
        * dtype_bytes


# ---------------------------------------------------------------- cost model
class CostModel:
    """Single pricing front-end: Eq. 1 + normalizers + optional carbon term.

    ``quant`` rounds (m, n) to multiples of that many tokens before the memo
    lookup — set > 1 on simulation hot paths (fleet sweeps) to trade exact
    per-query pricing for a high cache-hit rate. The default (1) is exact, so
    every historical call path is reproduced bit-for-bit under the analytic
    oracle.
    """

    def __init__(self, cfg: ModelConfig, oracle: Optional[PerfOracle] = None,
                 cp: CostParams = CostParams(), *,
                 carbon: Optional["CarbonProfile"] = None,
                 quant: int = 1, memo_size: int = 65536):
        if quant < 1:
            raise ValueError(f"quant must be >= 1, got {quant}")
        self.cfg = cfg
        self.oracle: PerfOracle = oracle if oracle is not None else AnalyticOracle()
        self.cp = cp
        self.carbon = carbon
        self.quant = int(quant)
        self.memo_size = int(memo_size)
        # keyed by the SystemProfile OBJECT (frozen/hashable), not its name:
        # replace()-built variants sharing a name must not collide
        self._memo: "OrderedDict[Tuple[SystemProfile, int, int, int], QueryPhases]" = \
            OrderedDict()
        self._oracle_version = getattr(self.oracle, "version", 0)
        self.memo_hits = 0
        self.memo_misses = 0

    # ------------------------------------------------------------ construction
    @classmethod
    def normalized(cls, cfg: ModelConfig, ref: SystemProfile, lam: float, *,
                   oracle: Optional[PerfOracle] = None, m: int = 128,
                   n: int = 128, carbon: Optional["CarbonProfile"] = None,
                   quant: int = 1) -> "CostModel":
        """CostParams scaled so E and R are O(1) on ``ref`` at a
        representative query size — lambda becomes a true preference."""
        probe = cls(cfg, oracle)
        cp = CostParams(lam=lam,
                        e_norm=max(probe.energy(m, n, ref), 1e-9),
                        r_norm=max(probe.runtime(m, n, ref), 1e-9))
        return cls(cfg, probe.oracle, cp, carbon=carbon, quant=quant)

    def with_params(self, cp: CostParams) -> "CostModel":
        """Same oracle/memo policy, different Eq. 1 parameters."""
        return CostModel(self.cfg, self.oracle, cp, carbon=self.carbon,
                         quant=self.quant, memo_size=self.memo_size)

    # ---------------------------------------------------------------- pricing
    def _q(self, x: int) -> int:
        # Small token counts stay exact (few distinct keys anyway, and a
        # lognormal workload is densest there, where one bucket width is a
        # large *relative* perturbation); only the sparse large values are
        # bucketed, where quant/x is small.
        if self.quant == 1 or x <= 8 * self.quant:
            return int(x)
        return max(1, int(round(x / self.quant)) * self.quant)

    def phases(self, m: int, n: int, s: SystemProfile,
               batch: int = 1) -> QueryPhases:
        version = getattr(self.oracle, "version", 0)
        if version != self._oracle_version:   # oracle mutated (new tables /
            self._memo.clear()                # calibrations): drop stale phases
            self._oracle_version = version
        key = (s, self._q(m), self._q(n), batch)
        hit = self._memo.get(key)
        if hit is not None:
            self.memo_hits += 1
            self._memo.move_to_end(key)
            return hit
        self.memo_misses += 1
        ph = self.oracle.phases(self.cfg, key[1], key[2], s, batch)
        self._memo[key] = ph
        if len(self._memo) > self.memo_size:
            self._memo.popitem(last=False)
        return ph

    def _q_batch(self, x: np.ndarray) -> np.ndarray:
        """Vectorized ``_q`` (same values: numpy round is banker's, like
        Python's)."""
        x = np.asarray(x).astype(np.int64)
        if self.quant == 1:
            return x
        bucketed = np.maximum(
            1, np.round(x / self.quant).astype(np.int64) * self.quant)
        return np.where(x <= 8 * self.quant, x, bucketed)

    def price_batch(self, m, n, s: SystemProfile,
                    batch: int = 1) -> BatchPhases:
        """Vectorized ``phases`` over aligned (m, n) arrays: quantize, then
        evaluate Eq. 1's roofline terms in one numpy pass, bypassing the
        per-call LRU memo. Elementwise bit-identical to ``phases`` (asserted
        in tests/test_fleet_vec.py). Oracles without a ``phases_batch``
        method (e.g. ``TableOracle``) fall back to deduplicated scalar calls,
        which preserves bit-identity at reduced speed."""
        version = getattr(self.oracle, "version", 0)
        if version != self._oracle_version:
            self._memo.clear()
            self._oracle_version = version
        qm = self._q_batch(m)
        qn = self._q_batch(n)
        fn = getattr(self.oracle, "phases_batch", None)
        if fn is not None:
            return fn(self.cfg, qm, qn, s, batch)
        # scalar fallback: one oracle call per distinct quantized (m, n) pair
        pairs = np.stack([qm, qn], axis=1)
        uniq, inverse = np.unique(pairs, axis=0, return_inverse=True)
        fields = np.empty((5, len(uniq)), dtype=np.float64)
        for i, (um, un) in enumerate(uniq):
            ph = self.oracle.phases(self.cfg, int(um), int(un), s, batch)
            fields[:, i] = (ph.t_prefill, ph.t_decode, ph.t_overhead,
                            ph.util_prefill, ph.util_decode)
        t_pf, t_dec, t_ov, u_pf, u_dec = fields[:, inverse]
        return BatchPhases(t_prefill=t_pf, t_decode=t_dec, t_overhead=t_ov,
                           util_prefill=u_pf, util_decode=u_dec)

    def runtime_batch(self, m, n, s: SystemProfile,
                      batch: int = 1) -> np.ndarray:
        """Vectorized ``runtime`` (same association as ``QueryPhases.total``)."""
        return self.price_batch(m, n, s, batch).total

    def energy_batch(self, m, n, s: SystemProfile,
                     batch: int = 1) -> np.ndarray:
        """Vectorized ``energy`` — same accumulation order as the scalar
        path: prefill, then decode, then overhead."""
        ph = self.price_batch(m, n, s, batch)

        def power_w(util: np.ndarray) -> np.ndarray:
            u = np.minimum(np.maximum(util, 0.0), 1.0)
            return s.chips * (s.power_idle_w
                              + (s.power_peak_w - s.power_idle_w) * u)

        e_j = ph.t_prefill * power_w(ph.util_prefill)
        e_j = e_j + ph.t_decode * power_w(ph.util_decode)
        e_j = e_j + ph.t_overhead * s.power(0.0)
        return e_j

    def runtime(self, m: int, n: int, s: SystemProfile, batch: int = 1) -> float:
        """R(m, n, s) in seconds (Eq. 1's runtime term)."""
        return self.phases(m, n, s, batch).total

    def energy(self, m: int, n: int, s: SystemProfile, batch: int = 1) -> float:
        """E(m, n, s) in joules (Eq. 1's energy term)."""
        ph = self.phases(m, n, s, batch)
        e_j = ph.t_prefill * s.power(ph.util_prefill)
        e_j += ph.t_decode * s.power(ph.util_decode)
        e_j += ph.t_overhead * s.power(0.0)
        return e_j

    def cost(self, m: int, n: int, s: SystemProfile, *, batch: int = 1,
             wait_s: float = 0.0, t_exec: Optional[float] = None) -> float:
        """U = lam*E/e_norm + (1-lam)*R/r_norm, plus optional terms:

        * ``wait_s``  — queueing delay priced on the runtime side (the
          capacity-aware policies' objective);
        * ``t_exec``  — when a ``CarbonProfile`` is attached, modulates the
          energy term by CI(t_exec)/CI_mean so lambda trades *carbon*
          against runtime while the normalizers keep their meaning.
        """
        cp = self.cp
        eterm = self.energy(m, n, s, batch) / cp.e_norm
        if t_exec is not None and self.carbon is not None:
            eterm *= (self.carbon.intensity(t_exec)
                      / self.carbon.mean_g_per_kwh)
        rterm = self.runtime(m, n, s, batch) / cp.r_norm
        c = cp.lam * eterm + (1.0 - cp.lam) * rterm
        if wait_s:
            c += (1.0 - cp.lam) * wait_s / cp.r_norm
        return c

    def cost_batch(self, m, n, s: SystemProfile, *, batch: int = 1,
                   wait_s: float = 0.0,
                   t_exec: Optional[float] = None) -> np.ndarray:
        """Vectorized ``cost`` over aligned (m, n) arrays — same term order
        and association as the scalar path, so each element is bit-identical
        to the corresponding ``cost`` call."""
        cp = self.cp
        eterm = self.energy_batch(m, n, s, batch) / cp.e_norm
        if t_exec is not None and self.carbon is not None:
            eterm = eterm * (self.carbon.intensity(t_exec)
                             / self.carbon.mean_g_per_kwh)
        rterm = self.runtime_batch(m, n, s, batch) / cp.r_norm
        c = cp.lam * eterm + (1.0 - cp.lam) * rterm
        if wait_s:
            c = c + (1.0 - cp.lam) * wait_s / cp.r_norm
        return c

    def wait_cost(self, wait_s: float) -> float:
        """The runtime-side price of queueing delay alone."""
        return (1.0 - self.cp.lam) * wait_s / self.cp.r_norm

    # ------------------------------------------------------------ phase split
    def split_energy(self, m: int, n: int, s: SystemProfile,
                     batch: int = 1) -> Tuple[float, float]:
        """(prefill-side J incl. per-query overhead, decode-side J).

        The disaggregated scheduler prices the two phases on *different*
        systems; each side here uses the same power model and operand order
        as ``energy`` so a non-split query's (e_pf + e_dec) differs from
        ``energy`` only by float re-association, never by modeling."""
        ph = self.phases(m, n, s, batch)
        e_pf_j = ph.t_prefill * s.power(ph.util_prefill) \
            + ph.t_overhead * s.power(0.0)
        e_dec_j = ph.t_decode * s.power(ph.util_decode)
        return e_pf_j, e_dec_j

    def split_runtime(self, m: int, n: int, s: SystemProfile,
                      batch: int = 1) -> Tuple[float, float]:
        """(prefill-side seconds incl. overhead, decode-side seconds)."""
        ph = self.phases(m, n, s, batch)
        return ph.t_overhead + ph.t_prefill, ph.t_decode

    def split_energy_batch(self, m, n, s: SystemProfile,
                           batch: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized ``split_energy`` — elementwise bit-identical."""
        ph = self.price_batch(m, n, s, batch)

        def power_w(util: np.ndarray) -> np.ndarray:
            u = np.minimum(np.maximum(util, 0.0), 1.0)
            return s.chips * (s.power_idle_w
                              + (s.power_peak_w - s.power_idle_w) * u)

        e_pf_j = ph.t_prefill * power_w(ph.util_prefill) \
            + ph.t_overhead * s.power(0.0)
        e_dec_j = ph.t_decode * power_w(ph.util_decode)
        return e_pf_j, e_dec_j

    def split_runtime_batch(self, m, n, s: SystemProfile,
                            batch: int = 1) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized ``split_runtime`` — elementwise bit-identical."""
        ph = self.price_batch(m, n, s, batch)
        return ph.t_overhead + ph.t_prefill, ph.t_decode

    # ------------------------------------------------------------- migration
    def migration_bytes(self, m: int, *, block_size: int = 0) -> float:
        """Bytes a KV handoff of an m-token prefix moves, padded to whole
        blocks when the paged pools declare a ``block_size`` (block-table
        migration copies blocks, not tokens)."""
        tokens = -(-m // block_size) * block_size if block_size else m
        return tokens * kv_bytes_per_token(self.cfg)

    def migration_seconds(self, bytes_moved: float, src: SystemProfile,
                          dst: SystemProfile) -> float:
        """Wall seconds to move ``bytes_moved`` of KV from ``src`` to ``dst``:
        the inter-pool link transfer at the slower endpoint's advertised
        ``link_bw_gbps``, plus the device-side gather (src) and scatter (dst)
        through each endpoint's effective HBM bandwidth. Endpoints are
        resolved through the oracle's calibration when it has one, so a
        microbench KV-copy sample (``kernel == "kv_migrate"``) that refits
        ``mem_eff`` reprices the copy too. inf when either endpoint has no
        migration path."""
        link_gbps = min(src.link_bw_gbps, dst.link_bw_gbps)
        if link_gbps <= 0.0:
            return math.inf
        resolve = getattr(self.oracle, "resolve", None)
        rs = resolve(src) if resolve is not None else src
        rd = resolve(dst) if resolve is not None else dst
        t_s = bytes_moved / (link_gbps * 0.125e9)     # gigabits/s -> bytes/s
        t_s += bytes_moved / (rs.instance_hbm_bw * rs.mem_eff)
        t_s += bytes_moved / (rd.instance_hbm_bw * rd.mem_eff)
        return t_s

    def migration_energy(self, t_s: float, src: SystemProfile,
                         dst: SystemProfile) -> float:
        """J charged for a handoff window of ``t_s`` seconds: both endpoints
        held at their idle floor for the copy (conservative — the DMA engines
        draw little above idle, but the instances cannot sleep)."""
        return t_s * (src.power(0.0) + dst.power(0.0))

    def migration_terms(self, m: int, src: SystemProfile, dst: SystemProfile,
                        *, block_size: int = 0) -> Tuple[float, float, float]:
        """(bytes, seconds, joules) of migrating an m-token KV prefix.

        The single scalar path shared by the scheduler and BOTH fleet
        engines — one call site per decision keeps the engines bit-for-bit
        equivalent."""
        bytes_moved = self.migration_bytes(m, block_size=block_size)
        t_s = self.migration_seconds(bytes_moved, src, dst)
        return bytes_moved, t_s, self.migration_energy(t_s, src, dst)

    def grams(self, m: int, n: int, s: SystemProfile, t_exec: float,
              batch: int = 1) -> float:
        """gCO2 for executing (m, n) on s at time t_exec (requires carbon)."""
        if self.carbon is None:
            raise ValueError("CostModel has no CarbonProfile attached")
        return self.carbon.grams(self.energy(m, n, s, batch), t_exec)

    # ------------------------------------------------------------------ misc
    def memo_info(self) -> Dict[str, int]:
        return {"size": len(self._memo), "hits": self.memo_hits,
                "misses": self.memo_misses, "quant": self.quant}

    def clear_memo(self) -> None:
        self._memo.clear()
        self.memo_hits = self.memo_misses = 0

    def __repr__(self) -> str:
        return (f"CostModel(cfg={self.cfg.name!r}, oracle={self.oracle!r}, "
                f"lam={self.cp.lam}, quant={self.quant})")


# ----------------------------------------------------------- default pricing
_DEFAULT_MODELS: "OrderedDict[ModelConfig, CostModel]" = OrderedDict()
_DEFAULT_CACHE = 16


def default_cost_model(cfg: ModelConfig) -> CostModel:
    """Process-wide analytic CostModel per config — backs the free-function
    pricing views below (``energy``, ``cost``, ...) so they share one memo
    instead of re-deriving phases per call. Keyed by
    the (frozen, hashable) config OBJECT: ``cfg.reduced()`` keeps ``name``,
    so a name key would hand the reduced model the full model's prices."""
    model = _DEFAULT_MODELS.get(cfg)
    if model is None:
        model = CostModel(cfg, AnalyticOracle())
        _DEFAULT_MODELS[cfg] = model
        if len(_DEFAULT_MODELS) > _DEFAULT_CACHE:
            _DEFAULT_MODELS.popitem(last=False)
    else:
        _DEFAULT_MODELS.move_to_end(cfg)
    return model


# --------------------------------------------------- free-function pricing
# Folded in from the deleted ``core.cost`` / ``core.energy`` shim modules:
# thin free-function views over the shared per-config analytic CostModel
# (``default_cost_model``), bit-for-bit what those modules always returned.
# Offline analysis and the paper's Fig 1c/2c protocols use these; anything
# on a hot path should take a CostModel directly.
def cost(cfg: ModelConfig, m: int, n: int, s: SystemProfile,
         cp: CostParams = CostParams(), batch: int = 1) -> float:
    """Eq. 1: U(m, n, s) = lam * E/e_norm + (1 - lam) * R/r_norm."""
    model = default_cost_model(cfg)
    e = model.energy(m, n, s, batch) / cp.e_norm
    r = model.runtime(m, n, s, batch) / cp.r_norm
    return cp.lam * e + (1.0 - cp.lam) * r


def normalized_cost_params(cfg: ModelConfig, ref: SystemProfile,
                           lam: float, m: int = 128, n: int = 128) -> CostParams:
    """CostParams normalized so E and R are O(1) on the reference system at a
    representative query size — makes lambda behave as a true preference."""
    model = default_cost_model(cfg)
    return CostParams(lam=lam,
                      e_norm=max(model.energy(m, n, ref), 1e-9),
                      r_norm=max(model.runtime(m, n, ref), 1e-9))


def energy(cfg: ModelConfig, m: int, n: int, s: SystemProfile,
           batch: int = 1) -> float:
    """E(m, n, s) in joules (Eq. 1's energy term)."""
    return default_cost_model(cfg).energy(m, n, s, batch)


def energy_per_token_in(cfg: ModelConfig, m: int, s: SystemProfile,
                        n_out: int = 32) -> float:
    """J/token while varying input size (paper Fig 1c protocol: out fixed 32)."""
    return energy(cfg, m, n_out, s) / max(1, m)


def energy_per_token_out(cfg: ModelConfig, n: int, s: SystemProfile,
                         m_in: int = 32) -> float:
    """J/token while varying output size (paper Fig 2c protocol: in fixed 32)."""
    return energy(cfg, m_in, n, s) / max(1, n)


def crossover_threshold(cfg: ModelConfig, eff: SystemProfile, perf: SystemProfile,
                        *, axis: str = "in", lo: int = 1, hi: int = 4096) -> int:
    """Smallest token count where the performance system's J/token drops below
    the efficiency system's (the quantity the paper's T_in/T_out estimate)."""
    fn = energy_per_token_in if axis == "in" else energy_per_token_out
    for t in range(lo, hi + 1):
        if fn(cfg, t, perf) < fn(cfg, t, eff):
            return t
    return hi

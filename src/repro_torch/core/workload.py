"""Workload generation: Alpaca-like token-length distributions (paper Fig 3)
plus arrival processes for the discrete-event fleet simulator.

The paper uses the 52K-prompt Alpaca dataset's input/output token histograms
as the representative workload. Alpaca's measured moments: median input
~20-30 tokens with a long tail to ~1k (instruction+context), median output
~60-70 with a tail to ~600. We model both as clipped log-normals with those
moments; the distribution object also accepts arbitrary empirical histograms
so a real trace can be dropped in.

Arrival processes (all deterministic under a fixed seed):
  * poisson_arrivals   — homogeneous Poisson at rate_qps.
  * diurnal_arrivals   — nonhomogeneous Poisson with a sinusoidal rate
                         (day/night traffic), sampled by Lewis-Shedler thinning.
  * mmpp_arrivals      — 2-state Markov-modulated Poisson (bursty traffic:
                         calm/burst phases with exponential dwell times).
  * trace_arrivals     — empirical trace replay (arbitrary timestamp list).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True, slots=True)
class Query:
    m: int          # input tokens
    n: int          # output tokens
    arrival_s: float = 0.0


@dataclass(frozen=True)
class WorkloadSpec:
    mu_in: float = 3.2       # log-normal params for input tokens (median ~e^3.2=25)
    sigma_in: float = 0.95
    mu_out: float = 4.1      # median ~e^4.1=60
    sigma_out: float = 0.85
    max_in: int = 2048       # paper's measured ranges
    max_out: int = 4096
    rate_qps: float = 2.0    # arrival rate for capacity-aware scheduling


# ----------------------------------------------------------- arrival processes
def poisson_arrivals(n_queries: int, rate_qps: float, seed: int = 0) -> np.ndarray:
    """Homogeneous Poisson: iid exponential inter-arrival times."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_qps, n_queries))


def diurnal_arrivals(n_queries: int, rate_qps: float, seed: int = 0, *,
                     amplitude: float = 0.8,
                     period_s: float = 86_400.0,
                     phase: float = 0.0) -> np.ndarray:
    """Nonhomogeneous Poisson with rate(t) = rate_qps*(1 + amplitude*sin(...)).

    Lewis-Shedler thinning against the peak rate; amplitude in [0, 1) keeps
    the instantaneous rate positive. Mean rate over a full period is rate_qps.
    """
    if not 0.0 <= amplitude < 1.0:
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    rng = np.random.default_rng(seed)
    lam_max = rate_qps * (1.0 + amplitude)
    out = np.empty(n_queries)
    filled = 0
    t_s = 0.0
    while filled < n_queries:
        # Candidate block sized for the expected acceptance rate
        # 1/(1 + amplitude), with margin. Deterministic in (n_queries,
        # filled, amplitude), so the per-seed stream is reproducible
        # (pinned by a golden-sequence test).
        block = max(1024, int(1.25 * (n_queries - filled) * (1.0 + amplitude)))
        cand = t_s + np.cumsum(rng.exponential(1.0 / lam_max, block))
        lam_t = rate_qps * (1.0 + amplitude * np.sin(2 * np.pi * cand / period_s + phase))
        kept = cand[rng.uniform(size=block) * lam_max <= lam_t]
        take = min(kept.size, n_queries - filled)
        out[filled:filled + take] = kept[:take]
        filled += take
        t_s = float(cand[-1])
    return out


def mmpp_arrivals(n_queries: int, rate_qps: float, seed: int = 0, *,
                  burst_factor: float = 8.0,
                  burst_fraction: float = 0.1,
                  mean_dwell_s: float = 30.0) -> np.ndarray:
    """2-state MMPP: a calm state and a burst state at burst_factor x the calm
    rate. burst_fraction is the long-run fraction of time in the burst state;
    rates are chosen so the long-run mean arrival rate equals rate_qps.
    Dwell times are exponential with mean mean_dwell_s in each state (scaled
    by occupancy so the stationary split matches burst_fraction).
    """
    rng = np.random.default_rng(seed)
    # stationary: pi_burst = burst_fraction. Mean rate = pi_c*lam_c + pi_b*lam_b.
    lam_calm = rate_qps / (1.0 - burst_fraction + burst_fraction * burst_factor)
    lam_burst = burst_factor * lam_calm
    lam_max = max(lam_calm, lam_burst)
    # Exponential dwell means, scaled so the stationary split is
    # burst_fraction; the state timeline is a cumsum of alternating dwells
    # (state 0 first), and state(t) = (#switch-edges <= t) mod 2.
    dwell_means = (mean_dwell_s * 2 * (1.0 - burst_fraction),
                   mean_dwell_s * 2 * burst_fraction)
    edge_chunks: list[np.ndarray] = []
    edge_end_s = 0.0
    n_edges = 0

    def extend_edges(horizon_s: float) -> np.ndarray:
        nonlocal edge_end_s, n_edges
        while edge_end_s <= horizon_s:
            k = 256
            means = np.where((np.arange(k) + n_edges) % 2 == 0,
                             dwell_means[0], dwell_means[1])
            chunk = edge_end_s + np.cumsum(rng.exponential(1.0, k) * means)
            edge_chunks.append(chunk)
            edge_end_s = float(chunk[-1])
            n_edges += k
        return np.concatenate(edge_chunks)

    # Thin candidates drawn at lam_max against the piecewise-constant state
    # rate (exact for an MMPP). Candidate blocks sized for the expected
    # acceptance rate rate_qps/lam_max, deterministic in (n_queries, filled).
    out = np.empty(n_queries)
    filled = 0
    t_s = 0.0
    while filled < n_queries:
        block = max(1024, int(1.25 * (n_queries - filled) * lam_max / rate_qps))
        cand = t_s + np.cumsum(rng.exponential(1.0 / lam_max, block))
        edges = extend_edges(float(cand[-1]))
        burst = np.searchsorted(edges, cand, side="right") % 2 == 1
        lam_t = np.where(burst, lam_burst, lam_calm)
        kept = cand[rng.uniform(size=block) * lam_max <= lam_t]
        take = min(kept.size, n_queries - filled)
        out[filled:filled + take] = kept[:take]
        filled += take
        t_s = float(cand[-1])
    return out


def trace_arrivals(times: Sequence[float]) -> np.ndarray:
    """Empirical trace replay: validates and sorts a list of timestamps."""
    arr = np.asarray(times, dtype=float)
    if arr.ndim != 1:
        raise ValueError("trace must be a 1-D sequence of timestamps")
    if np.any(arr < 0):
        raise ValueError("trace timestamps must be non-negative")
    return np.sort(arr)


ARRIVAL_PROCESSES = ("poisson", "diurnal", "mmpp", "trace")


def generate_arrivals(n_queries: int, rate_qps: float, seed: int = 0, *,
                      process: str = "poisson",
                      trace: Optional[Sequence[float]] = None,
                      **kwargs) -> np.ndarray:
    """Dispatch to one of the named arrival processes."""
    if process == "poisson":
        return poisson_arrivals(n_queries, rate_qps, seed, **kwargs)
    if process == "diurnal":
        return diurnal_arrivals(n_queries, rate_qps, seed, **kwargs)
    if process == "mmpp":
        return mmpp_arrivals(n_queries, rate_qps, seed, **kwargs)
    if process == "trace":
        if trace is None:
            raise ValueError("process='trace' requires a trace= timestamp list")
        arr = trace_arrivals(trace)
        if len(arr) < n_queries:
            raise ValueError(f"trace has {len(arr)} stamps < {n_queries} queries")
        return arr[:n_queries]
    raise ValueError(f"unknown arrival process {process!r}; "
                     f"choose from {ARRIVAL_PROCESSES}")


def sample_workload(n_queries: int, seed: int = 0,
                    spec: WorkloadSpec = WorkloadSpec(), *,
                    arrival_process: str = "poisson",
                    trace: Optional[Sequence[float]] = None,
                    **arrival_kwargs) -> list[Query]:
    rng = np.random.default_rng(seed)
    m = np.clip(np.round(rng.lognormal(spec.mu_in, spec.sigma_in, n_queries)),
                1, spec.max_in).astype(int)
    n = np.clip(np.round(rng.lognormal(spec.mu_out, spec.sigma_out, n_queries)),
                1, spec.max_out).astype(int)
    arrivals = generate_arrivals(n_queries, spec.rate_qps, seed + 1,
                                 process=arrival_process, trace=trace,
                                 **arrival_kwargs)
    return [Query(int(mi), int(ni), float(a)) for mi, ni, a in zip(m, n, arrivals)]


def token_histogram(queries: Sequence[Query], axis: str = "in",
                    bins: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(frequencies f(x), bin_centers) — the f_in/f_out of paper Eqs. 9-10."""
    vals = np.array([q.m if axis == "in" else q.n for q in queries])
    if bins is None:
        bins = np.arange(1, vals.max() + 2)
    freq, edges = np.histogram(vals, bins=bins)
    centers = edges[:-1]
    return freq, centers


def alpaca_like(n_queries: int = 52_000, seed: int = 0) -> list[Query]:
    """The paper's evaluation workload (52K prompts)."""
    return sample_workload(n_queries, seed)

"""Frozen copies of the served package's traffic generators
(``repro_torch/core/workload.py``: ``WorkloadSpec``'s Alpaca-like
log-normal lengths and ``poisson_arrivals``), kept here so that a change
to the program cannot move the yardstick; plus the on-off Poisson process
with fixed phases that the bursty mixes use.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class WorkloadSpec:
    mu_in: float = 3.2       # log-normal params for input tokens (median ~25)
    sigma_in: float = 0.95
    mu_out: float = 4.1      # median ~60
    sigma_out: float = 0.85
    max_in: int = 2048
    max_out: int = 4096


def sample_lengths(n_queries: int, seed: int, spec: WorkloadSpec):
    """(m, n) int arrays: the log-normals rounded and clipped to [1, max],
    drawn as ``sample_workload`` draws them."""
    rng = np.random.default_rng(seed)
    m = np.clip(np.round(rng.lognormal(spec.mu_in, spec.sigma_in, n_queries)),
                1, spec.max_in).astype(int)
    n = np.clip(np.round(rng.lognormal(spec.mu_out, spec.sigma_out,
                                       n_queries)),
                1, spec.max_out).astype(int)
    return m, n


def poisson_arrivals(n_queries: int, rate_qps: float, seed: int = 0):
    """Homogeneous Poisson: iid exponential inter-arrival times."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_qps, n_queries))


def onoff_time(u: np.ndarray, rate_qps: float, calm_s: float, burst_s: float,
               burst_factor: float) -> np.ndarray:
    """Times at cumulative intensity ``u`` of an on-off Poisson process with
    fixed phases: each period is ``calm_s`` at the calm rate, then
    ``burst_s`` at ``burst_factor`` times it, with the mean rate
    ``rate_qps``. Unit-rate arrival times mapped through this are that
    process's arrivals (time rescaling)."""
    period = calm_s + burst_s
    calm = rate_qps * period / (calm_s + burst_factor * burst_s)
    burst = burst_factor * calm
    per = rate_qps * period                     # intensity of one period
    k = np.floor(u / per)
    rem = u - k * per
    in_calm = rem <= calm * calm_s
    tau = np.where(in_calm, rem / calm, calm_s + (rem - calm * calm_s) / burst)
    return k * period + tau

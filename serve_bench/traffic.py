"""The one traffic generator: it reads a mix's file (``traffic/<name>.json``)
and makes the requests of one run from ``--seed``.

Every seed gets the same arrival times and the same request sizes (both
drawn once from the mix's ``pool_seed``, the sizes in a fixed pool
order); the seed shuffles the sizes within each block of ``shuffle``
consecutive arrivals, blocks cut at the ramp's end, the horizon and,
for an on-off mix, every phase's edge, so that the ramp, the window and
each calm spell and burst keep their multiset, and draws the prompt
ids. So seeds change which request comes when, a little, and never how
much work the window or a burst offers or when it arrives.

Mix keys: ``lengths`` (``WorkloadSpec`` fields), ``arrivals`` (``process``
``poisson`` with ``rate_qps``, or ``onoff`` with ``rate_qps``, ``calm_s``,
``burst_s``, ``burst_factor``), ``pool`` (requests in the multiset),
``pool_seed``, ``shuffle`` (the block a seed shuffles sizes within),
``ramp_s`` (traffic before the window, part of set-up),
``trace_slice_s`` (the profiled slice at the window's end).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from serve_bench import workload_copy as W

PROCESSES = ("poisson", "onoff")


@dataclass
class Req:
    idx: int
    due: float                  # seconds from the start of the ramp
    m: int
    n: int
    prompt: np.ndarray          # (m,) int32
    # filled by the serve loop
    submit_t: Optional[float] = None
    pool: Optional[str] = None
    req: object = None          # the program's Request
    failed: Optional[str] = None
    first_t: Optional[float] = None
    last_t: Optional[float] = None
    done_t: Optional[float] = None
    leave_t: Optional[float] = None
    seen: int = 0
    stamps: List[float] = field(default_factory=list)


def validate(mix: Dict) -> None:
    W.WorkloadSpec(**mix["lengths"])
    a = mix["arrivals"]
    if a.get("process") not in PROCESSES:
        raise ValueError(f"arrival process {a.get('process')!r} not in "
                         f"{PROCESSES}")
    if not a["rate_qps"] > 0:
        raise ValueError("rate_qps must be positive")
    for k in ("pool", "pool_seed", "shuffle", "ramp_s", "trace_slice_s"):
        if k not in mix:
            raise ValueError(f"traffic mix lacks {k!r}")


def arrival_times(units: np.ndarray, a: Dict,
                  rate_qps: Optional[float] = None) -> np.ndarray:
    rate = rate_qps if rate_qps is not None else a["rate_qps"]
    if a["process"] == "poisson":
        return units / rate
    return W.onoff_time(units, rate, a["calm_s"], a["burst_s"],
                        a["burst_factor"])


def phase_edges(a: Dict, horizon_s: float) -> List[float]:
    """An on-off mix's phase edges before ``horizon_s`` (each burst's
    start and end); none for Poisson."""
    if a["process"] != "onoff":
        return []
    period = a["calm_s"] + a["burst_s"]
    out, k = [], 0
    while k * period < horizon_s:
        out += [k * period + a["calm_s"], (k + 1) * period]
        k += 1
    return [t for t in out if t < horizon_s]


def schedule(mix: Dict, seed: int, rate_qps: Optional[float] = None,
             cuts=()):
    """The whole pool of one seed: (due times, m, n) in due order, and the
    seed's generator (for the prompt ids). ``cuts``: times no shuffle
    block straddles."""
    validate(mix)
    k = int(mix["pool"])
    spec = W.WorkloadSpec(**mix["lengths"])
    m_all, n_all = W.sample_lengths(k, mix["pool_seed"], spec)
    gaps = np.diff(W.poisson_arrivals(k, 1.0, mix["pool_seed"] + 1),
                   prepend=0.0)
    due = arrival_times(np.cumsum(gaps), mix["arrivals"], rate_qps)
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    edges = sorted({0, k, *np.searchsorted(due, cuts).tolist()})
    order = np.arange(k)
    b = int(mix["shuffle"])
    for lo, hi in zip(edges, edges[1:]):
        for s in range(lo, hi, b):
            e = min(hi, s + b)
            order[s:e] = s + rng.permutation(e - s)
    return due, m_all[order], n_all[order], rng


def make_requests(mix: Dict, seed: int, vocab: int, horizon_s: float,
                  rate_qps: Optional[float] = None) -> List[Req]:
    """The requests due before ``horizon_s``, in due order; shuffle blocks
    cut at the ramp's end, at the horizon and at the phases' edges."""
    cuts = (mix["ramp_s"], horizon_s,
            *phase_edges(mix["arrivals"], horizon_s))
    due, m, n, rng = schedule(mix, seed, rate_qps, cuts=cuts)
    if due[-1] < horizon_s:
        raise ValueError(f"pool of {len(due)} requests ends at "
                         f"{due[-1]:.1f} s, before the horizon {horizon_s} s")
    out = []
    for i in range(len(due)):
        if due[i] >= horizon_s:
            break
        prompt = rng.integers(0, vocab, size=int(m[i]), dtype=np.int32)
        out.append(Req(i, float(due[i]), int(m[i]), int(n[i]), prompt))
    return out

"""One run of one cell: the served package built from the cell's
configuration, an open-loop load generator in front of its FleetRouter,
the window, and what the run reports.

The serve loop hands each request to ``FleetRouter.submit`` at its due
time, runs each busy pool's batcher ``step()`` in turn, and after each
tick reads every in-flight ``Request.out_tokens``: the tick ends in the
program's own host sync, so a token seen then was emitted then. Latency
counts from the due time, so a request that waits behind a long tick is
late by that tick. Nothing drains inside the window.

With ``tracer`` set (``--trace 1``), spans of the benchmark's own are
kept around its calls into each layer (``router.submit``,
``batcher.step``, ``engine.*``; each also a ``record_function`` for the
profiler), and ``torch.profiler`` covers the window's last
``trace_slice_s`` seconds, started and stopped between ticks.
"""
from __future__ import annotations

import bisect
import gc
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from serve_bench.traffic import Req

clock = time.perf_counter
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------- program
@dataclass
class Program:
    engine: object
    router: object
    eff: str                    # the efficiency pool's name
    perf: str
    t_in: int


def model_config(cfg: Dict):
    from repro_torch.configs.base import ModelConfig, SSMConfig
    kw = dict(cfg["model"])
    if "ssm" in kw:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    return ModelConfig(name=cfg["name"], **kw)


def build(cfg: Dict, weights: Dict, device: torch.device) -> Program:
    """The system under test, as the configuration states it: one engine
    on the card, a FleetRouter over the fleet's pools, a batcher (and KV
    pool) for each."""
    from repro_torch.core import systems
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.router import FleetRouter
    mc = model_config(cfg)
    s, r = cfg["serving"], cfg["serving"]["router"]
    engine = InferenceEngine(mc, weights, max_len=s["max_len"],
                             dtype=DTYPES[cfg["dtype"]], device=device)
    eff, perf = getattr(systems, r["fleet"])()
    router = FleetRouter(mc, {eff.name: eff, perf.name: perf},
                         {eff.name: engine, perf.name: engine},
                         policy=r["policy"], t_in=r["t_in"], axis=r["axis"])
    if s["batcher"] == "paged":
        router.attach_batchers(slots=s["slots"], paged=True,
                               num_blocks=s["num_blocks"],
                               block_size=s["block_size"], chunk=s["chunk"])
    elif s["batcher"] == "dense":
        router.attach_batchers(slots=s["slots"], paged=False)
    else:
        raise ValueError(f"batcher {s['batcher']!r}")
    return Program(engine, router, eff.name, perf.name, r["t_in"])


def warm(prog: Program, cfg: Dict, vocab: int) -> None:
    """One short request to each pool (a prompt of 8 tokens, and one of a
    chunk and a half), run to the end: every step shape the cell serves
    is captured before the ramp."""
    rng = np.random.default_rng(0)
    long_m = max(prog.t_in + 1, cfg["serving"].get("chunk", 64) * 3 // 2)
    for m in (8, long_m):
        prog.router.submit(rng.integers(0, vocab, m, dtype=np.int32), 3)
    for _ in range(64):
        busy = [cb for cb in prog.router.batchers.values() if cb.busy]
        if not busy:
            return
        for cb in busy:
            cb.step()
    raise RuntimeError("the warm-up requests did not finish in 64 ticks")


# ----------------------------------------------------------------- trace
class Tracer:
    """Host spans around the benchmark's calls into each layer, engine-call
    records with the tokens each call computes, and queue-leave stamps."""

    def __init__(self, prog: Program, t0: float):
        from torch.profiler import record_function
        self.rf = record_function
        self.t0 = t0
        self.spans: List[Tuple[str, float, float, str]] = []
        self.calls: List[Tuple[str, str, float, float, object]] = []
        self.pool = ""
        self.queued: Dict[str, List[Req]] = {n: [] for n in
                                             prog.router.batchers}
        self.prefilled: Dict[int, int] = {}
        self.prog = prog
        self._wrap()

    def now(self) -> float:
        return clock() - self.t0

    def _wrap(self) -> None:
        prog, rf = self.prog, self.rf
        sub = prog.router.submit

        def submit(*a, **k):
            with rf("router.submit"):
                t = self.now()
                out = sub(*a, **k)
                self.spans.append(("router.submit", t, self.now(), ""))
            return out
        prog.router.submit = submit
        for name, cb in prog.router.batchers.items():
            def step(name=name, inner=cb.step):
                self.pool = name
                with rf("batcher.step"):
                    t = self.now()
                    inner()
                    t1 = self.now()
                self.spans.append(("batcher.step", t, t1, name))
                self.observe(t1)
            cb.step = step
        eng = prog.engine
        for kind in ("prefill_chunk", "decode_paged", "prefill", "decode"):
            def call(*a, kind=kind, inner=getattr(eng, kind), **k):
                t = self.now()
                self.observe(t)
                meta = getattr(self, "_meta_" + kind)(*a, **k)
                with rf("engine." + kind):
                    out = inner(*a, **k)
                self.calls.append((kind, self.pool, t, self.now(), meta))
                return out
            setattr(eng, kind, call)

    # what each engine call computes, from public state only
    def _cb(self):
        return self.prog.router.batchers[self.pool]

    def _meta_prefill_chunk(self, tokens, cache, lane, n_valid):
        req = self._cb().active[int(lane)]
        start = self.prefilled.get(id(req), 0)
        self.prefilled[id(req)] = start + int(n_valid)
        return (start, int(n_valid), start + int(n_valid) >= len(req.tokens))

    def _meta_decode_paged(self, tokens, cache, live):
        return [len(r.tokens) + len(r.out_tokens) for r in self._cb().active
                if r is not None and not r.hold and r.out_tokens]

    def _meta_prefill(self, batch, cache=None):
        return (0, int(batch["tokens"].shape[1]), True)

    def _meta_decode(self, tokens, cache):
        return [len(r.tokens) + len(r.out_tokens) for r in self._cb().active
                if r is not None]

    def submitted(self, r: Req) -> None:
        self.queued[r.pool].append(r)

    def observe(self, t: float) -> None:
        """Stamp requests that have left a batcher's queue since the last
        look (looks: each engine call's entry and each tick's end)."""
        for name, cb in self.prog.router.batchers.items():
            mine = self.queued[name]
            if len(cb.queue) < len(mine):
                still = {id(q) for q in cb.queue}
                for r in mine:
                    if id(r.req) not in still:
                        r.leave_t = t
                self.queued[name] = [r for r in mine if id(r.req) in still]


def kernel_counts() -> Dict[str, int]:
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS
    return {"flash_attention": FA.flash_attention.launches,
            "decode_attention": DA.decode_attention.launches,
            "paged_decode_attention": DA.paged_decode_attention.launches,
            "ssd_scan": SS.ssd_scan.launches}


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def warm_profiler(device: torch.device) -> None:
    """The profiler's first start loads CUPTI; pay that in set-up."""
    for _ in range(2):
        p = profiler()
        p.start()
        (torch.ones(8, device=device) * 2).sum().item()
        p.stop()


# ----------------------------------------------------------------- serve
@dataclass
class Served:
    reqs: List[Req]
    t0: float                   # clock() at the ramp's start
    ramp: float
    end: float                  # ramp + seconds
    gaps: List[float] = field(default_factory=list)   # ending in window
    e_t0: float = 0.0           # the energy interval (ramp-relative)
    e_t1: float = 0.0
    tokens_in_e: int = 0        # prompt + output tokens in that interval
    slice_t0: Optional[float] = None
    slice_t1: Optional[float] = None
    launches: Dict[str, int] = field(default_factory=dict)
    prof: object = None
    prof_start_s: float = 0.0
    ticks: int = 0
    most_active: Dict[str, int] = field(default_factory=dict)  # lanes
    most_queued: Dict[str, int] = field(default_factory=dict)
    most_rows: Dict[str, int] = field(default_factory=dict)    # tokens held


def serve(prog: Program, reqs: List[Req], ramp: float, seconds: float, *,
          device: torch.device, meter=None, trace: bool = False,
          slice_s: Optional[float] = None) -> Tuple[Served, Optional[Tracer]]:
    """The ramp, then the window. ``meter`` (energy) brackets the window;
    ``trace``: spans, and a profiled slice of ``slice_s`` at the window's
    end."""
    # what set-up made lives on: out of the collector's way (gc.freeze),
    # so no full collection walks it inside the window
    gc.collect()
    gc.freeze()
    t0 = clock()
    tracer = Tracer(prog, t0) if trace else None
    router = prog.router
    pools = list(router.batchers.items())
    inflight: Dict[str, List[Req]] = {n: [] for n, _ in pools}
    sv = Served(reqs, t0, ramp, ramp + seconds)
    in_energy = False
    i = 0
    while True:
        now = clock() - t0
        if now >= sv.end:
            break
        if meter is not None and not in_energy and now >= ramp:
            meter.start()
            sv.e_t0, in_energy = clock() - t0, True
        if tracer is not None and sv.prof is None and \
                now >= sv.end - slice_s:
            sync(device)
            sv.launches = kernel_counts()
            sv.prof = profiler()
            t_p = clock()
            sv.prof.start()
            sv.slice_t0 = clock() - t0
            sv.prof_start_s = clock() - t_p
        while i < len(reqs) and reqs[i].due <= now:
            r = reqs[i]
            i += 1
            r.submit_t = clock() - t0
            try:
                rr = router.submit(r.prompt, r.n, arrival_s=r.due)
            except Exception as e:          # a refused request is missing
                r.failed = f"{type(e).__name__}: {e}"
                continue
            r.req, r.pool = rr.request, rr.pool
            inflight[r.pool].append(r)
            if tracer is not None:
                tracer.submitted(r)
        ticked = False
        for name, cb in pools:
            if not cb.busy:
                continue
            q = len(cb.queue)
            cb.step()
            ticked = True
            sv.ticks += 1
            t = clock() - t0
            if ramp <= t < sv.end:
                live = [r for r in cb.active if r is not None]
                rows = sum(len(r.tokens) + len(r.out_tokens) for r in live)
                sv.most_active[name] = max(sv.most_active.get(name, 0),
                                           len(live))
                sv.most_rows[name] = max(sv.most_rows.get(name, 0), rows)
                sv.most_queued[name] = max(sv.most_queued.get(name, 0), q)
            _stamp(inflight[name], t, sv, in_energy)
        if not ticked:
            nxt = reqs[i].due if i < len(reqs) else sv.end
            wait = min(nxt, sv.end) - (clock() - t0)
            if wait > 0:
                if tracer is not None:
                    with tracer.rf("serve.idle"):
                        time.sleep(wait)
                else:
                    time.sleep(wait)
    if meter is not None:
        meter.stop()
        sv.e_t1 = clock() - t0
    if sv.prof is not None:
        sync(device)
        sv.slice_t1 = clock() - t0
        after = kernel_counts()
        sv.launches = {k: after[k] - sv.launches[k] for k in after}
        sv.prof.stop()
    return sv, tracer


def _stamp(lst: List[Req], t: float, sv: Served, in_energy: bool) -> None:
    keep = []
    for r in lst:
        k = len(r.req.out_tokens)
        if k > r.seen:
            new = k - r.seen
            windowed = sv.ramp <= t < sv.end
            if r.seen == 0:
                r.first_t = t
                if in_energy:
                    sv.tokens_in_e += r.m
            elif windowed:
                sv.gaps.append(t - r.last_t)
            if windowed:
                sv.gaps.extend([0.0] * (new - 1))
            if in_energy:
                sv.tokens_in_e += new
            r.stamps.extend([t] * new)
            r.last_t, r.seen = t, k
        if r.req.done:
            r.done_t = t
        else:
            keep.append(r)
    lst[:] = keep


def cache_use(cb, max_len: int, most_rows: int, most_lanes: int) -> str:
    """What a pool's cache holds against what it reserved: a paged pool's
    KV blocks at their peak (the allocator's own count, worst-case
    reservations at admission); a dense pool's rows in use at most
    (prompt and output tokens of its live lanes) and its per-lane state,
    against the ``max_len`` rows a lane it allocates."""
    nbytes = {k: v.numel() * v.element_size() for k, v in cb.cache.items()
              if torch.is_tensor(v)}
    total = sum(nbytes.values())
    if hasattr(cb, "stats"):
        st = cb.stats()
        kv = sum(nbytes[k] for k in ("kp", "vp", "kp_scale", "vp_scale")
                 if k in nbytes)
        per = kv / (st["total_blocks"] + 1)
        return (f"KV blocks at most {st['peak_used']} in use of "
                f"{st['total_blocks']} reserved ({st['peak_used'] * per:.0f} "
                f"of {total} cache bytes)")
    rowed = sum(n for k, n in nbytes.items()
                if cb.cache[k].dim() >= 2 and cb.cache[k].shape[-2] == max_len)
    state = total - rowed
    live = (rowed * most_rows / (cb.slots * max_len)
            + state * most_lanes / cb.slots)
    return (f"at most {most_rows} rows of {cb.slots * max_len} and "
            f"{most_lanes} lanes of {cb.slots} live: at most {live:.0f} of "
            f"{total} cache bytes")


# --------------------------------------------------------------- metrics
def p95(values: List[float]) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def window_reqs(sv: Served) -> List[Req]:
    return [r for r in sv.reqs if sv.ramp <= r.due < sv.end]


def ttfts(sv: Served) -> List[float]:
    """Seconds from due time to first token, for every request due in the
    window; none by the window's end (or refused): its age then."""
    out = []
    for r in window_reqs(sv):
        if r.first_t is not None and r.first_t < sv.end and r.failed is None:
            out.append(r.first_t - r.due)
        else:
            out.append(sv.end - r.due)
    return out


def lateness(sv: Served) -> Dict[str, float]:
    late = [r.submit_t - r.due for r in window_reqs(sv)
            if r.submit_t is not None]
    if not late:
        return {"p50_ms": 0.0, "max_ms": 0.0}
    return {"p50_ms": float(np.median(late)) * 1e3,
            "max_ms": float(max(late)) * 1e3}


# ------------------------------------------------------------ profile
@dataclass
class Profile:
    """The profiled slice. Device ops carry the host time of the runtime
    call that launched them (matched by CUPTI's correlation id; a CUDA
    graph's kernels carry its ``cudaGraphLaunch``), so a kernel is placed
    in a host span on the host's clock alone: the device's timestamps are
    used for durations and for overlaps among device ops only."""
    # (name, ts, dur, launch) of each kernel; (ts, end, launch) of every
    # device op (kernels, copies, fills)
    kernels: List[Tuple[str, float, float, Optional[float]]]
    device: List[Tuple[float, float, Optional[float]]]
    annotations: List[Tuple[str, float, float]]  # host record_function spans


def read_profile(prof) -> Profile:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    launch: Dict[int, float] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver"):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = float(e["ts"])
    kernels, device, ann = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            at = launch.get(e.get("args", {}).get("correlation"))
            device.append((ts, ts + dur, at))
            if cat == "kernel":
                kernels.append((e["name"], ts, dur, at))
        elif cat == "user_annotation":
            ann.append((e["name"], ts, dur))
    kernels.sort(key=lambda k: k[1])
    device.sort()
    return Profile(kernels, device, ann)


def spans_of(p: Profile, name: str) -> List[Tuple[float, float]]:
    """The host spans ``name``, sorted, as (start, end)."""
    return sorted((ts, ts + d) for n, ts, d in p.annotations if n == name)


def place(spans: List[Tuple[float, float]], t: Optional[float]) -> int:
    """The index of the sorted, disjoint span holding host time ``t``, or
    -1."""
    if t is None:
        return -1
    i = bisect.bisect_right([a for a, _ in spans], t) - 1
    return i if i >= 0 and t <= spans[i][1] else -1


def union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap(a: List[Tuple[float, float]], b: List[Tuple[float, float]]):
    """Total length of the intersection of two unions of intervals."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def short_name(name: str) -> str:
    """A kernel's name without its trailing argument list."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120]


def breakdown(p: Profile) -> Dict:
    """The device ops that took most time (summed by kernel name) and the
    longest idle gaps between device ops, each named by the innermost host
    span open when the op after it was launched: what the host was doing
    while the card waited."""
    by: Dict[str, float] = {}
    for n, _, d, _ in p.kernels:
        by[short_name(n)] = by.get(short_name(n), 0.0) + d * 1e-6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    gaps, end = [], None
    for ts, te, at in p.device:
        if end is not None and ts > end:
            gaps.append((ts - end, at))
        end = te if end is None else max(end, te)
    gaps.sort(key=lambda g: -g[0])
    out = []
    for g, at in gaps[:10]:
        open_ = [(ts, n) for n, ts, d in p.annotations
                 if at is not None and ts <= at <= ts + d]
        label = max(open_)[1] if open_ else (
            "serve.loop" if at is not None else "unmatched launch")
        out.append([label, g * 1e-6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": out}


@dataclass
class Trace:
    """What a per-layer metric's reader reads."""
    config: Dict                # the configuration file's contents
    served: Served
    spans: List[Tuple[str, float, float, str]]
    calls: List[Tuple[str, str, float, float, object]]
    profile: Profile
    launches: Dict[str, int]
    power_limit_w: Optional[float]

    @property
    def model(self) -> Dict:
        return self.config["model"]

    def in_window(self, t0: float, t1: float) -> bool:
        return self.served.ramp <= t0 and t1 <= self.served.end

    def in_slice(self, t0: float, t1: float) -> bool:
        return self.served.slice_t0 <= t0 and t1 <= self.served.slice_t1

    @property
    def slice_s(self) -> float:
        return self.served.slice_t1 - self.served.slice_t0


def free() -> None:
    """Collect what the caller dropped and give the card's memory back."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

"""The serving path's own tracing (``serving/trace.py``), on the CPU, through
``FleetRouter`` with paged and dense batchers on reduced smollm-360m:

* each request's ``times`` in order, one ``emitted`` stamp per token, and a
  first token seeded by the final prefill two stamps apart from the same
  tick's decoded second token;
* ``trace.TICKS``: one record per ``step()``, the lanes it decoded, its
  sync time inside its span, admission stopped on memory (``blocked``,
  also counted on the queue's head);
* spans: no ``record_function`` entered without a profiler; under one,
  every span name in the exported trace, nested as the serving path
  opens them; tokens, ``stats()`` and ``fleet_report()`` the same either
  way.
"""
import functools
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.systems import paper_fleet
from repro_torch.models import model as M
from repro_torch.serving import trace
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.router import FleetRouter

ARCH = "smollm-360m"


@functools.lru_cache(maxsize=None)
def _params():
    cfg = get_config(ARCH).reduced()
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(3))


def _router(paged, policy="threshold", num_blocks=32):
    cfg, params = _params()
    eng = InferenceEngine(cfg, params, max_len=64, device="cpu")
    eff, perf = paper_fleet()
    r = FleetRouter(cfg, {eff.name: eff, perf.name: perf},
                    {eff.name: eng, perf.name: eng}, policy=policy, t_in=32,
                    counts={eff.name: 4, perf.name: 1})
    if paged:
        r.attach_batchers(slots=2, paged=True, num_blocks=num_blocks,
                          block_size=16, chunk=16)
    else:
        r.attach_batchers(slots=2, paged=False)
    return r


def _prompts(n=5):
    """Short and long prompts (both pools), a long one over a chunk."""
    rng = np.random.default_rng(0)
    vocab = _params()[0].vocab_size
    return [rng.integers(0, vocab, size=m) for m in (9, 40, 5, 21, 35)[:n]]


def _tick(cb):
    """One step(); returns its record and the tokens each live request
    gained in it."""
    before = {id(r): len(r.out_tokens) for r in list(cb.active) + cb.queue
              if r is not None}
    reqs = [r for r in list(cb.active) + cb.queue if r is not None]
    n = len(trace.TICKS)
    cb.step()
    assert len(trace.TICKS) == n + 1
    return trace.TICKS[-1], [(before[id(r)], len(r.out_tokens))
                             for r in reqs]


def req_pool(router, req):
    return next(n for n, cb in router.batchers.items()
                if req in cb.queue or req in cb.active)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_times_are_ordered_one_stamp_a_token(paged):
    r = _router(paged)
    routed = [r.submit(p, 6) for p in _prompts()]
    r.drain()
    for rr in routed:
        req, t = rr.request, rr.request.times
        assert req.done and len(t.emitted) == len(req.out_tokens) == 6
        seq = [t.arrived, t.routed, t.booked, t.queued, t.admitted,
               *t.emitted, t.done]
        assert all(v is not None for v in seq)
        assert seq == sorted(seq)
        assert t.blocked == 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_first_and_second_token_of_one_tick_get_two_stamps(paged):
    """A one-chunk prompt: its final prefill seeds the first token and
    the same tick's decode emits the second, each after its own sync."""
    r = _router(paged)
    req = r.submit(_prompts(1)[0], 4).request
    cb = r.batchers[req_pool(r, req)]
    rec, gained = _tick(cb)
    assert gained == [(0, 2)] and rec.decode_lanes == 1
    a, b = req.times.emitted
    assert rec.start <= req.times.admitted <= a < b <= rec.end


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_one_tick_record_per_step(paged):
    r = _router(paged)
    r_all = [r.submit(p, 5).request for p in _prompts()]
    steps = 0
    for name, cb in r.batchers.items():
        while cb.busy:
            rec, gained = _tick(cb)
            steps += 1
            seeded = sum(1 for a, b in gained if a == 0 and b > 0)
            decoded = sum(b - a for a, b in gained) - seeded
            assert rec.pool == name
            assert rec.decode_lanes == decoded
            assert rec.admitted == sum(
                1 for q in r_all if q.times.admitted is not None
                and rec.start <= q.times.admitted <= rec.end)
            assert 0.0 <= rec.sync_s <= rec.end - rec.start
            assert (rec.sync_s > 0) == any(b > a for a, b in gained)
            assert rec.queued == len(cb.queue) and not rec.blocked
    assert steps >= 6


def test_admission_stopped_on_memory_is_logged():
    """Five usable blocks, three a request: the second waits at the head
    until the first retires."""
    r = _router(True, num_blocks=6)
    first, second = (r.submit(p, 8).request
                     for p in _prompts()[1::3])
    cb = r.batchers[req_pool(r, first)]
    assert second in cb.queue
    rec, _ = _tick(cb)
    assert rec.admitted == 1 and rec.blocked and rec.queued == 1
    assert second.times.blocked == 1 and second.times.admitted is None
    while second.times.admitted is None:
        rec, _ = _tick(cb)
    assert rec.admitted == 1 and not rec.blocked
    assert second.times.blocked >= 2
    assert first.times.done <= second.times.admitted
    assert first.times.blocked == 0


def _serve(paged, policy):
    r = _router(paged, policy)
    routed = [r.submit(p, 6) for p in _prompts()]
    r.drain()
    stats = {n: cb.stats() for n, cb in r.batchers.items()
             if hasattr(cb, "stats")}
    return ([rr.request.out_tokens for rr in routed], stats,
            r.fleet_report())


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(self, *a, **k):
        raise AssertionError("record_function entered with no profiler")
    rf = torch.autograd.profiler.record_function
    monkeypatch.setattr(rf, "__init__", refuse)
    monkeypatch.setattr(rf, "__enter__", refuse)
    for paged in (True, False):
        _serve(paged, "capacity_aware")


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


PARENTS = {"lane.cache": ("tick.fill",), "lane.prefill": ("tick.fill",),
           "lane.splice": ("tick.fill",),
           "tick.sync": ("tick.fill", "tick.prefill", None),
           "tick.book": ("tick.fill", "tick.prefill", None),
           "graph.stage": ("tick.decode", "tick.prefill"),
           "graph.replay": ("tick.decode", "tick.prefill"),
           "graph.capture": ("tick.decode", "tick.prefill"),
           "tick.admit": (None,), "tick.fill": (None,),
           "tick.prefill": (None,), "tick.decode": (None,),
           "router.snapshot": (None,), "router.dispatch": (None,),
           "router.book": (None,), "router.enqueue": (None,)}


def _parent(spans, i):
    """The innermost span holding span ``i`` (None: none)."""
    name, a, b = spans[i]
    holders = [s for j, s in enumerate(spans)
               if j != i and s[1] <= a and b <= s[2] and (s[2] - s[1]) > (b - a)]
    return max(holders, key=lambda s: s[1])[0] if holders else None


def test_spans_under_the_profiler_nest_and_change_nothing(tmp_path):
    plain = [_serve(paged, "capacity_aware") for paged in (True, False)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = [_serve(paged, "capacity_aware") for paged in (True, False)]
    assert traced == plain
    spans = [s for s in _annotations(prof, tmp_path)
             if s[0] in trace.SPANS]
    assert {s[0] for s in spans} == set(trace.SPANS)
    assert set(PARENTS) == set(trace.SPANS)
    for i, (name, _, _) in enumerate(spans):
        assert _parent(spans, i) in PARENTS[name], name


def test_the_tick_log_is_bounded_and_a_span_off_is_shared():
    assert trace.TICKS.maxlen == 65_536
    assert trace.span("tick.admit") is trace.span("graph.replay")

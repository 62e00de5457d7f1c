"""The readers of what the program records itself (``_program.py``, the
request stamps and the tick log of ``repro_torch.serving.trace``) and of
its profiler spans: each on made-up records, counting only what lies in
the window and clear of the profiled slice, idle time placed by launch
with the device clock 5000 us ahead (no reading may notice), None where
the program keeps no such records, the program's span names apart from
the harness's, and a traced tiny run of each cell layout reporting every
new metric."""
import importlib.util
import re
import sys
from collections import deque
from types import SimpleNamespace

import pytest

import _tiny
from serve_bench import harness as H
from serve_bench.bench import reader_path
from repro_torch import serving
from repro_torch.serving import trace
from repro_torch.serving.trace import RequestTimes, Tick

NEW = ("dispatch_ms", "admit_wait_ms", "tick_host_ms", "decode_lanes",
       "idle_in_admit_share")
T0 = 1000.0                      # served.t0 on the program's clock


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), reader_path(_tiny.HERE, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(times=(), prof=None, slice_s=(18.0, 20.0)):
    """A window of 10..20 s after ``T0``, profiled over ``slice_s``;
    ``times`` the requests'."""
    reqs = [SimpleNamespace(req=SimpleNamespace(times=tm)) for tm in times]
    sv = H.Served(reqs, T0, 10.0, 20.0, slice_t0=slice_s and slice_s[0],
                  slice_t1=slice_s and slice_s[1])
    return H.Trace({"model": {}, "serving": {}}, sv, [], [],
                   prof or H.Profile([], [], []), {}, 700.0)


def _times(arrived, routed=None, queued=None, admitted=None, emitted=(),
           booked=None, done=None, blocked=0):
    w = lambda v: None if v is None else T0 + v   # noqa: E731
    return RequestTimes(arrived=w(arrived), routed=w(routed),
                        booked=w(routed if booked is None else booked),
                        queued=w(queued), admitted=w(admitted),
                        emitted=[T0 + e for e in emitted], done=w(done),
                        blocked=blocked)


@pytest.fixture
def ticks(monkeypatch):
    log = deque(maxlen=trace.TICKS.maxlen)
    monkeypatch.setattr(trace, "TICKS", log)
    return log


def _tick(start, dur, sync, *, admitted=0, blocked=False, lanes=0,
          queued=0, pool="eff"):
    return Tick(pool, T0 + start, T0 + start + dur, sync, admitted, blocked,
                lanes, queued)


def test_dispatch_and_admit_wait_read_the_stamps_clear_of_the_slice(
        ticks, capsys):
    tms = [_times(11.0, 11.0001, 11.0002, 11.004, booked=11.00015,
                  emitted=(11.01, 11.02), done=11.5, blocked=2),
           _times(12.0, 12.0003, 12.0004, 12.0104, blocked=3,
                  emitted=(12.02,), done=19.0),   # done in the slice
           _times(13.0, 13.0002, 13.0003, 13.0023, emitted=(13.003,),
                  done=13.5),
           _times(5.0, 5.9, 5.95, 11.0),          # queued in the ramp
           _times(17.999, 17.9995, 17.9996, 18.5),  # admitted in the slice
           _times(18.5, 18.6, 18.61, 18.7)]       # all in the slice
    tr = _trace(tms)
    # routed - arrived of every submit queued in the window, clear of the
    # slice: 0.1, 0.3, 0.2 and 0.5 ms
    assert _reader("dispatch_ms").read(tr) == pytest.approx(
        (0.1 + 0.3 + 0.2 + 0.5) / 4)
    assert ("4 submits; booking 0.0125 ms, enqueue 0.0875 ms"
            in capsys.readouterr().err)
    # admitted - queued where both lie there: 3.8, 10.0, 2.0 ms
    assert _reader("admit_wait_ms.burst").read(tr) == pytest.approx(3.8)
    # first tokens 6.0 and 0.7 ms after admission; lives 500 ms
    assert ("3 admitted, 2 waited on memory (5 ticks, at most 3); 2 done: "
            "first token after admission p50 3.350 ms, life p50 500.000 ms"
            in capsys.readouterr().err)


def test_tick_host_and_decode_lanes_read_the_tick_log(ticks, capsys):
    ticks.extend([_tick(5.0, 0.05, 0.01, lanes=9),         # in the ramp
                  _tick(11.0, 0.040, 0.030, lanes=4),
                  _tick(11.1, 0.050, 0.020, admitted=2, lanes=6,
                        blocked=True, queued=3),
                  _tick(11.2, 0.010, 0.0, admitted=1, queued=1),
                  _tick(17.99, 0.05, 0.0, lanes=50),       # into the slice
                  _tick(18.5, 0.09, 0.0, lanes=30),        # in the slice
                  _tick(19.99, 0.05, 0.0, lanes=100)])     # ends after
    tr = _trace()
    assert _reader("tick_host_ms").read(tr) == pytest.approx(
        (10 + 30 + 10) / 3)
    err = capsys.readouterr().err
    assert "0: (1, 10.000)" in err and "2: (1, 30.000)" in err
    assert _reader("decode_lanes.burst").read(tr) == pytest.approx(5.0)
    _reader("admit_wait_ms").read(tr)
    assert "3 ticks, 1 stopped on memory" in capsys.readouterr().err
    # an untraced run has no slice: every tick in the window counts
    untraced = _trace(slice_s=None)
    assert _reader("decode_lanes").read(untraced) == pytest.approx(
        (4 + 6 + 50 + 30) / 4)


def _idle_profile(offset):
    """Two ticks on the host: 0..1000 us and 2000..2600 us. Tick 1 admits
    in 0..500 (a lane's prefill 50..450), then decodes: a graph launched in
    690..745 whose kernels start only after the launch call. Its ops, as
    (host start, end, launch): A (110, 210, 100), B (460, 560, 450), the
    graph's G (750, 900, 690) and D (900, 950, 690). Tick 2 admits
    nothing: one op (2110, 2310, 2100). The device clock runs ``offset``
    ahead of the host's, and 300 us further in tick 2 (drift)."""
    ann = [("batcher.step", 0.0, 1000.0), ("tick.admit", 0.0, 500.0),
           ("lane.prefill", 50.0, 400.0), ("tick.decode", 600.0, 150.0),
           ("graph.replay", 690.0, 55.0), ("tick.sync", 760.0, 200.0),
           ("batcher.step", 2000.0, 600.0), ("tick.decode", 2050.0, 100.0)]
    ops = [(110.0, 210.0, 100.0), (460.0, 560.0, 450.0),
           (750.0, 900.0, 690.0), (900.0, 950.0, 690.0),
           (2410.0, 2610.0, 2100.0)]
    dev = [(a + offset, b + offset, at) for a, b, at in ops]
    return H.Profile([], sorted(dev), ann)


def test_idle_in_admission_places_idle_by_each_ticks_clock(capsys):
    got = {}
    for offset in (0.0, 5000.0):
        got[offset] = _reader("idle_in_admit_share").read(
            _trace(prof=_idle_profile(offset)))
    # each tick's ops moved to the host by its smallest start - launch (10
    # us, then 310): tick 1 busy 100..200, 450..550, 740..940, idle 600 us:
    # 0..100, 200..450, 550..740, 940..1000; tick 2 busy 2100..2300, idle
    # 400 us. Inside graph.replay (690..740, the profiler's wait) 50 us are
    # left out; in admission (0..500): 100 + 250.
    assert got[0.0] == pytest.approx(350 / 950 * 100)
    assert got[5000.0] == got[0.0]
    # by innermost span, per tick: lane.prefill 50 + 250 us, batcher.step
    # 50 + 40 + 50 + 300, tick.decode 90 + 50, graph.replay 690..740
    err = capsys.readouterr().err
    assert ("(0.500 in all, 0.475 outside graph.replay, 0.175 in "
            "admission)") in err
    assert "lane.prefill 0.150" in err and "batcher.step 0.220" in err
    assert "tick.decode 0.070" in err and "graph.replay 0.025" in err
    assert "tick.admit 0.025" in err and "tick.sync 0.010" in err


def test_minus_leaves_out_the_cut_parts():
    m = _reader("idle_in_admit_share").minus
    ivs = [(0.0, 10.0), (20.0, 30.0), (40.0, 50.0)]
    cuts = [(-5.0, 2.0), (4.0, 6.0), (9.0, 25.0), (50.0, 60.0)]
    assert m(ivs, cuts) == [(2.0, 4.0), (6.0, 9.0), (25.0, 30.0),
                            (40.0, 50.0)]
    assert m(ivs, []) == ivs
    assert m(ivs, [(-1.0, 100.0)]) == []


def test_readers_give_none_without_the_programs_records(ticks, monkeypatch):
    tms = [SimpleNamespace(), SimpleNamespace()]    # no times: an older one
    sv = H.Served([SimpleNamespace(req=r) for r in tms] +
                  [SimpleNamespace(req=None)], T0, 10.0, 20.0,
                  slice_t0=0.0, slice_t1=30.0)
    tr = H.Trace({"model": {}, "serving": {}}, sv, [], [],
                 H.Profile([], [], [("batcher.step", 0.0, 10.0)]), {}, 700.0)
    for name in NEW:
        assert _reader(name).read(tr) is None, name
    # no trace module at all (the program before it kept one)
    ticks.append(_tick(11.0, 0.04, 0.01, lanes=3))
    tr_prof = _trace(prof=_idle_profile(0.0))
    assert _reader("decode_lanes").read(tr_prof) == 3
    monkeypatch.delattr(serving, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.serving.trace", None)
    for name in NEW:
        assert _reader(name).read(tr_prof) is None, name


def test_program_span_names_are_not_the_harness_s():
    src = (_tiny.HERE / "harness.py").read_text()
    harness = set(re.findall(r'rf\("([\w.]+)"\)', src))
    kinds = re.search(r'for kind in \(([^)]*)\)', src).group(1)
    harness |= {"engine." + k for k in re.findall(r'"(\w+)"', kinds)}
    assert {"router.submit", "batcher.step", "serve.idle",
            "engine.prefill_chunk", "engine.decode"} <= harness
    assert not harness & set(trace.SPANS)
    assert len(set(trace.SPANS)) == len(trace.SPANS)


@pytest.mark.parametrize("cell", ["tiny.dense", "tiny.hybrid"])
def test_a_traced_tiny_run_reports_every_new_metric(tmp_path, cell):
    root = _tiny.make_root(tmp_path)
    res = _tiny.run(root, cell, seconds=3.0, trace=True)
    want = {n if cell == "tiny.dense" else n + ".burst" for n in NEW}
    if cell == "tiny.hybrid":
        want.discard("dispatch_ms.burst")
    assert want <= set(res["metrics"]), sorted(want - set(res["metrics"]))
    got = {k: res["metrics"][k]["value"] for k in want}
    assert all(v is not None for v in got.values())
    share = got["idle_in_admit_share" + ("" if cell == "tiny.dense"
                                         else ".burst")]
    assert 0.0 < share <= 100.0

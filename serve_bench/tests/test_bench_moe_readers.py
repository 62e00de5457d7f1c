"""The readers of the grouped expert kernel (K7) and of the experts a MoE
layer touches, on a made-up trace and tick log: decode-only ticks, a tick
that also prefilled or lost a kernel left out, each tick matched to the
program's own record, and a program that keeps no such counts read as
nothing."""
import importlib.util

import pytest

import _tiny
from repro_torch.serving import trace
from serve_bench import harness as H
from serve_bench import moe_count as MC
from serve_bench.bench import reader_path

UP = "void repro_torch::moe::moe_gemm<true>(a, b)"
DOWN = "void repro_torch::moe::moe_gemm<false>(a, b)"
MODEL = {"d_model": 64, "d_ff": 128, "block_pattern": "ME*E",
         "moe": {"num_experts": 8, "num_experts_per_tok": 2}}


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), reader_path(_tiny.HERE, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tick(start, end, lanes, touched):
    return trace.Tick("p", start, end, 0.0, 0, False, lanes, 0,
                      2 * 2 * lanes, touched)


def _setup(lose_kernel=False, prefill_in_tick=None):
    """Three ticks in the slice (1 s apart on the harness clock, 1000 us on
    the profiler's): 3, 5 and 4 live lanes, 6, 8 and 7 experts touched."""
    sv = H.Served([], 0.0, 0.0, 100.0, slice_t0=10.0, slice_t1=20.0)
    spans, ann, kernels = [], [], []
    lanes, touched = [3, 5, 4], [6, 8, 7]
    trace.TICKS.clear()
    for i in range(3):
        a = 11.0 + i
        spans.append(("batcher.step", a, a + 0.5, "p"))
        trace.TICKS.append(_tick(a + 0.01, a + 0.4, lanes[i], touched[i]))
        t0 = 1000.0 * i
        ann += [("batcher.step", t0, 900.0), ("engine.decode", t0 + 10, 50)]
        if prefill_in_tick == i:
            ann.append(("engine.prefill", t0 + 70, 50))
        for layer in range(2):
            kernels.append((UP, t0 + 100 + 100 * layer, 30.0, t0 + 20))
            kernels.append((DOWN, t0 + 140 + 100 * layer, 20.0, t0 + 20))
    if lose_kernel:
        del kernels[-1]
    kernels = sorted((n, ts + 5000.0, d, at) for n, ts, d, at in kernels)
    prof = H.Profile(kernels, [(ts, ts + d, at) for _, ts, d, at in kernels],
                     ann)
    return H.Trace({"model": MODEL, "serving": {}}, sv, spans, [], prof, {},
                   700.0)


def _bound(lanes, touched):
    return 2 * MC.bound_s(touched / 2, 2 * lanes, 64, 128)


@pytest.mark.parametrize("case", ["all", "lost", "prefill"])
def test_k7_readers(case):
    tr = _setup(lose_kernel=case == "lost",
                prefill_in_tick=1 if case == "prefill" else None)
    keep = [0, 1, 2] if case == "all" else [0, 2] if case == "prefill" \
        else [0, 1]
    lanes, touched = [3, 5, 4], [6, 8, 7]
    dev = 100e-6 * len(keep)                   # 2 layers x (30 + 20) us
    want = sum(_bound(lanes[i], touched[i]) for i in keep)
    assert _reader("k7_roofline").read(tr) == pytest.approx(
        want / dev * 100)
    assert _reader("k7_ms").read(tr) == pytest.approx(0.1)


def test_k7_readers_read_nothing_without_counts():
    tr = _setup()
    trace.TICKS.clear()
    assert _reader("k7_roofline").read(tr) is None
    tr.config["model"] = dict(MODEL, block_pattern="M*")
    assert _reader("k7_ms").read(tr) is None


def test_experts_touched_and_its_expectation():
    sv = H.Served([], 0.0, 0.0, 100.0, slice_t0=90.0, slice_t1=95.0)
    tr = H.Trace({"model": MODEL, "serving": {}}, sv, [], [],
                 H.Profile([], [], []), {}, 700.0)
    trace.TICKS.clear()
    trace.TICKS.extend([_tick(1.0, 1.1, 3, 6), _tick(2.0, 2.1, 5, 10),
                        _tick(91.0, 91.1, 9, 15),     # in the slice
                        trace.Tick("p", 3.0, 3.1, 0.0, 1, False, 0, 0)])
    reader = _reader("experts_touched")
    assert reader.read(tr) == pytest.approx((6 + 10) / 2 / 2)
    trace.TICKS.clear()
    trace.TICKS.append(trace.Tick("p", 3.0, 3.1, 0.0, 1, False, 4, 0))
    assert reader.read(tr) is None
    assert MC.expected_touched(128, 6, 1) == pytest.approx(6.0)
    assert MC.expected_touched(128, 6, 64) == pytest.approx(
        128 * (1 - (122 / 128) ** 64))

"""The per-layer readers on a made-up trace: K3's and K5's ticks, calls
and device time as the profile would hold them, a tick with a record
missing left out, the idle share inside ticks, and the breakdown."""
import importlib.util

import pytest

import _tiny
from serve_bench import harness as H
from serve_bench.bench import reader_path

SPLIT = "void repro_torch::decode_split_kernel<__nv_bfloat16, " \
    "__nv_bfloat16, 128, 4, true>(a, b)"
COMB = "void repro_torch::decode_combine_kernel<__nv_bfloat16, 128>(a)"
GEMM = "nvjet_tst_128x32_64x10_4x1_v_bz_NNT"


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), reader_path(_tiny.HERE, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(model, serving, calls, kernels, ann, launches):
    """``kernels`` (name, device ts, dur, host launch ts); the device clock
    runs 5000 us ahead of the host's, which no reading may notice."""
    sv = H.Served([], 0.0, 0.0, 100.0, slice_t0=0.0, slice_t1=10.0)
    kernels = sorted((n, ts + 5000.0, d, at) for n, ts, d, at in kernels)
    prof = H.Profile(kernels, [(ts, ts + d, at) for _, ts, d, at in kernels],
                     ann)
    cfg = {"model": model, "serving": serving}
    return H.Trace(cfg, sv, [], calls, prof, launches, 700.0)


def _mistral_like(layers=2):
    return dict(_tiny.DENSE, num_layers=layers, num_heads=32,
                num_kv_heads=8, d_model=4096, sliding_window=4096)


def test_k3_ticks_and_a_lost_record():
    m = _mistral_like()
    k3 = _reader("k3_roofline")
    calls, kernels, ann = [], [], []
    for i in range(3):                        # three ticks, 1000 us apart
        t0 = 1000.0 * i
        ann += [("batcher.step", t0, 900.0),
                ("engine.decode_paged", t0 + 10, 50.0)]
        calls.append(("decode_paged", "p", 1.0 + i, 1.5 + i, [100, 200]))
        for layer in range(2):                # one graph: launched at +20
            kernels.append((SPLIT, t0 + 100 + 100 * layer, 30.0, t0 + 20))
            kernels.append((COMB, t0 + 140 + 100 * layer, 5.0, t0 + 20))
            kernels.append((GEMM, t0 + 150 + 100 * layer, 20.0, t0 + 20))
    del kernels[-3]                           # the last tick loses a split
    tr = _trace(m, {"block_size": 16}, calls, kernels, ann,
                {"paged_decode_attention": 6, "decode_attention": 0})
    want = 2 * 2 * k3.bound_s(m, 16, [100, 200])   # two whole ticks
    assert k3.read(tr) == pytest.approx(want / (2 * 70e-6) * 100)
    tr.launches["paged_decode_attention"] = 5
    assert k3.read(tr) is None


def test_k5_ticks():
    m = dict(_tiny.HYBRID, num_layers=1,
             ssm=dict(_tiny.HYBRID["ssm"], chunk_size=32))
    k5 = _reader("k5_roofline")
    names = ["void repro_torch::ssd_chunk_state_kernel<bf16, 16, 16>(x)",
             "repro_torch::ssd_state_scan_kernel(y)",
             "void repro_torch::ssd_output_kernel<bf16, 16, 16, 32>(z)"]
    ann = [("batcher.step", 0.0, 900.0), ("engine.prefill", 10.0, 100.0),
           ("engine.prefill", 200.0, 100.0)]
    kernels = [(n, 300.0 + 10 * i, 4.0, 20.0 + 200 * (i // 3))
               for i, n in enumerate(names * 2)]
    calls = [("prefill", "p", 1.0, 1.1, (0, 40, True)),
             ("prefill", "p", 1.2, 1.3, (0, 7, True))]
    tr = _trace(m, {}, calls, kernels, ann, {"ssd_scan": 2})
    H_, P, N = 8, 16, 16
    want = k5.bound_s(40, H_, P, N, 32) + k5.bound_s(7, H_, P, N, 32)
    assert k5.read(tr) == pytest.approx(want / 24e-6 * 100)


def test_idle_share_and_breakdown():
    idle = _reader("idle_share.itl")
    ann = [("batcher.step", 0.0, 100.0), ("engine.decode", 0.0, 20.0),
           ("batcher.step", 200.0, 100.0)]
    kernels = [(GEMM, 10.0, 40.0, 5.0), (GEMM, 220.0, 30.0, 150.0),
               (GEMM, 240.0, 40.0, 210.0)]
    tr = _trace(_tiny.DENSE, {}, [], kernels, ann, {})
    # busy inside the ticks: 40 of 100, then 60 of 100 (two overlap); the
    # second op was launched between ticks: it counts for none
    assert idle.read(tr) == pytest.approx(100 * (1 - 80 / 200))
    b = H.breakdown(tr.profile)
    assert b["device_ops"] == [[GEMM, pytest.approx(110e-6)]]
    # one gap, 50..220 (170 us), before an op launched at 150: the loop
    assert b["idle_gaps"] == [["serve.loop", pytest.approx(170e-6)]]


def test_ttft_mean_counts_every_request_due_in_the_window():
    """Served, unserved by the window's end, refused; the ramp's and the
    horizon's requests left out."""
    import numpy as np
    from serve_bench.traffic import Req
    reqs = [Req(i, due, 4, 4, np.zeros(4, np.int32))
            for i, due in enumerate((1.0, 6.0, 7.0, 8.0, 9.0, 12.0))]
    reqs[0].first_t = 1.5          # due in the ramp: not counted
    reqs[1].first_t = 6.25
    reqs[2].first_t = 7.75
    reqs[3].first_t = 10.5         # after the window's end: its age then
    reqs[4].failed = "refused"     # refused: its age then
    reqs[5].first_t = 12.1         # due after the window: not counted
    sv = H.Served(reqs, 0.0, 6.0, 10.0, slice_t0=0.0, slice_t1=10.0)
    tr = H.Trace({"model": {}, "serving": {}}, sv, [], [],
                 H.Profile([], [], []), {}, 700.0)
    got = _reader("ttft_mean_ms.traced").read(tr)
    assert got == pytest.approx((0.25 + 0.75 + 2.0 + 1.0) / 4 * 1e3)
    sv.reqs = reqs[:1]
    assert _reader("ttft_mean_ms.traced").read(tr) is None

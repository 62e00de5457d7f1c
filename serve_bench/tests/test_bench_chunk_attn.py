"""chunk_attn_ms on a made-up trace: K6's device time per chunk over the
ticks that hold all of their chunks' K6 kernels, and None for a program
whose chunks launch no K6 kernel."""
import importlib.util

import pytest

import _tiny
from serve_bench import harness as H
from serve_bench.bench import reader_path

K6 = "void repro_torch::chunk::paged_chunk_wgmma<128>(a, b)"
GEMM = "nvjet_tst_128x32_64x10_4x1_v_bz_NNT"
SOFTMAX = "void at::native::cunn_SoftMaxForward<4, float>(a)"


def _reader():
    spec = importlib.util.spec_from_file_location(
        "chunk_attn_ms", reader_path(_tiny.HERE, "chunk_attn_ms"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(attention, chunks=(1, 2, 1), layers=2, lose=False):
    """Ticks 1000 us apart, tick i holding chunks[i] prefill_chunk calls,
    each a graph launching ``attention`` and a GEMM a layer."""
    calls, kernels, ann = [], [], []
    for i, n in enumerate(chunks):
        t0 = 1000.0 * i
        ann.append(("batcher.step", t0, 900.0))
        for c in range(n):
            at = t0 + 10 + 100 * c
            ann.append(("engine.prefill_chunk", at, 50.0))
            calls.append(("prefill_chunk", "p", (at + 1) * 1e-6,
                          (at + 40) * 1e-6, (0, 38, True)))
            for layer in range(layers):
                ts = at + 20 + 10 * layer
                kernels.append((attention, ts, 4.0 + c, at + 5))
                kernels.append((GEMM, ts + 5, 3.0, at + 5))
    if lose:
        del kernels[-2]                  # the last tick loses a K6 kernel
    sv = H.Served([], 0.0, 0.0, 100.0, slice_t0=0.0, slice_t1=10.0)
    prof = H.Profile(sorted(kernels),
                     [(ts, ts + d, at) for _, ts, d, at in kernels], ann)
    cfg = {"model": dict(_tiny.DENSE, num_layers=layers),
           "serving": {"block_size": 16}}
    return H.Trace(cfg, sv, [], calls, prof, {}, 700.0)


def test_chunk_attention_ms_per_chunk_over_whole_ticks():
    read = _reader().read
    # chunk c of a tick runs 4 + c us a layer: (8) + (8 + 10) + (8) us
    assert read(_trace(K6)) == pytest.approx(34.0 / 4 * 1e-3)
    assert read(_trace(K6, lose=True)) == pytest.approx(26.0 / 3 * 1e-3)


def test_no_chunk_kernel_reads_none():
    assert _reader().read(_trace(SOFTMAX)) is None
    assert _reader().read(_trace(K6, chunks=())) is None

"""The port's Hopper kernels on the card (marker ``gpu``).

Each test decides inside itself whether a CUDA device is present and skips
without one: the kernels are CUDA C++ and have no CPU mode. This file
imports no JAX, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q
"""
import sys

import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as SS

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(dtype):
    """K1, K2, K3 against their plain versions on CUDA tensors (builds the
    kernels with nvcc on first use). Every row here has a valid key."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = TOL[dtype]
    q = _randn(gen, (2, 8, 100, 128), dtype)
    k = _randn(gen, (2, 2, 100, 128), dtype)
    v = _randn(gen, (2, 2, 100, 128), dtype)
    for kw in ({}, {"window": 17}, {"softcap": 30.0}, {"causal": False}):
        torch.testing.assert_close(FA.flash_attention(q, k, v, **kw),
                                   FA.flash_attention_ref(q, k, v, **kw),
                                   atol=tol, rtol=tol)
    kv = torch.tensor([1, 77], dtype=torch.int32, device="cuda")
    q1 = q[:, :, :1].contiguous()
    torch.testing.assert_close(
        DA.decode_attention(q1, k, v, kv, window=50),
        DA.decode_attention_ref(q1, k, v, kv, window=50), atol=tol, rtol=tol)
    # the same cache as a pool of 20 blocks of 10 rows, lane b owning 10b..
    pool_k = k.reshape(2, 2, 10, 10, 128).permute(0, 2, 1, 3, 4) \
        .reshape(20, 2, 10, 128).contiguous()
    pool_v = v.reshape(2, 2, 10, 10, 128).permute(0, 2, 1, 3, 4) \
        .reshape(20, 2, 10, 128).contiguous()
    tables = torch.arange(20, dtype=torch.int32, device="cuda").reshape(2, 10)
    got = DA.paged_decode_attention(q1, pool_k, pool_v, tables, kv)
    torch.testing.assert_close(
        got, DA.paged_decode_attention_ref(q1, pool_k, pool_v, tables, kv),
        atol=tol, rtol=tol)
    torch.testing.assert_close(got, DA.decode_attention(q1, k, v, kv),
                               atol=tol, rtol=tol)


@pytest.mark.gpu
def test_kernels_write_zero_for_rows_without_a_valid_key():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q = _randn(gen, (1, 2, 8, 64), torch.float32)
    k = _randn(gen, (1, 1, 8, 64), torch.float32)
    out = FA.flash_attention(q, k, k, causal=True, q_offset=-4)
    assert torch.count_nonzero(out[:, :, :4]) == 0
    kv = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = DA.decode_attention(q[:, :, :1].contiguous(), k, k, kv)
    assert torch.count_nonzero(out) == 0


@pytest.mark.gpu
def test_wrappers_raise_on_inputs_the_kernels_do_not_take():
    _need_card()
    q = torch.zeros((1, 2, 8, 128), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q[..., :96].contiguous(), q[..., :96].contiguous(),
                           q[..., :96].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        FA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="kv_len"):
        DA.decode_attention(q[:, :, :1].contiguous(), q, q,
                            torch.ones(1, dtype=torch.int64, device="cuda"))


@pytest.mark.gpu
def test_launch_counters_count_kernel_launches():
    _need_card()
    q = torch.zeros((1, 2, 8, 64), device="cuda")
    before = FA.flash_attention.launches
    FA.flash_attention(q, q, q)
    FA.flash_attention_ref(q, q, q)
    assert FA.flash_attention.launches == before + 1


# ------------------------------------------------------------------ K5
SSD_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


def _ssd_inputs(gen, B, H, S, N, dtype, P=64):
    x = _randn(gen, (B, H, S, P), dtype)
    dt = torch.rand((B, H, S), generator=gen, device="cuda") * 0.2 + 0.001
    A = -(torch.rand((H,), generator=gen, device="cuda") * 3.5 + 0.5)
    Bm = _randn(gen, (B, S, N), dtype)
    Cm = _randn(gen, (B, S, N), dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,P,N,S,chunk", [(24, 64, 128, 256, 128),
                                           (64, 64, 64, 200, 128),
                                           (3, 64, 128, 70, 32),
                                           (16, 32, 32, 64, 32),
                                           (16, 32, 32, 45, 32)])
def test_ssd_scan_kernel_matches_plain_on_card(dtype, H, P, N, S, chunk):
    """K5 against the chunked plain version and the sequential oracle, y and
    the final state; S = 200, 70 and 45 are ragged. P = N = 32 at chunk 32
    is the reduced mamba2-130m's and zamba2-1.2b's shape."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    inp = _ssd_inputs(gen, 2, H, S, N, dtype, P)
    tol = SSD_TOL[dtype]
    y, fs = SS.ssd_scan(*inp, chunk=chunk)
    torch.cuda.synchronize()
    assert y.dtype == dtype and fs.dtype == torch.float32
    for want_y, want_fs in (SS.ssd_scan_ref(*inp, chunk=chunk),
                            ref.ssd_scan(*inp)):
        torch.testing.assert_close(y.float(), want_y.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(fs, want_fs, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_ssd_scan_wrapper_refuses_and_counts():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, dt, A, Bm, Cm = _ssd_inputs(gen, 1, 4, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        SS.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                    Bm, Cm)
    with pytest.raises(ValueError, match="float32"):
        SS.ssd_scan(x, dt.bfloat16(), A, Bm, Cm)
    with pytest.raises(ValueError, match="state dim"):
        SS.ssd_scan(x, dt, A, Bm[..., :16].contiguous(),
                    Cm[..., :16].contiguous())
    with pytest.raises(ValueError, match="head dim"):
        SS.ssd_scan(x[..., :16].contiguous(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="chunk"):
        SS.ssd_scan(x, dt, A, Bm, Cm, chunk=100)
    before = SS.ssd_scan.launches
    SS.ssd_scan(x, dt, A, Bm, Cm)
    SS.ssd_scan_ref(x, dt, A, Bm, Cm)
    assert SS.ssd_scan.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kernels", [
    ("mamba2-130m", (SS.ssd_scan,)),
    ("zamba2-1.2b", (SS.ssd_scan, FA.flash_attention, DA.decode_attention))])
def test_serve_entry_point_runs_on_card(arch, kernels, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch>`` with no
    ``--device``: the reduced model on the card, through its kernels."""
    _need_card()
    from repro_torch.launch import serve
    before = [fn.launches for fn in kernels]
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch,
                                      "--requests", "4"])
    serve.main()
    out = capsys.readouterr().out
    assert out.count("tokens=[") == 4 and "fleet report" in out
    assert all(fn.launches > b for fn, b in zip(kernels, before))

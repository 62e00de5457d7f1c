"""The port's Hopper kernels on the card (marker ``gpu``).

Each test decides inside itself whether a CUDA device is present and skips
without one: the kernels are CUDA C++ and have no CPU mode. This file
imports no JAX, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA

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

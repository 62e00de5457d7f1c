"""The port's Hopper kernels on the card (marker ``gpu``).

Each test decides inside itself whether a CUDA device is present and skips
without one: the kernels are CUDA C++ and have no CPU mode. This file
imports no JAX, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q
"""
import pathlib
import re
import sys

import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as SS

from _torch_handoff import kv_pools, probe_pair

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
def test_flash_refuses_a_tile_over_shared_memory():
    """block_q 128 x block_k 128 fits at head dim 64, not at 128: the
    wrapper says so before the launch would be refused."""
    _need_card()
    q = torch.zeros((1, 2, 128, 128), device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        FA.flash_attention(q, q, q, block_q=128, block_k=128)
    h = q[..., :64].contiguous()
    torch.testing.assert_close(FA.flash_attention(h, h, h, block_q=128,
                                                  block_k=128),
                               FA.flash_attention_ref(h, h, h))


def _flash_rows(Sq, q_offset, window, sk_valid):
    """Causal query rows with at least one valid key."""
    qpos = torch.arange(Sq) + q_offset
    nearest = torch.clamp(qpos, max=sk_valid - 1)
    ok = nearest >= 0
    if window is not None:
        ok &= (qpos - nearest) < window
    return ok


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(Sq=37, Sk=37), dict(Sq=300, Sk=300), dict(Sq=512, Sk=512),
    dict(Sq=37, Sk=101, q_offset=64), dict(Sq=40, Sk=40, q_offset=-4),
    dict(Sq=64, Sk=64, softcap=30.0), dict(Sq=200, Sk=200, D=64, window=17),
    dict(Sq=100, Sk=100, sk_valid=77), dict(Sq=128, Sk=128, Hkv=32),
    dict(Sq=300, Sk=300, D=64, Hkv=32, window=8192)])
def test_flash_bf16_v3_matches_plain_on_card(case):
    """K1 v3 (bf16, wgmma): ragged Sq, q offsets either side of 0, softcap,
    window, sk_valid < Sk, D 64 and 128, Hkv 8 and 32. Rows with no valid
    key are 0."""
    _need_card()
    c = dict(case)
    Sq, Sk, D, Hkv = c.pop("Sq"), c.pop("Sk"), c.pop("D", 128), \
        c.pop("Hkv", 8)
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = _randn(gen, (1, 32, Sq, D), torch.bfloat16)
    k = _randn(gen, (1, Hkv, Sk, D), torch.bfloat16)
    v = _randn(gen, (1, Hkv, Sk, D), torch.bfloat16)
    got = FA.flash_attention(q, k, v, **c)
    want = FA.flash_attention_ref(q, k, v, **c)
    rows = _flash_rows(Sq, c.get("q_offset", 0), c.get("window"),
                       c.get("sk_valid", Sk)).cuda()
    torch.testing.assert_close(got[:, :, rows].float(),
                               want[:, :, rows].float(), atol=2e-2, rtol=2e-2)
    assert torch.count_nonzero(got[:, :, ~rows]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_flash_bf16_v3_every_tile_on_card(D):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = _randn(gen, (2, 8, 300, D), torch.bfloat16)
    k = _randn(gen, (2, 2, 300, D), torch.bfloat16)
    v = _randn(gen, (2, 2, 300, D), torch.bfloat16)
    want = FA.flash_attention_ref(q, k, v, window=100)
    tiles_q, tiles_k = FA.TILES[torch.bfloat16]
    for bq in tiles_q:
        for bk in tiles_k:
            torch.testing.assert_close(
                FA.flash_attention(q, k, v, window=100, block_q=bq,
                                   block_k=bk).float(), want.float(),
                atol=2e-2, rtol=2e-2, msg=f"tile {bq} x {bk}")


# the edges of both K1 kernels: ragged Sq, q offsets either side of 0,
# softcap, windows starting inside a tile, sk_valid < Sk, D 64 and 128,
# Hkv 8 and 32, Sq != Sk
FLASH_EDGES = [
    dict(Sq=37, Sk=37), dict(Sq=300, Sk=300), dict(Sq=512, Sk=512),
    dict(Sq=37, Sk=101, q_offset=64), dict(Sq=40, Sk=40, q_offset=-4),
    dict(Sq=300, Sk=300, D=64, q_offset=-70, window=33),
    dict(Sq=64, Sk=64, softcap=30.0), dict(Sq=200, Sk=200, D=64, window=17),
    dict(Sq=100, Sk=100, sk_valid=77), dict(Sq=128, Sk=128, Hkv=32),
    dict(Sq=300, Sk=300, D=64, Hkv=32, window=8192),
    dict(Sq=512, Sk=512, D=64, window=4096)]


def _flash_case(case, dtype, seed):
    c = dict(case)
    Sq, Sk, D, Hkv = c.pop("Sq"), c.pop("Sk"), c.pop("D", 128), \
        c.pop("Hkv", 8)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn(gen, (1, 32, Sq, D), dtype)
    k = _randn(gen, (1, Hkv, Sk, D), dtype)
    v = _randn(gen, (1, Hkv, Sk, D), dtype)
    rows = _flash_rows(Sq, c.get("q_offset", 0), c.get("window"),
                       c.get("sk_valid", Sk)).cuda()
    return q, k, v, c, rows


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_EDGES)
def test_flash_f32_v4_matches_plain_on_card(case):
    """K1 v4 (f32, FMA micro-tiles) at the edges, within 2e-5 of its plain
    version on rows with a valid key; the other rows are 0."""
    _need_card()
    q, k, v, c, rows = _flash_case(case, torch.float32, 9)
    got = FA.flash_attention(q, k, v, **c)
    want = FA.flash_attention_ref(q, k, v, **c)
    torch.testing.assert_close(got[:, :, rows], want[:, :, rows],
                               atol=2e-5, rtol=2e-5)
    assert torch.count_nonzero(got[:, :, ~rows]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_flash_f32_v4_every_tile_on_card(D):
    """Every tile v4 takes within shared memory; 128 x 128 fits at D 64
    only."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(10)
    q = _randn(gen, (2, 8, 300, D), torch.float32)
    k = _randn(gen, (2, 2, 300, D), torch.float32)
    v = _randn(gen, (2, 2, 300, D), torch.float32)
    want = FA.flash_attention_ref(q, k, v, window=100)
    tiles_q, tiles_k = FA.TILES[torch.float32]
    taken = [(bq, bk) for bq in tiles_q for bk in tiles_k
             if FA.smem_bytes(bq, bk, D) <= FA.SMEM_BYTES]
    assert len(taken) == (6 if D == 64 else 5)
    for bq, bk in taken:
        torch.testing.assert_close(
            FA.flash_attention(q, k, v, window=100, block_q=bq, block_k=bk),
            want, atol=2e-5, rtol=2e-5, msg=f"tile {bq} x {bk}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_EDGES)
def test_flash_lse_matches_plain_on_card(case, dtype):
    """The lse v3 (bf16) and v4 (f32) write for K1-bwd: within 2e-5 / 2e-2
    of flash_attention_lse_ref on rows with a valid key, +inf exactly on
    the others; asking for it leaves the output's bits as they are."""
    _need_card()
    q, k, v, c, rows = _flash_case(case, dtype, 11)
    before = FA.flash_attention.launches
    out, lse = FA._flash_attention_fwd(q, k, v, **c)
    assert FA.flash_attention.launches == before + 1
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    assert torch.equal(out, FA.flash_attention(q, k, v, **c))
    want = FA.flash_attention_lse_ref(q, k, v, **c)
    tol = TOL[dtype]
    torch.testing.assert_close(lse[:, :, rows], want[:, :, rows], atol=tol,
                               rtol=tol)
    assert torch.equal(lse == torch.inf, (~rows).expand_as(lse))


@pytest.mark.gpu
def test_flash_refuses_tiles_its_dtype_kernel_does_not_take():
    """v3 (bf16) and v4 (f32) take block_q 64/128 and block_k 32/64/128
    (v4 within shared memory); any other tile is refused for both, and a
    refusal launches nothing."""
    _need_card()
    q = torch.zeros((1, 2, 64, 64), device="cuda")
    before = FA.flash_attention.launches
    for t in (q, q.bfloat16()):
        for tiles in (dict(block_q=32), dict(block_q=16), dict(block_k=96)):
            with pytest.raises(ValueError, match="takes block_q"):
                FA.flash_attention(t, t, t, **tiles)
    assert FA.flash_attention.launches == before
    for tiles in (dict(block_q=128, block_k=32), dict(block_k=128)):
        torch.testing.assert_close(FA.flash_attention(q, q, q, **tiles),
                                   FA.flash_attention_ref(q, q, q))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("block_k", [32, 64, 128])
def test_decode_split_edges_on_card(dtype, D, block_k):
    """K2 v4 at kv_len on both sides of a split edge and at Smax, B = 5
    ragged, with a window of 64 and a softcap of 20, against its plain
    version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(9)
    Smax = 3 * block_k + 9
    kv = torch.tensor([1, block_k - 1, block_k, block_k + 1, Smax],
                      dtype=torch.int32, device="cuda")
    q = _randn(gen, (5, 8, 1, D), dtype)
    k = _randn(gen, (5, 2, Smax, D), dtype)
    v = _randn(gen, (5, 2, Smax, D), dtype)
    for kw in ({}, {"window": 64}, {"softcap": 20.0}):
        torch.testing.assert_close(
            DA.decode_attention(q, k, v, kv, block_k=block_k, **kw).float(),
            DA.decode_attention_ref(q, k, v, kv, **kw).float(),
            atol=TOL[dtype], rtol=TOL[dtype])


def _paged_inputs(gen, dtype, kv_len, G, Hkv, D, span, max_blocks):
    """Pools and tables whose live entries are distinct random blocks
    (never the null block 0) and whose dead entries are 0."""
    B = len(kv_len)
    num_blocks = 1 + sum(-(-n // span) for n in kv_len)
    q = _randn(gen, (B, G * Hkv, 1, D), dtype)
    kp = _randn(gen, (num_blocks, Hkv, span, D), dtype)
    vp = _randn(gen, (num_blocks, Hkv, span, D), dtype)
    perm = torch.randperm(num_blocks - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((B, max_blocks), dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(kv_len):
        nb = -(-n // span)
        tables[b, :nb] = perm[used:used + nb].to(torch.int32)
        used += nb
    kv = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, kv


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("span", [16, 32])
@pytest.mark.parametrize("block_k", [32, 64, 128])
@pytest.mark.parametrize("G,D", [(1, 128), (4, 64)])
def test_paged_decode_split_edges_on_card(dtype, span, block_k, G, D):
    """K3 v3 (split-KV through the block tables) at kv_len 0, on both sides
    of a split edge and at the whole table, with a window of 71 that cuts
    splits and a softcap of 20, against its plain version on rows with a
    valid key; the kv_len 0 lane is 0."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(12)
    max_blocks = -(-(2 * block_k + 9) // span)
    kv_len = [0, 1, block_k - 1, block_k, block_k + 1, span * max_blocks]
    q, kp, vp, tables, kv = _paged_inputs(gen, dtype, kv_len, G, 2, D, span,
                                          max_blocks)
    rows = kv > 0
    for kw in ({}, {"window": 71}, {"softcap": 20.0}):
        got = DA.paged_decode_attention(q, kp, vp, tables, kv,
                                        block_k=block_k, **kw)
        want = DA.paged_decode_attention_ref(q, kp, vp, tables, kv, **kw)
        torch.testing.assert_close(got[rows].float(), want[rows].float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        assert torch.count_nonzero(got[~rows]) == 0


@pytest.mark.gpu
def test_paged_decode_captures_into_a_cuda_graph():
    """A K3 call (split and combine, a workspace from torch.empty) needs no
    host sync: its splits come from the table's width, so it captures into
    a CUDA graph and a replay reads the new kv_len. One count per call."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, kp, vp, tables, kv = _paged_inputs(gen, torch.bfloat16,
                                          [40, 130, 300, 528], 4, 8, 128, 16,
                                          34)
    before = DA.paged_decode_attention.launches
    eager = DA.paged_decode_attention(q, kp, vp, tables, kv)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = DA.paged_decode_attention(q, kp, vp, tables, kv)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    kv -= 7
    g.replay()
    torch.testing.assert_close(
        out.float(),
        DA.paged_decode_attention_ref(q, kp, vp, tables, kv).float(),
        atol=2e-2, rtol=2e-2)
    assert DA.paged_decode_attention.launches == before + 2


@pytest.mark.gpu
def test_paged_decode_refuses_a_split_it_does_not_take():
    _need_card()
    q = torch.zeros((1, 2, 1, 64), device="cuda")
    pool = torch.zeros((4, 1, 16, 64), device="cuda")
    tables = torch.ones((1, 2), dtype=torch.int32, device="cuda")
    kv = torch.full((1,), 20, dtype=torch.int32, device="cuda")
    before = DA.paged_decode_attention.launches
    for bk in (16, 48, 96, 256):
        with pytest.raises(ValueError, match="block_k"):
            DA.paged_decode_attention(q, pool, pool, tables, kv, block_k=bk)
    assert DA.paged_decode_attention.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_many_query_heads_per_kv_head_on_card(dtype):
    """falcon-7b's grouping, 71 query heads on one KV head at D = 64: K2
    scores its rows four per pass (18 passes) and K1 maps every head to KV
    head 0."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    q = _randn(gen, (2, 71, 100, 64), dtype)
    k = _randn(gen, (2, 1, 100, 64), dtype)
    v = _randn(gen, (2, 1, 100, 64), dtype)
    torch.testing.assert_close(FA.flash_attention(q, k, v).float(),
                               FA.flash_attention_ref(q, k, v).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])
    kv = torch.tensor([37, 100], dtype=torch.int32, device="cuda")
    q1 = q[:, :, :1].contiguous()
    torch.testing.assert_close(
        DA.decode_attention(q1, k, v, kv, window=50).float(),
        DA.decode_attention_ref(q1, k, v, kv, window=50).float(),
        atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_many_query_heads_per_kv_head_on_card(dtype):
    """falcon-7b's grouping through the block tables: K3 with 71 query
    heads on one KV head at D = 64, against its plain version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(18)
    q, kp, vp, tables, kv = _paged_inputs(gen, dtype, [37, 100], 71, 1, 64,
                                          16, 8)
    for kw in ({}, {"window": 50}):
        torch.testing.assert_close(
            DA.paged_decode_attention(q, kp, vp, tables, kv, **kw).float(),
            DA.paged_decode_attention_ref(q, kp, vp, tables, kv, **kw)
            .float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
def test_decode_captures_into_a_cuda_graph_and_counts_calls():
    """One K2 call is two device kernels (splits, combine) and one count; it
    needs no host sync, so it captures into a CUDA graph, and a replay reads
    kv_len from the device."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(10)
    q = _randn(gen, (4, 32, 1, 128), torch.bfloat16)
    k = _randn(gen, (4, 8, 544, 128), torch.bfloat16)
    v = _randn(gen, (4, 8, 544, 128), torch.bfloat16)
    kv = torch.tensor([40, 130, 300, 528], dtype=torch.int32, device="cuda")
    before = DA.decode_attention.launches
    eager = DA.decode_attention(q, k, v, kv)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = DA.decode_attention(q, k, v, kv)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    kv += 1
    g.replay()
    torch.testing.assert_close(out.float(),
                               DA.decode_attention_ref(q, k, v, kv).float(),
                               atol=2e-2, rtol=2e-2)
    assert DA.decode_attention.launches == before + 2


@pytest.mark.gpu
def test_launch_counters_count_kernel_launches():
    """One count per call of K1, K3 (two device kernels) and K5 (three);
    the plain versions count nothing."""
    _need_card()
    q = torch.zeros((1, 2, 8, 64), device="cuda")
    before = FA.flash_attention.launches
    FA.flash_attention(q, q, q)
    FA.flash_attention_ref(q, q, q)
    assert FA.flash_attention.launches == before + 1
    pool = torch.zeros((4, 1, 16, 64), device="cuda")
    tables = torch.ones((1, 2), dtype=torch.int32, device="cuda")
    kv = torch.full((1,), 20, dtype=torch.int32, device="cuda")
    q1 = q[:, :, :1].contiguous()
    before = DA.paged_decode_attention.launches
    DA.paged_decode_attention(q1, pool, pool, tables, kv)
    DA.paged_decode_attention_ref(q1, pool, pool, tables, kv)
    assert DA.paged_decode_attention.launches == before + 1
    gen = torch.Generator(device="cuda").manual_seed(4)
    inp = _ssd_inputs(gen, 1, 2, 40, 32, torch.bfloat16, 32)
    before = SS.ssd_scan.launches
    SS.ssd_scan(*inp, chunk=32)
    SS.ssd_scan_ref(*inp, chunk=32)
    assert SS.ssd_scan.launches == before + 1


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", SS.HEAD_DIMS)
@pytest.mark.parametrize("N", SS.STATE_DIMS)
@pytest.mark.parametrize("chunk", SS.CHUNKS)
def test_ssd_scan_every_instantiation_on_card(dtype, P, N, chunk):
    """K5 v2 (three passes) at every (dtype, P, N, chunk) it is built for,
    B = 2 and a ragged S of three chunks, against the chunked plain version
    and the sequential oracle, y and the final state."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    S = 2 * chunk + chunk // 3 + 1
    inp = _ssd_inputs(gen, 2, 3, S, N, dtype, P)
    tol = SSD_TOL[dtype]
    y, fs = SS.ssd_scan(*inp, chunk=chunk)
    torch.cuda.synchronize()
    for want_y, want_fs in (SS.ssd_scan_ref(*inp, chunk=chunk),
                            ref.ssd_scan(*inp)):
        torch.testing.assert_close(y.float(), want_y.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(fs, want_fs, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("P", SS.HEAD_DIMS)
@pytest.mark.parametrize("N", SS.STATE_DIMS)
@pytest.mark.parametrize("chunk", SS.CHUNKS)
@pytest.mark.parametrize("part", ["short", "one", "slab", "ragged"])
def test_ssd_scan_f32_v3_edges_on_card(P, N, chunk, part):
    """K5's float32 kernels (v3) at every (P, N, chunk) against the chunked
    plain version and the sequential oracle, y and the final state: S <
    chunk (chunk 0 alone), exactly one chunk, a last chunk whose final slab
    holds one row, and three chunks with a ragged last one. Two calls give
    the same bits."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    S = {"short": chunk // 3 + 5, "one": chunk,
         "slab": 2 * chunk - SS.slab_rows(chunk) + 1,
         "ragged": 2 * chunk + chunk // 3 + 1}[part]
    inp = _ssd_inputs(gen, 2, 3, S, N, torch.float32, P)
    tol = SSD_TOL[torch.float32]
    y, fs = SS.ssd_scan(*inp, chunk=chunk)
    y2, fs2 = SS.ssd_scan(*inp, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(fs, fs2)
    for want_y, want_fs in (SS.ssd_scan_ref(*inp, chunk=chunk),
                            ref.ssd_scan(*inp)):
        torch.testing.assert_close(y, want_y, atol=tol, rtol=tol)
        torch.testing.assert_close(fs, want_fs, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_ssd_scan_captures_into_a_cuda_graph():
    """A K5 call (three device kernels, a workspace from torch.empty) needs
    no host sync: it captures into a CUDA graph, and a replay on new inputs
    gives their scan. One count per call."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    inp = _ssd_inputs(gen, 1, 24, 300, 128, torch.bfloat16, 64)
    before = SS.ssd_scan.launches
    eager = SS.ssd_scan(*inp)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y, fs = SS.ssd_scan(*inp)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, eager[0]) and torch.equal(fs, eager[1])
    for t, new in zip(inp, _ssd_inputs(gen, 1, 24, 300, 128, torch.bfloat16,
                                       64)):
        t.copy_(new)
    g.replay()
    want_y, want_fs = SS.ssd_scan_ref(*inp)
    tol = SSD_TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(fs, want_fs, atol=tol, rtol=tol)
    assert SS.ssd_scan.launches == before + 2


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
    with pytest.raises(ValueError, match="passes"):
        SS.launch_passes(x, dt, A, Bm, Cm, passes=8)
    with pytest.raises(ValueError, match="workspace"):
        SS.launch_passes(x, dt, A, Bm, Cm, chunk=32,
                         ws=SS.workspace(x, 64, 128))
    before = SS.ssd_scan.launches
    SS.ssd_scan(x, dt, A, Bm, Cm)
    SS.ssd_scan_ref(x, dt, A, Bm, Cm)
    assert SS.ssd_scan.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kernels", [
    ("mamba2-130m", (SS.ssd_scan,)),
    ("zamba2-1.2b", (SS.ssd_scan, FA.flash_attention, DA.decode_attention)),
    ("phi3.5-moe-42b-a6.6b", (FA.flash_attention, DA.decode_attention))])
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


# ------------------------------------------------------------------ K4
QUANT_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GATHER_TOL = 3e-5     # fused vs the gather oracle, tests/test_autotune.py


def _int8_inputs(gen, dtype, B, Hq, Hkv, D, bs, num_blocks, kv_len):
    """int8 pools and float32 scale pools with random contents; each lane's
    table holds distinct random blocks (never the null block 0), dead
    entries 0."""
    mb = -(-max(kv_len) // bs) + 1
    q = _randn(gen, (B, Hq, 1, D), dtype)
    kp = torch.randint(-127, 128, (num_blocks, Hkv, bs, D), generator=gen,
                       device="cuda").to(torch.int8)
    vp = torch.randint(-127, 128, (num_blocks, Hkv, bs, D), generator=gen,
                       device="cuda").to(torch.int8)
    ks = torch.rand((num_blocks, Hkv, bs, 1), generator=gen,
                    device="cuda") * 0.015 + 0.005
    vs = torch.rand((num_blocks, Hkv, bs, 1), generator=gen,
                    device="cuda") * 0.015 + 0.005
    perm = torch.randperm(num_blocks - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((B, mb), dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(kv_len):
        nb = -(-n // bs)
        tables[b, :nb] = perm[used:used + nb].to(torch.int32)
        used += nb
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return q, kp, vp, ks, vs, tables, kvl


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    dict(B=4, Hq=32, Hkv=8, D=128, bs=16, nb=1024, kv_len=[40, 130, 300, 528]),
    dict(B=3, Hq=4, Hkv=1, D=64, bs=8, nb=64, kv_len=[1, 45, 96])])
@pytest.mark.parametrize("kw", [{}, {"softcap": 30.0}, {"window": 64},
                                {"softcap": 20.0, "window": 100}])
def test_int8_kernel_matches_plain_and_gather_on_card(dtype, shape, kw):
    """K4 against its plain version (the scale-folded read) at mistral-7b's
    serving shape and a reduced D = 64 one, and, in float32, against the
    gather oracle."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    inp = _int8_inputs(gen, dtype, shape["B"], shape["Hq"], shape["Hkv"],
                       shape["D"], shape["bs"], shape["nb"], shape["kv_len"])
    got = DA.paged_decode_attention_int8(*inp, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == inp[0].shape
    tol = QUANT_TOL[dtype]
    torch.testing.assert_close(
        got.float(), DA.paged_decode_attention_int8_ref(*inp, **kw).float(),
        atol=tol, rtol=tol)
    if dtype == torch.float32:
        torch.testing.assert_close(
            got, ref.paged_decode_attention_quant(*inp[:6], kv_len=inp[6],
                                                  **kw),
            atol=GATHER_TOL, rtol=GATHER_TOL)


@pytest.mark.gpu
def test_int8_read_path_follows_the_cache_on_card():
    """``ops.paged_decode_attention_quant`` on CUDA tensors: with no cache
    the gather path launches K2 and not K4; a "cuda" cache entry that routes
    ``fused`` launches K4 (and no K2)."""
    _need_card()
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(5)
    inp = _int8_inputs(gen, torch.bfloat16, 4, 32, 8, 128, 16, 1024,
                       [40, 130, 300, 528])
    bucket = AT.shape_bucket("paged_decode_quant", b=4,
                             c=inp[5].shape[1] * 16)
    k2, k4 = DA.decode_attention.launches, \
        DA.paged_decode_attention_int8.launches
    AT.install(None)
    gather = ops.paged_decode_attention_quant(*inp)
    assert (DA.decode_attention.launches, DA.paged_decode_attention_int8
            .launches) == (k2 + 1, k4)
    entry = AT.TunedEntry(kernel="paged_decode_quant", backend="cuda",
                          bucket=bucket, params={"impl": "fused"}, t_s=1.0,
                          t_default_s=1.0, noise_frac=0.0, flops=0.0,
                          bytes=0.0, ctx=0.0)
    prev = AT.install(AT.AutotuneCache("test", "cuda", entries=[entry]))
    try:
        fused = ops.paged_decode_attention_quant(*inp)
    finally:
        AT.install(prev)
    assert (DA.decode_attention.launches, DA.paged_decode_attention_int8
            .launches) == (k2 + 1, k4 + 1)
    torch.testing.assert_close(fused.float(), gather.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
def test_int8_wrapper_raises_on_inputs_it_does_not_take():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, kp, vp, ks, vs, tables, kvl = _int8_inputs(
        gen, torch.float32, 2, 4, 2, 64, 16, 16, [5, 30])
    with pytest.raises(ValueError, match="int8"):
        DA.paged_decode_attention_int8(q, kp.float(), vp.float(), ks, vs,
                                       tables, kvl)
    with pytest.raises(ValueError, match="k_scale_pool"):
        DA.paged_decode_attention_int8(q, kp, vp, ks[..., 0].contiguous(), vs,
                                       tables, kvl)
    with pytest.raises(ValueError, match="float32"):
        DA.paged_decode_attention_int8(q, kp, vp, ks.bfloat16(), vs, tables,
                                       kvl)
    with pytest.raises(ValueError, match="contiguous"):
        DA.paged_decode_attention_int8(q, kp.transpose(0, 1).contiguous()
                                       .transpose(0, 1), vp, ks, vs, tables,
                                       kvl)
    with pytest.raises(ValueError, match="head dim"):
        DA.paged_decode_attention_int8(q[..., :32].contiguous(),
                                       kp[..., :32].contiguous(),
                                       vp[..., :32].contiguous(), ks, vs,
                                       tables, kvl)
    before = DA.paged_decode_attention_int8.launches
    DA.paged_decode_attention_int8(q, kp, vp, ks, vs, tables, kvl)
    DA.paged_decode_attention_int8_ref(q, kp, vp, ks, vs, tables, kvl)
    assert DA.paged_decode_attention_int8.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("span", [8, 16])
@pytest.mark.parametrize("block_k", [32, 64, 128])
@pytest.mark.parametrize("G,D", [(1, 128), (4, 64), (4, 128)])
def test_int8_split_edges_on_card(dtype, span, block_k, G, D):
    """K4 v3 (K3's split-KV over int8 rows) at kv_len 0 and on both sides
    of a split edge, with a window of 71 that cuts splits and a softcap of
    20, against its plain version (and in float32 the gather oracle) on
    rows with a valid key; the kv_len 0 lane is 0."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(14)
    kv_len = [0, 1, block_k - 1, block_k, block_k + 1, 2 * block_k + 9]
    nb = 1 + sum(-(-n // span) for n in kv_len)
    inp = _int8_inputs(gen, dtype, len(kv_len), G * 2, 2, D, span, nb, kv_len)
    rows = inp[6] > 0
    tol = QUANT_TOL[dtype]
    for kw in ({}, {"window": 71}, {"softcap": 20.0}):
        got = DA.paged_decode_attention_int8(*inp, block_k=block_k, **kw)
        want = DA.paged_decode_attention_int8_ref(*inp, **kw)
        torch.testing.assert_close(got[rows].float(), want[rows].float(),
                                   atol=tol, rtol=tol)
        assert torch.count_nonzero(got[~rows]) == 0
        if dtype == torch.float32:
            oracle = ref.paged_decode_attention_quant(*inp[:6], kv_len=inp[6],
                                                      **kw)
            torch.testing.assert_close(got[rows], oracle[rows],
                                       atol=GATHER_TOL, rtol=GATHER_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_many_query_heads_per_kv_head_on_card(dtype):
    """falcon-7b's grouping, 71 query heads on one KV head at D = 64: K4
    scores its rows four per pass (18 passes) over int8 rows."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(15)
    inp = _int8_inputs(gen, dtype, 2, 71, 1, 64, 16, 16, [37, 100])
    for kw in ({}, {"window": 50}):
        torch.testing.assert_close(
            DA.paged_decode_attention_int8(*inp, **kw).float(),
            DA.paged_decode_attention_int8_ref(*inp, **kw).float(),
            atol=QUANT_TOL[dtype], rtol=QUANT_TOL[dtype])


@pytest.mark.gpu
def test_int8_paged_decode_captures_into_a_cuda_graph():
    """A K4 call (split and combine, a workspace from torch.empty) needs no
    host sync, so it captures into a CUDA graph and a replay reads the new
    kv_len. One count per call."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(16)
    inp = _int8_inputs(gen, torch.bfloat16, 4, 32, 8, 128, 16, 1024,
                       [40, 130, 300, 528])
    kv = inp[6]
    before = DA.paged_decode_attention_int8.launches
    eager = DA.paged_decode_attention_int8(*inp)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = DA.paged_decode_attention_int8(*inp)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    kv -= 7
    g.replay()
    torch.testing.assert_close(
        out.float(), DA.paged_decode_attention_int8_ref(*inp).float(),
        atol=2e-2, rtol=2e-2)
    assert DA.paged_decode_attention_int8.launches == before + 2


@pytest.mark.gpu
def test_int8_paged_decode_refuses_a_split_it_does_not_take():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(17)
    inp = _int8_inputs(gen, torch.float32, 1, 2, 1, 64, 16, 4, [20])
    before = DA.paged_decode_attention_int8.launches
    for bk in (16, 48, 96, 256):
        with pytest.raises(ValueError, match="block_k"):
            DA.paged_decode_attention_int8(*inp, block_k=bk)
    assert DA.paged_decode_attention_int8.launches == before


# -------------------------------- K2, K3, K4: the work list at serving shape
SERVE_SPAN, SERVE_TABLE, SERVE_WINDOW = 16, 384, 4096   # mistral-7b's pools


def _serving_lanes(geometry, seed):
    """kv_len of 128 lane slots as a mistral7b cell decodes them
    (``chip_smoke.serving_lanes``): chat, 21 live lanes of 40-300 keys;
    longprompt, 9 of 1,500-4,200 (past the window); the other slots dead
    (kv_len 1, one of them 0), the live ones scattered among them."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from chip_smoke import serving_lanes
    return serving_lanes(torch, geometry, seed)


def _fill_tables(gen, tables, kv_len, num_blocks):
    """Each lane's live entries distinct random pool blocks (never the null
    block 0), its dead entries 0; written in place."""
    perm = torch.randperm(num_blocks - 1, generator=gen, device="cuda") + 1
    tables.zero_()
    used = 0
    for b, n in enumerate(kv_len):
        nb = -(-n // SERVE_SPAN)
        tables[b, :nb] = perm[used:used + nb].to(torch.int32)
        used += nb


def _serving_call(kernel, gen, num_blocks):
    """(call, plain) of K2, K3 or K4 at mistral-7b's serving shape (128
    lanes, 32 query heads on 8 KV heads of 128, bf16, window 4096) on
    random inputs: dense caches of 6,144 rows, or pools of ``num_blocks``
    blocks of 16 read through 384-entry tables; and (kv_len, tables), for
    the caller to fill."""
    B, D, rows = 128, 128, SERVE_SPAN * SERVE_TABLE
    q = _randn(gen, (B, 32, 1, D), torch.bfloat16)
    kv = torch.ones(B, dtype=torch.int32, device="cuda")
    tables = torch.zeros((B, SERVE_TABLE), dtype=torch.int32, device="cuda")
    kw = dict(window=SERVE_WINDOW)
    if kernel == "K2":
        k, v = (_randn(gen, (B, 8, rows, D), torch.bfloat16) for _ in "kv")
        args = (q, k, v, kv)
        return (lambda: DA.decode_attention(*args, **kw),
                lambda: DA.decode_attention_ref(*args, **kw), kv, tables)
    shape = (num_blocks, 8, SERVE_SPAN, D)
    if kernel == "K3":
        kp, vp = (_randn(gen, shape, torch.bfloat16) for _ in "kv")
        args = (q, kp, vp, tables, kv)
        return (lambda: DA.paged_decode_attention(*args, **kw),
                lambda: DA.paged_decode_attention_ref(*args, **kw), kv,
                tables)
    kp, vp = (torch.randint(-127, 128, shape, generator=gen, device="cuda")
              .to(torch.int8) for _ in "kv")
    ks, vs = (torch.rand(shape[:3] + (1,), generator=gen, device="cuda")
              * 0.015 + 0.005 for _ in "kv")
    args = (q, kp, vp, ks, vs, tables, kv)
    return (lambda: DA.paged_decode_attention_int8(*args, **kw),
            lambda: DA.paged_decode_attention_int8_ref(*args, **kw), kv,
            tables)


def _set_lanes(gen, kv, tables, kv_len, num_blocks):
    kv.copy_(torch.tensor(kv_len, dtype=torch.int32))
    _fill_tables(gen, tables, kv_len, num_blocks)


@pytest.mark.gpu
@pytest.mark.parametrize("geometry", ["chat", "longprompt"])
@pytest.mark.parametrize("kernel", ["K3", "K2", "K4"])
def test_work_list_at_the_serving_geometry_on_card(kernel, geometry):
    """K3 (and K2 and K4, which share its split kernel) at the mistral7b
    cells' decode shapes: 128 lane slots, most dead at kv_len 1, one at 0,
    the live lanes scattered; against their plain versions on rows with a
    key, and 0 on the lane without."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(21)
    kv_len = _serving_lanes(geometry, 3)
    num_blocks = 1 + sum(-(-n // SERVE_SPAN) for n in kv_len)
    call, plain, kv, tables = _serving_call(kernel, gen, num_blocks)
    _set_lanes(gen, kv, tables, kv_len, num_blocks)
    got, want = call(), plain()
    torch.cuda.synchronize()
    rows = kv > 0
    torch.testing.assert_close(got[rows].float(), want[rows].float(),
                               atol=2e-2, rtol=2e-2)
    assert torch.count_nonzero(got[~rows]) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K3", "K2", "K4"])
def test_work_list_follows_the_replay_on_card(kernel):
    """One call captured into a CUDA graph at chat's lanes, then replayed
    after kv_len and the tables were rewritten in place: longprompt's lanes
    (several times the items), every lane dead, chat's again. Each replay
    equals the plain version on the replay's inputs, and the eager call on
    them bit for bit: the grid is fixed, the work list the replay's."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(22)
    lanes = [_serving_lanes("chat", 5), _serving_lanes("longprompt", 6),
             [1] * 128, _serving_lanes("chat", 7)]
    num_blocks = 1 + max(sum(-(-n // SERVE_SPAN) for n in kv_len)
                         for kv_len in lanes)
    call, plain, kv, tables = _serving_call(kernel, gen, num_blocks)
    _set_lanes(gen, kv, tables, lanes[0], num_blocks)
    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = call()
    for kv_len in lanes:
        _set_lanes(gen, kv, tables, kv_len, num_blocks)
        g.replay()
        torch.cuda.synchronize()
        rows = kv > 0
        torch.testing.assert_close(out[rows].float(), plain()[rows].float(),
                                   atol=2e-2, rtol=2e-2)
        assert torch.count_nonzero(out[~rows]) == 0
        assert torch.equal(out, call())


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_work_list_over_more_lanes_than_a_list_on_card(kernel):
    """300 lanes: the split kernel lists them 128 at a time, each list's
    items numbered after the last's; kv_len 0, 1 and up to the
    cache's extent, a window of 50, against the plain versions."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(23)
    g = torch.Generator().manual_seed(8)
    kv_len = torch.randint(0, 161, (300,), generator=g).tolist()
    kv_len[:3], kv_len[-3:] = [0, 1, 160], [160, 1, 0]
    for kw in ({}, {"window": 50}):
        if kernel == "K2":
            q = _randn(gen, (300, 8, 1, 64), torch.float32)
            k, v = (_randn(gen, (300, 2, 160, 64), torch.float32)
                    for _ in "kv")
            kv = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
            got = DA.decode_attention(q, k, v, kv, block_k=32, **kw)
            want = DA.decode_attention_ref(q, k, v, kv, **kw)
        else:
            q, kp, vp, tables, kv = _paged_inputs(
                gen, torch.float32, kv_len, 4, 2, 64, 16, 10)
            got = DA.paged_decode_attention(q, kp, vp, tables, kv,
                                            block_k=32, **kw)
            want = DA.paged_decode_attention_ref(q, kp, vp, tables, kv, **kw)
        rows = kv > 0
        torch.testing.assert_close(got[rows], want[rows], atol=2e-5,
                                   rtol=2e-5)
        assert torch.count_nonzero(got[~rows]) == 0


# ---------------------------------------------------------- KV handoff
@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8"])
def test_migrated_blocks_read_like_the_source_on_card(kind):
    """``migrate_kv_blocks`` on the card: a ragged set of blocks in random
    order copied bit for bit, the source unchanged, the other destination
    blocks untouched; K3 (K4 for int8) over the destination pool and tables
    equal, bit for bit, to K3 (K4) over the source's, and within the plain
    version's tolerance."""
    _need_card()
    from repro_torch.serving.batching import migrate_kv_blocks
    gen = torch.Generator(device="cuda").manual_seed(3)
    layers, hq, hkv, bs, d = 2, 8, 2, 8, 64
    kv_len = [1, 17, 40, 77]
    nblk = [-(-n // bs) for n in kv_len]
    total = sum(nblk)
    nb = 2 * total
    shape = (layers, nb, hkv, bs, d)
    src, dst = (kv_pools(gen, kind, shape, "cuda") for _ in range(2))
    ids = {n: ((torch.randperm(nb - 1, generator=gen, device="cuda") + 1)
               [:total].tolist()) for n in ("src", "dst")}
    tables = {}
    for n in ids:
        t = torch.zeros((len(kv_len), max(nblk)), dtype=torch.int32,
                        device="cuda")
        used = 0
        for b, k in enumerate(nblk):
            t[b, :k] = torch.tensor(ids[n][used:used + k], dtype=torch.int32)
            used += k
        tables[n] = t
    src_before = {k: v.clone() for k, v in src.items()}
    dst_before = {k: v.clone() for k, v in dst.items()}
    out, moved = migrate_kv_blocks(src, ids["src"], dst, ids["dst"])
    assert out is dst
    others = torch.ones(nb, dtype=torch.bool, device="cuda")
    others[ids["dst"]] = False
    for k in src:
        assert torch.equal(dst[k][:, ids["dst"]], src[k][:, ids["src"]])
        assert torch.equal(src[k], src_before[k])
        assert torch.equal(dst[k][:, others], dst_before[k][:, others])
    item = src["kp"].element_size()
    assert moved == total * layers * hkv * bs * (
        2 * d * item + (8 if kind == "int8" else 0))
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    qts = (torch.float32, torch.bfloat16) if kind == "int8" \
        else (getattr(torch, kind),)
    for layer in range(layers):
        for qt in qts:
            q = _randn(gen, (len(kv_len), hq, 1, d), qt)
            if kind == "int8":
                a, b = ((c["kp"][layer], c["vp"][layer], c["kp_scale"][layer],
                         c["vp_scale"][layer], tables[n])
                        for n, c in (("dst", dst), ("src", src)))
                fn, ref = (DA.paged_decode_attention_int8,
                           DA.paged_decode_attention_int8_ref)
            else:
                a, b = ((c["kp"][layer], c["vp"][layer], tables[n])
                        for n, c in (("dst", dst), ("src", src)))
                fn, ref = DA.paged_decode_attention, \
                    DA.paged_decode_attention_ref
            got = fn(q, *a, kvl)
            assert torch.equal(got, fn(q, *b, kvl))
            torch.testing.assert_close(got, ref(q, *b, kvl), atol=TOL[qt],
                                       rtol=TOL[qt])


@pytest.mark.gpu
def test_disaggregated_router_on_card():
    """Reduced smollm-360m on the card behind
    ``FleetRouter(policy="disaggregated")`` over the probe pool pair: every
    request held, its KV migrated between the paged pools on the card, K3
    launched on the decode pool, greedy tokens equal to solo generation,
    every block returned."""
    _need_card()
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.pricing import CostModel, CostParams
    from repro_torch.core.systems import SystemProfile
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.router import FleetRouter
    cfg = get_config("smollm-360m").reduced()
    gen = torch.Generator(device="cuda").manual_seed(7)
    eng = InferenceEngine(cfg, M.init_params(cfg, gen, torch.float32, "cuda"),
                          max_len=96, device="cuda")
    eff, perf = probe_pair(SystemProfile)
    router = FleetRouter(cfg, {"eff": eff, "perf": perf},
                         {"eff": eng, "perf": eng}, policy="disaggregated",
                         model=CostModel(get_config("smollm-360m"), None,
                                         CostParams(lam=1.0)))
    router.attach_batchers(slots=2, paged=True, num_blocks=48, block_size=8,
                           chunk=8)
    prompts = [np.arange(40 + 7 * i) % cfg.vocab_size for i in range(3)]
    before = DA.paged_decode_attention.launches
    routed = [router.submit(p, 6) for p in prompts]
    assert all(rr.request.hold for rr in routed)
    router.drain()
    assert not router._handoffs
    assert DA.paged_decode_attention.launches > before
    for rr, p in zip(routed, prompts):
        assert rr.request.done and not rr.request.hold
        solo = eng.generate({"tokens": torch.as_tensor(
            p, dtype=torch.int32, device="cuda")[None]}, 6)
        assert rr.request.out_tokens == list(solo.tokens[0])
    for cb in router.batchers.values():
        assert cb.free_blocks == cb.total_blocks


# ------------------------------------------- the MoE, VLM and audio families
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk", [(1500, 1500), (300, 300), (24, 1500)])
def test_flash_non_causal_at_whisper_lengths_on_card(dtype, Sq, Sk):
    """K1 non-causal at whisper-base's heads (8, D 64): the encoder's 1500
    frames (ragged q and K/V tiles: 1500 = 23 * 64 + 28), a ragged 300, and
    the cross prefill's short query on 1500 keys; every row is valid."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    q = _randn(gen, (2, 8, Sq, 64), dtype)
    k = _randn(gen, (2, 8, Sk, 64), dtype)
    v = _randn(gen, (2, 8, Sk, 64), dtype)
    torch.testing.assert_close(FA.flash_attention(q, k, v, causal=False),
                               FA.flash_attention_ref(q, k, v, causal=False),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_at_seven_query_heads_per_kv_head_on_card(dtype):
    """K1 at qwen2-vl-7b's grouping (28 query heads on 4 KV heads, D 128),
    causal, at a vision-plus-text length."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(12)
    q = _randn(gen, (1, 28, 283, 128), dtype)
    k = _randn(gen, (1, 4, 283, 128), dtype)
    v = _randn(gen, (1, 4, 283, 128), dtype)
    torch.testing.assert_close(FA.flash_attention(q, k, v),
                               FA.flash_attention_ref(q, k, v),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_k", [32, 64, 128])
@pytest.mark.parametrize("Hq,Hkv,D", [(28, 4, 128), (8, 8, 64)])
def test_decode_at_the_new_groupings_on_card(dtype, block_k, Hq, Hkv, D):
    """K2 at G = 7 (two passes of R = 4 and 3 rows: qwen2-vl-7b) and at
    G = 1, D 64 (whisper-base), kv_len on both sides of a split edge."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(13)
    edges = [1, block_k - 1, block_k, block_k + 1, 2 * block_k + 9]
    smax = edges[-1] + 3
    q = _randn(gen, (len(edges), Hq, 1, D), dtype)
    k = _randn(gen, (len(edges), Hkv, smax, D), dtype)
    v = _randn(gen, (len(edges), Hkv, smax, D), dtype)
    kvl = torch.tensor(edges, dtype=torch.int32, device="cuda")
    torch.testing.assert_close(
        DA.decode_attention(q, k, v, kvl, block_k=block_k),
        DA.decode_attention_ref(q, k, v, kvl), atol=TOL[dtype],
        rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("arch,key", [("qwen2-vl-7b", "vision"),
                                      ("whisper-base", "frames"),
                                      ("phi3.5-moe-42b-a6.6b", None)])
def test_family_engine_kernel_path_matches_plain_on_card(arch, key):
    """A reduced model of each new family on the card, float32: the engine's
    kernel path (K1, K2) gives the plain path's greedy tokens, and launches
    both kernels."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine
    cfg = get_config(arch).reduced()
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = M.init_params(cfg, gen, torch.float32, "cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 9), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    if key is not None:
        n = cfg.num_vision_tokens if key == "vision" else cfg.encoder_seq_len
        batch[key] = torch.randn((2, n, cfg.d_model), generator=gen,
                                 device="cuda")
    before = (FA.flash_attention.launches, DA.decode_attention.launches)
    toks = {b: InferenceEngine(cfg, params, max_len=64, backend=b,
                               device="cuda").generate(batch, 8).tokens
            for b in ("auto", "ref")}
    assert FA.flash_attention.launches > before[0]
    assert DA.decode_attention.launches > before[1]
    assert (toks["auto"] == toks["ref"]).all()


# ------------------------------------------------------------ K1-bwd
def _bwd_close(got, want, dtype):
    """Each gradient within TOL·max(1, ‖ref‖∞) of the plain version."""
    for g, w in zip(got, want):
        lim = TOL[dtype] * max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= lim


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,hq,hkv,Sq,Sk,D,kw", [
    (2, 6, 2, 100, 100, 64, dict(causal=True)),              # G = 3
    (1, 7, 1, 130, 130, 128, dict(causal=True)),             # G = 7
    (1, 4, 4, 150, 150, 64, dict(causal=True, window=17)),
    (1, 4, 2, 96, 96, 128, dict(causal=True, softcap=30.0, window=33)),
    (2, 4, 4, 24, 150, 64, dict(causal=False)),              # cross
    (1, 4, 4, 150, 150, 64, dict(causal=False)),
    (2, 15, 5, 300, 300, 64, dict(causal=True)),             # smollm ragged
    (1, 4, 2, 96, 96, 64, dict(causal=True, softcap=2.0, window=33))])
def test_flash_bwd_matches_plain_on_card(dtype, B, hq, hkv, Sq, Sk, D, kw):
    """K1-bwd, on the lse its forward wrote, against autograd of the plain
    version at reduced shapes, and the same bits on a second call (no
    atomics)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(Sq + hq)
    q = _randn(gen, (B, hq, Sq, D), dtype)
    k = _randn(gen, (B, hkv, Sk, D), dtype)
    v = _randn(gen, (B, hkv, Sk, D), dtype)
    do = _randn(gen, (B, hq, Sq, D), dtype)
    out, lse = FA._flash_attention_fwd(q, k, v, **kw)
    before = FA.flash_attention_bwd.launches
    got = FA.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    again = FA.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    assert FA.flash_attention_bwd.launches == before + 2
    assert all(g.dtype == dtype for g in got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _bwd_close(got, FA.flash_attention_bwd_ref(q, k, v, do, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_gradients_through_ops_on_card(dtype):
    """ops.flash_attention under grad goes through the autograd Function:
    one K1 and one K1-bwd launch, gradients equal to the plain path's.
    Without grad it launches K1 alone, as on the serving path."""
    from repro_torch.kernels import ops
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    leaves = [_randn(gen, s, dtype).requires_grad_(True) for s in
              ((2, 6, 70, 64), (2, 2, 70, 64), (2, 2, 70, 64))]
    do = _randn(gen, (2, 6, 70, 64), dtype)
    n1, nb = FA.flash_attention.launches, FA.flash_attention_bwd.launches
    out = ops.flash_attention(*leaves, causal=True, window=40)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    assert FA.flash_attention.launches == n1 + 1
    assert FA.flash_attention_bwd.launches == nb + 1
    ref_out = ops.flash_attention(*leaves, causal=True, window=40,
                                  backend="ref")
    want = torch.autograd.grad(ref_out, leaves, do)
    _bwd_close(got, want, dtype)
    with torch.no_grad():
        ops.flash_attention(*leaves, causal=True)
    assert FA.flash_attention.launches == n1 + 2
    assert FA.flash_attention_bwd.launches == nb + 1
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(*leaves, q_offset=3)


@pytest.mark.gpu
def test_kernels_without_a_backward_raise_under_grad():
    """K2, K3 and K4 (decode only) refuse a CUDA input that requires grad
    under grad mode (their outputs would carry no gradient). Under no_grad
    they run."""
    from repro_torch.kernels import ops
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = _randn(gen, (1, 4, 1, 64), torch.float32).requires_grad_(True)
    kc = _randn(gen, (1, 2, 32, 64), torch.float32)
    kv = torch.tensor([20], dtype=torch.int32, device="cuda")
    pool = kc.reshape(1, 2, 2, 16, 64).permute(0, 2, 1, 3, 4) \
        .reshape(2, 2, 16, 64).contiguous()
    tables = torch.tensor([[0, 1]], dtype=torch.int32, device="cuda")
    p8 = torch.zeros((2, 2, 16, 64), dtype=torch.int8, device="cuda")
    sc = torch.full((2, 2, 16, 1), 0.01, device="cuda")
    calls = [
        lambda: ops.decode_attention(q, kc, kc, kv),
        lambda: ops.paged_decode_attention(q, pool, pool, tables, kv),
        lambda: ops.paged_decode_attention_quant(q, p8, p8, sc, sc, tables,
                                                 kv, impl="fused"),
        lambda: ops.paged_decode_attention_quant(q, p8, p8, sc, sc, tables,
                                                 kv, impl="gather")]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            assert call().shape == q.shape


# ------------------------------------------------------------ K5-bwd
def _ssd_bwd_close(got, want, dtype):
    """Each gradient within SSD_TOL·max(1, ‖ref‖∞) of the plain version."""
    for g, w in zip(got, want):
        lim = SSD_TOL[dtype] * max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= lim


@pytest.mark.gpu
@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", SS.HEAD_DIMS)
@pytest.mark.parametrize("N", SS.STATE_DIMS)
@pytest.mark.parametrize("chunk", SS.CHUNKS)
def test_ssd_bwd_every_instantiation_on_card(dtype, P, N, chunk, with_final):
    """K5-bwd at every (dtype, P, N, chunk) it is built for, B = 2, H = 3
    and a ragged S of three chunks, with and without a final-state
    gradient, against autograd of the plain version; a second call gives
    the same bits (no atomics), one count per call."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    S = 2 * chunk + chunk // 3 + 1
    inp = _ssd_inputs(gen, 2, 3, S, N, dtype, P)
    dy = _randn(gen, (2, 3, S, P), dtype)
    dfinal = _randn(gen, (2, 3, P, N), torch.float32) if with_final else None
    ws = SS.workspace(inp[0], N, chunk)
    SS.ssd_scan(*inp, chunk=chunk, ws=ws)
    before = SS.ssd_scan_bwd.launches
    got = SS.ssd_scan_bwd(*inp, dy, dfinal, chunk=chunk, ws=ws)
    again = SS.ssd_scan_bwd(*inp, dy, dfinal, chunk=chunk, ws=ws)
    assert SS.ssd_scan_bwd.launches == before + 2
    assert [g.dtype for g in got] == [t.dtype for t in inp]
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _ssd_bwd_close(got, SS.ssd_scan_bwd_ref(*inp, dy, dfinal, chunk=chunk),
                   dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,N", [(8, 24, 128), (2, 64, 64)])
def test_ssd_bwd_v2_repeats_its_bits_at_the_training_shapes(B, H, N):
    """K5-bwd v2 at mamba2-130m's and zamba2-1.2b's training shapes (S 512,
    P 64, chunk 128, float32), with a final-state gradient: three calls
    give the same bits (fixed-order sums, no atomics), within the gate of
    the plain version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(9)
    inp = _ssd_inputs(gen, B, H, 512, N, torch.float32, 64)
    dy = _randn(gen, (B, H, 512, 64), torch.float32)
    dfinal = _randn(gen, (B, H, 64, N), torch.float32)
    ws = SS.workspace(inp[0], N, 128)
    SS.ssd_scan(*inp, chunk=128, ws=ws)
    runs = [SS.ssd_scan_bwd(*inp, dy, dfinal, chunk=128, ws=ws)
            for _ in range(3)]
    torch.cuda.synchronize()
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], again))
    _ssd_bwd_close(runs[0], SS.ssd_scan_bwd_ref(*inp, dy, dfinal, chunk=128),
                   torch.float32)


@pytest.mark.gpu
def test_ssd_bwd_wrapper_refuses():
    """K5-bwd raises on what it does not take: no workspace, one of another
    shape, a dy of another dtype, a dfinal of another shape."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    inp = _ssd_inputs(gen, 1, 2, 64, 64, torch.float32)
    dy = _randn(gen, (1, 2, 64, 64), torch.float32)
    ws = SS.workspace(inp[0], 64, 32)
    SS.ssd_scan(*inp, chunk=32, ws=ws)
    with pytest.raises(ValueError, match="workspace"):
        SS.ssd_scan_bwd(*inp, dy, chunk=32)
    with pytest.raises(ValueError, match="workspace"):
        SS.ssd_scan_bwd(*inp, dy, chunk=128, ws=ws)
    with pytest.raises(ValueError, match="dy"):
        SS.ssd_scan_bwd(*inp, dy.bfloat16(), chunk=32, ws=ws)
    with pytest.raises(ValueError, match="dfinal"):
        SS.ssd_scan_bwd(*inp, dy, torch.zeros((1, 2, 64, 32), device="cuda"),
                        chunk=32, ws=ws)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_gradients_through_ops_on_card(dtype):
    """ops.ssd_scan under grad goes through the autograd Function: one K5
    and one K5-bwd launch, gradients of y and of the final state equal to
    the plain path's; with the final state unused too. Without grad it
    launches K5 alone, as on the serving path."""
    from repro_torch.kernels import ops
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(9)
    inp = _ssd_inputs(gen, 2, 3, 150, 64, dtype, 32)
    leaves = [t.clone().requires_grad_(True) for t in inp]
    dy = _randn(gen, (2, 3, 150, 32), dtype)
    dfs = _randn(gen, (2, 3, 32, 64), torch.float32)
    for with_final in (True, False):
        n5, nb = SS.ssd_scan.launches, SS.ssd_scan_bwd.launches
        y, fs = ops.ssd_scan(*leaves, chunk=32)
        assert y.grad_fn is not None
        outs, seeds = ([y, fs], [dy, dfs]) if with_final else ([y], [dy])
        got = torch.autograd.grad(outs, leaves, seeds)
        assert SS.ssd_scan.launches == n5 + 1
        assert SS.ssd_scan_bwd.launches == nb + 1
        ry, rfs = ops.ssd_scan(*leaves, chunk=32, backend="ref")
        routs = [ry, rfs] if with_final else [ry]
        _ssd_bwd_close(got, torch.autograd.grad(routs, leaves, seeds), dtype)
    with torch.no_grad():
        ops.ssd_scan(*leaves, chunk=32)
    assert SS.ssd_scan.launches == n5 + 2
    assert SS.ssd_scan_bwd.launches == nb + 1


@pytest.mark.gpu
@pytest.mark.parametrize("arch,bwd", [
    ("smollm-360m", {"flash_attention_bwd"}),
    ("whisper-base", {"flash_attention_bwd"}),
    ("mamba2-130m", {"ssd_scan_bwd"}),
    ("zamba2-1.2b", {"flash_attention_bwd", "ssd_scan_bwd"})])
def test_reduced_train_step_on_card_matches_plain(arch, bwd):
    """Reduced train steps on the card, float32, kernel path (K1 and K1-bwd,
    K5 and K5-bwd, as the family has them) against the plain path: loss
    within 1e-5, every gradient leaf non-zero and within 1e-4·max(1,
    ‖g‖∞), and the loss after two AdamW steps within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as OPT
    from repro_torch.training import train as T
    _need_card()
    cfg = get_config(arch).reduced()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, torch.float32, "cuda",
                           max_positions=256)
    batch = next(D.arithmetic_stream(cfg, 2, 64, 1, seed=0, device="cuda"))
    opt = OPT.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    out = {}
    counts = {"flash_attention_bwd": FA.flash_attention_bwd,
              "ssd_scan_bwd": SS.ssd_scan_bwd}
    for backend in ("auto", "ref"):
        before = {k: f.launches for k, f in counts.items()}
        loss, _, grads = T.loss_and_grads(params, cfg, batch, backend=backend)
        step = T.make_train_step(cfg, opt, backend=backend)
        p2, s2, _ = step(params, OPT.init_state(params), batch)
        _, _, m = step(p2, s2, batch)
        launched = {k for k, f in counts.items() if f.launches > before[k]}
        assert launched == (bwd if backend == "auto" else set())
        out[backend] = loss, grads, m["loss"]
    assert abs(float(out["auto"][0]) - float(out["ref"][0])) < 1e-5
    for g, w in zip(OPT.tree_leaves(out["auto"][1]),
                    OPT.tree_leaves(out["ref"][1])):
        assert g.abs().sum().item() > 0
        lim = 1e-4 * max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= lim
    assert abs(float(out["auto"][2]) - float(out["ref"][2])) < 1e-4


# ------------------------------------------------------------ the dry run
@pytest.mark.gpu
@pytest.mark.parametrize("arch,kind,B,S,kv_quant", [
    ("mistral-7b", "decode", 8, 4096, False),
    ("mistral-7b", "decode", 8, 4096, True),
    ("zamba2-1.2b", "train", 2, 512, False),
    ("whisper-base", "prefill", 4, 448, False)])
def test_dry_run_bytes_are_the_cards(arch, kind, B, S, kv_quant,
                                     monkeypatch):
    """``input_specs`` on the card gives the meta device's leaves, their
    storage is the dry run's ``argument_size_in_bytes`` on a 1x1 mesh and
    the bytes the allocator was asked for, and ``memory_allocated`` grows
    by that plus the allocator's rounding: 512 bytes a leaf, and 1 MiB
    more a leaf over 1 MiB (the rest of a free block it does not split
    off)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import input_specs as IS
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.sharding import specs as SH
    _need_card()
    torch.cuda.init()           # the allocator's stats exist from here on
    monkeypatch.delenv("REPRO_KV_QUANT", raising=False)
    if kv_quant:
        monkeypatch.setenv("REPRO_KV_QUANT", "1")
    cfg, shape = get_config(arch), InputShape(f"{kind}_{S}", S, B, kind)
    meta = IS.input_specs(cfg, shape)
    want = DR.argument_bytes(MeshSpec(("data", "model"), (1, 1)), cfg, shape,
                             args=meta)["argument_size_in_bytes"]
    requested = lambda: torch.cuda.memory_stats()[
        "requested_bytes.all.current"]
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(), requested()
    real = IS.input_specs(cfg, shape, device="cuda")
    grown = torch.cuda.memory_allocated() - before[0]
    asked = requested() - before[1]
    m, r = {}, {}
    for i, (a, b) in enumerate(zip(meta, real)):
        SH.map_with_path(lambda p, t, i=i: m.__setitem__(f"{i}/{p}", t), a)
        SH.map_with_path(lambda p, t, i=i: r.__setitem__(f"{i}/{p}", t), b)
    assert m.keys() == r.keys()
    for k in m:
        assert (m[k].shape, m[k].dtype) == (r[k].shape, r[k].dtype), k
    sizes = [t.untyped_storage().nbytes() for t in r.values()]
    assert sum(sizes) == want == asked
    slack = sum(512 + (2**20 if n > 2**20 else 0) for n in sizes)
    assert 0 <= grown - want <= slack


@pytest.mark.gpu
def test_params_round_trip_as_dtensors_on_a_1_rank_nccl_mesh(tmp_path):
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.sharding import specs as SH
    from _torch_mesh import round_trip
    _need_card()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1)
        params = M.init_params(get_config("smollm-360m"),
                               torch.Generator("cuda").manual_seed(0),
                               torch.bfloat16, "cuda")
        local, same = round_trip(mesh, params)
    finally:
        dist.destroy_process_group()
    assert same
    leaves = {}
    SH.map_with_path(leaves.__setitem__, params)
    assert {p: list(t.shape) for p, t in leaves.items()} == local


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_dry_run_cost_is_the_cards(kind):
    """chip_smoke.py's phase 12 at reduced smollm-360m: ``analyze``'s FLOPs
    for one device (plain meta tensors, and a 1x1 mesh of DTensors) equal
    FlopCounterMode's on the card, and its temporary bytes the
    allocator's requested-bytes peak within 2% + 64 MiB."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import MeshSpec
    _need_card()
    cfg = get_config("smollm-360m").reduced()
    shape = InputShape(f"{kind}_128", 128, 4, kind)
    pred = DR.analyze(cfg, shape)
    one = MeshSpec(("data", "model"), (1, 1))
    try:
        DR.check_mesh_torch()
    except RuntimeError:
        with pytest.raises(RuntimeError, match=re.escape(torch.__version__)):
            DR.analyze(cfg, shape, one)
    else:
        assert DR.analyze(cfg, shape, one)["flops"] == pred["flops"]
    got = DR.measure_step(cfg, shape, reps=0)
    assert got["flops"] == pred["flops"] > 0
    want = pred["temp_size_in_bytes"]
    assert abs(got["temp_size_in_bytes"] - want) <= 0.02 * want + 64 * 2**20


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kind,B,S,quant", [
    ("mistral-7b", "decode", 8, 4096, False),
    ("mistral-7b", "decode", 8, 4096, True),
    ("zamba2-1.2b", "train", 2, 512, False),
    ("whisper-base", "prefill", 4, 448, False)])
def test_a_1x1_mesh_is_plain_meta_under_the_cards_torch(arch, kind, B, S,
                                                         quant, monkeypatch):
    """Phase 11a's four cases at full width: under the card's torch,
    ``analyze`` on a 1x1 mesh gives the plain-meta numbers, or, on a torch
    it is not held on, refuses the mesh and names the version."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import MeshSpec
    _need_card()
    monkeypatch.delenv("REPRO_KV_QUANT", raising=False)
    if quant:
        monkeypatch.setenv("REPRO_KV_QUANT", "1")
    cfg, shape = get_config(arch), InputShape(f"{kind}_{S}", S, B, kind)
    one = MeshSpec(("data", "model"), (1, 1))
    try:
        DR.check_mesh_torch()
    except RuntimeError:
        with pytest.raises(RuntimeError, match=re.escape(torch.__version__)):
            DR.analyze(cfg, shape, one)
        return
    plain, mesh = DR.analyze(cfg, shape), DR.analyze(cfg, shape, one)
    for k in ("flops", "bytes_accessed", "peak_bytes", "temp_size_in_bytes",
              "output_size_in_bytes", "argument_size_in_bytes"):
        assert mesh[k] == plain[k], k


# ------------------------------------------------ serve steps as CUDA graphs
GRAPH_ARCHS = ["smollm-360m", "phi3.5-moe-42b-a6.6b", "qwen2-vl-7b",
               "mamba2-130m", "zamba2-1.2b", "whisper-base"]


def _graph_engines(arch, **kw):
    """A reduced ``arch`` (float32, weights from seed 5) behind two engines
    on the card: replayed steps (the default) and eager ones."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(5),
                           torch.float32, "cuda")
    return {g: InferenceEngine(cfg, params, max_len=64, device="cuda",
                               graphs=g, **kw) for g in (True, False)}


def _graph_batch(cfg, B=2, S=9):
    gen = torch.Generator(device="cuda").manual_seed(6)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    if cfg.family in ("vlm", "audio"):
        key = "vision" if cfg.family == "vlm" else "frames"
        n = cfg.num_vision_tokens if key == "vision" else cfg.encoder_seq_len
        batch[key] = torch.randn((B, n, cfg.d_model), generator=gen,
                                 device="cuda")
    return batch


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_decode_replays_match_the_eager_step_on_card(arch):
    """Prefill, then 6 decode steps: the replayed step's logits within 1e-3
    of the eager step's, the same greedy tokens; one capture, then
    replays, each counted as the kernels' launches of one step."""
    _need_card()
    from repro_torch.serving import step_graph as SGR
    eng = _graph_engines(arch)
    batch = _graph_batch(eng[True].cfg)
    logits, caches = {}, {}
    for g, e in eng.items():
        logits[g], caches[g] = e.prefill(batch)
    grown = []
    for _ in range(6):
        tok = logits[False].argmax(-1).to(torch.int32)[:, None]
        for g, e in eng.items():
            before = [fn.launches for fn in SGR.COUNTERS]
            logits[g], caches[g] = e.decode(tok, caches[g])
            torch.cuda.synchronize()
            grown.append((g, [fn.launches - b
                              for fn, b in zip(SGR.COUNTERS, before)]))
        assert (logits[True] - logits[False]).abs().max().item() <= 1e-3
        assert torch.equal(logits[True].argmax(-1), logits[False].argmax(-1))
    runner = eng[True].graphs
    assert (runner.captures, runner.replays) == (1, 5)
    eager = [n for g, n in grown if not g]
    assert all(n == eager[0] for n in eager)
    assert all(n == eager[0] for g, n in grown if g)
    # mamba2's decode step is plain torch (no kernel); the others run K2
    assert (sum(eager[0]) > 0) == (arch != "mamba2-130m")


@pytest.mark.gpu
@pytest.mark.parametrize("kv_quant,impl", [(False, None), (True, "gather"),
                                           (True, "fused")])
@pytest.mark.parametrize("arch", ["smollm-360m", "phi3.5-moe-42b-a6.6b"])
def test_paged_batcher_replays_match_the_eager_steps_on_card(arch, kv_quant,
                                                             impl):
    """The paged batcher on replayed chunk and decode steps gives the eager
    batcher's tokens; with an int8 cache under both read paths (K2 after a
    gather, or K4)."""
    _need_card()
    import numpy as np
    from repro_torch.kernels import autotune as AT
    from repro_torch.serving.batching import PagedContinuousBatcher, Request
    eng = _graph_engines(arch, kv_quant=kv_quant)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, eng[True].cfg.vocab_size, size=m)
               for m in (11, 19, 6)]
    cache = None
    if impl == "fused":
        bucket = AT.shape_bucket("paged_decode_quant", b=2, c=16 * 4)
        cache = AT.AutotuneCache("tests", "cuda", entries=[AT.TunedEntry(
            kernel="paged_decode_quant", backend="cuda", bucket=bucket,
            params={"impl": "fused"}, t_s=1.0, t_default_s=1.0,
            noise_frac=0.0, flops=0.0, bytes=0.0, ctx=0.0)])
    prev = AT.install(cache)
    k4 = DA.paged_decode_attention_int8.launches
    try:
        out = {}
        for g, e in eng.items():
            cb = PagedContinuousBatcher(e, slots=2, num_blocks=24,
                                        block_size=4, chunk=8)
            reqs = [Request(i, p, max_new_tokens=6)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                cb.submit(r)
            cb.run()
            out[g] = [r.out_tokens for r in reqs]
    finally:
        AT.install(prev)
    assert out[True] == out[False]
    assert eng[True].graphs.captures == 2 and eng[True].graphs.replays > 10
    assert (DA.paged_decode_attention_int8.launches > k4) == (impl == "fused")


@pytest.mark.gpu
def test_paged_batcher_row_counts_capture_and_replay_on_card():
    """40 slots: each decode tick replays the step captured at 32 or 40
    rows (``DECODE_ROWS``; both captured at the first decode tick) over its
    decoding lanes, and serves the eager batcher's tokens."""
    _need_card()
    import numpy as np
    from repro_torch.serving.batching import PagedContinuousBatcher, Request
    eng = _graph_engines("smollm-360m")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, eng[True].cfg.vocab_size, size=m)
               for m in (6, 19, 11, 7, 14, 9, 17, 6, 12, 8, 15, 10) * 3]
    out = {}
    for g, e in eng.items():
        cb = PagedContinuousBatcher(e, slots=40, num_blocks=240,
                                    block_size=4, chunk=8)
        assert cb._rows == (32, 40)
        reqs = [Request(i, p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            cb.submit(r)
        cb.run()
        out[g] = [r.out_tokens for r in reqs]
    assert out[True] == out[False]
    assert eng[True].graphs.captures == 3 and eng[True].graphs.replays > 10


@pytest.mark.gpu
def test_a_new_cache_is_a_new_capture_on_card():
    """Two dense batchers on one engine: a capture each (the graph reads
    its cache at its addresses); generate captures per call."""
    _need_card()
    import numpy as np
    from repro_torch.serving.batching import ContinuousBatcher, Request
    eng = _graph_engines("smollm-360m")[True]
    for _ in range(2):
        cb = ContinuousBatcher(eng, slots=2)
        for i, m in enumerate((7, 12)):
            cb.submit(Request(i, np.arange(m) % 50, max_new_tokens=4))
        cb.run()
    assert eng.graphs.captures == 2
    eng.generate(_graph_batch(eng.cfg, B=1), 4)
    assert eng.graphs.captures == 3


@pytest.mark.gpu
def test_generate_captures_again_once_every_graph_died_on_card():
    """An engine that serves only through ``generate`` (the router's
    engine-only path): each call's cache dies after it, its graph with it,
    and the next call captures into a new pool."""
    _need_card()
    import gc
    eng = _graph_engines("smollm-360m")[True]
    batch = _graph_batch(eng.cfg, B=1)
    want = _graph_engines("smollm-360m")[False].generate(batch, 5).tokens
    for _ in range(3):
        assert (eng.generate(batch, 5).tokens == want).all()
        gc.collect()
    assert eng.graphs.captures == 3 and len(eng.graphs) == 1


@pytest.mark.gpu
def test_a_capture_that_reads_the_host_raises_on_card():
    """A step that reads a value on the host cannot be captured: the runner
    raises and does not run it eagerly instead."""
    _need_card()
    from repro_torch.serving import step_graph as SGR

    def host_read(cache, tokens):
        n = int(cache["pos"].sum().item())
        return tokens.float() * n, cache
    cache = {"pos": torch.ones(2, dtype=torch.int32, device="cuda")}
    tok = torch.zeros((2, 1), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError):
        SGR.StepGraphs("cuda").run("host_read", host_read, {"tokens": tok},
                                   cache)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_phase_samples_time_the_kernels_on_card(dtype):
    """``kernel_phase_samples(backend="cuda")``: positive times, and the
    plain run's work counts less what only the plain path does (it
    materializes the float32 scores and computes the full S x S product
    before masking)."""
    _need_card()
    from repro_torch.kernels import timing
    kw = dict(prefill_lens=(128,), decode_ctxs=(128,), paged_ctxs=(64,),
              migrate_blocks=(2,), ssm_lens=(128,), iters=2, dtype=dtype)
    got = timing.kernel_phase_samples(backend="cuda", **kw)
    plain = timing.kernel_phase_samples(backend="ref", **kw)
    hq, dh = 4, 64
    scores = {"flash_attention": lambda s: 4.0 * 3.0 * hq * s.ctx * s.ctx,
              "decode_attention": lambda s: 4.0 * 3.0 * hq * s.ctx,
              "paged_decode_quant": lambda s: 4.0 * 3.0 * hq * s.ctx}
    assert [s.kernel for s in got] == [s.kernel for s in plain]
    for g, r in zip(got, plain):
        assert g.t_s > 0 and g.noise_frac >= 0.0
        flops = r.flops / 2 if g.kernel == "flash_attention" else r.flops
        extra = scores.get(g.kernel, lambda s: 0.0)(r)
        assert (g.flops, g.bytes, g.ctx) == (flops, r.bytes - extra, r.ctx)
    assert got[0].flops == 2.0 * hq * 128 * 128 * dh


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_is_one_pass_bit_for_bit_on_card(dtype):
    """The int8 read's dequantization in one elementwise pass equals the
    float32 product cast to the read's dtype, bit for bit."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    q8 = torch.randint(-127, 128, (4, 8, 96, 128), generator=gen,
                       device="cuda").to(torch.int8)
    sc = torch.rand((4, 8, 96, 1), generator=gen, device="cuda") * 0.02
    got = ref.dequantize_kv(q8, sc, dtype)
    assert got.dtype == dtype
    assert torch.equal(got, (q8.float() * sc).to(dtype))


# --------------------------------------- Nemotron-3-Nano: K5 in groups, K7
@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 300, 2048])
def test_ssd_scan_groups_on_card(S):
    """K5 with B and C in 8 groups of N 128 (Nemotron-3-Nano's 64 heads of
    64; head h reads group h // 8) against the chunked plain version, and
    each group's 8 heads against the ungrouped kernel on that group's B
    and C: the same bits."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(31)
    H, G, N = 64, 8, 128
    x, dt, A, _, _ = _ssd_inputs(gen, 1, H, S, N, torch.bfloat16)
    Bm = _randn(gen, (1, S, G, N), torch.bfloat16)
    Cm = _randn(gen, (1, S, G, N), torch.bfloat16)
    y, fs = SS.ssd_scan(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    want_y, want_fs = SS.ssd_scan_ref(x, dt, A, Bm, Cm)
    tol = SSD_TOL[torch.bfloat16]
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(fs, want_fs, atol=tol, rtol=tol)
    for g in range(G):
        hs = slice(8 * g, 8 * g + 8)
        yg, fg = SS.ssd_scan(x[:, hs].contiguous(), dt[:, hs].contiguous(),
                             A[hs].contiguous(),
                             Bm[:, :, g].contiguous(),
                             Cm[:, :, g].contiguous())
        assert torch.equal(y[:, hs], yg) and torch.equal(fs[:, hs], fg)
    with pytest.raises(ValueError, match="bfloat16"):
        SS.ssd_scan(x.float(), dt, A, Bm.float(), Cm.float())


def _moe_inputs(gen, T, E=128, k=6, d=2688, f=1856, live=None):
    from repro_torch.kernels import moe_experts as ME
    x = _randn(gen, (T, d), torch.bfloat16)
    w_up = (_randn(gen, (E, f, d), torch.float32) * d ** -0.5).bfloat16()
    w_down = (_randn(gen, (E, d, f), torch.float32) * f ** -0.5).bfloat16()
    logits = torch.randn((T, E), generator=gen, device="cuda")
    idx = torch.topk(logits, k, dim=-1).indices
    gate = torch.rand((T, k), generator=gen, device="cuda")
    return x, w_up, w_down, ME.route_table(idx, gate, E, live), idx, gate


@pytest.mark.gpu
@pytest.mark.parametrize("T,n_live", [(64, 8), (64, 64), (7, 7), (300, 300)])
def test_moe_experts_kernel_matches_plain_on_card(T, n_live):
    """K7 against its plain version (expert by expert, bf16) and against a
    float32 per-token sum over the chosen experts, at Nemotron-3-Nano's
    widths; rows of dead lanes stay zero."""
    from repro_torch.kernels import moe_experts as ME
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(32)
    live = torch.zeros(T, dtype=torch.bool, device="cuda")
    live[torch.randperm(T, generator=gen, device="cuda")[:n_live]] = True
    x, w_up, w_down, r, idx, gate = _moe_inputs(gen, T, live=live)
    before = ME.moe_experts.launches
    got = ME.moe_experts(x, w_up, w_down, r)
    torch.cuda.synchronize()
    assert ME.moe_experts.launches == before + 1
    assert int(r.offsets[-1]) == 6 * n_live
    plain = ME.moe_experts_ref(x, w_up, w_down, r)
    scale = plain.abs().max()
    assert float((got - plain).abs().max() / scale) < 2e-2
    dead = ~live.repeat_interleave(6)
    assert bool((got[dead] == 0).all())
    # float32, token by token
    xf, uf, df = x.float(), w_up.float(), w_down.float()
    for t in torch.nonzero(live)[:4, 0].tolist():
        for j in range(6):
            e = int(idx[t, j])
            h = torch.relu(uf[e] @ xf[t]).square()
            want = gate[t, j] * (df[e] @ h)
            err = (got[t * 6 + j] - want).abs().max() / want.abs().max()
            assert float(err) < 2e-2, (t, j, float(err))


@pytest.mark.gpu
def test_moe_experts_captures_into_a_cuda_graph():
    """K7 reads its routing on the device: one capture serves another
    routing, dead lanes included, and a replay counts one launch."""
    from repro_torch.kernels import moe_experts as ME
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(33)
    T, E = 64, 128
    live = torch.ones(T, dtype=torch.bool, device="cuda")
    x, w_up, w_down, r, idx, gate = _moe_inputs(gen, T, live=live)
    ME.moe_experts(x, w_up, w_down, r)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        rr = ME.route_table(idx, gate, E, live)
        y = ME.moe_experts(x, w_up, w_down, rr)
    live.copy_(torch.arange(T, device="cuda") % 5 == 0)
    idx.copy_(torch.topk(torch.randn((T, E), generator=gen, device="cuda"),
                         6, dim=-1).indices)
    g.replay()
    torch.cuda.synchronize()
    want = ME.moe_experts_ref(x, w_up, w_down,
                              ME.route_table(idx, gate, E, live))
    assert float((y - want).abs().max() / want.abs().max()) < 2e-2
    assert int(rr.offsets[-1]) == 6 * int(live.sum())


@pytest.mark.gpu
def test_moe_experts_wrapper_refuses():
    from repro_torch.kernels import moe_experts as ME
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(34)
    x, w_up, w_down, r, _, _ = _moe_inputs(gen, 4, E=4, k=2, d=128, f=64)
    with pytest.raises(ValueError, match="bfloat16"):
        ME.moe_experts(x.float(), w_up, w_down, r)
    with pytest.raises(ValueError, match="multiples"):
        ME.moe_experts(x[:, :96].contiguous(), w_up[:, :, :96].contiguous(),
                       w_down[:, :96].contiguous(), r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_at_sixteen_query_heads_a_kv_head_on_card(dtype):
    """K1 and K2 at Nemotron-3-Nano's GQA: 32 query heads on 2 KV heads
    (G = 16), D 128, no positional encoding (the model applies none)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(35)
    tol = TOL[dtype]
    q = _randn(gen, (1, 32, 300, 128), dtype)
    k = _randn(gen, (1, 2, 300, 128), dtype)
    v = _randn(gen, (1, 2, 300, 128), dtype)
    torch.testing.assert_close(FA.flash_attention(q, k, v),
                               FA.flash_attention_ref(q, k, v),
                               atol=tol, rtol=tol)
    kc = _randn(gen, (4, 2, 640, 128), dtype)
    vc = _randn(gen, (4, 2, 640, 128), dtype)
    q1 = _randn(gen, (4, 32, 1, 128), dtype)
    kv = torch.tensor([1, 33, 300, 640], dtype=torch.int32, device="cuda")
    torch.testing.assert_close(DA.decode_attention(q1, kc, vc, kv),
                               DA.decode_attention_ref(q1, kc, vc, kv),
                               atol=tol, rtol=tol)


# Nemotron-H's block layout at widths the card's kernels take (K1 at D 64,
# K5 at P 64 / N 128 in two groups, K7 at d 256, f 128)
NANO_CARD = {"family": "hybrid", "num_layers": 6, "d_model": 256,
             "num_heads": 4, "num_kv_heads": 2, "head_dim": 64, "d_ff": 128,
             "vocab_size": 512, "pos_emb": "none", "activation": "relu2",
             "norm": "rmsnorm", "tie_embeddings": False,
             "block_pattern": "MEM*EM",
             "ssm": {"state_dim": 128, "head_dim": 64, "expand": 2,
                     "chunk_size": 128, "conv_width": 4, "n_groups": 2,
                     "num_heads": 8},
             "moe": {"num_experts": 16, "num_experts_per_tok": 6,
                     "router": "sigmoid", "score_bias": True,
                     "norm_topk_prob": True, "routed_scale": 2.5,
                     "shared_expert_dim": 256}}


@pytest.mark.gpu
def test_padded_prefill_captures_and_replays_on_card():
    """A block_pattern model's padded prefill captured as a CUDA graph: the
    capture and a replay on another prompt each give the logits and states
    of the eager prefill at the prompt's own length, and a replay counts
    the kernels its capture ran (K5 three times, K7 twice)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.kernels import moe_experts as ME
    from repro_torch.serving.engine import InferenceEngine
    _need_card()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from serve_bench.reference import nemotron_h as REF
    gen = torch.Generator(device="cuda").manual_seed(36)
    w = REF.make_weights(NANO_CARD, gen, torch.bfloat16, "cuda")
    eng = InferenceEngine(ModelConfig(name="nano-card", **NANO_CARD), w,
                          max_len=256, dtype=torch.bfloat16, device="cuda")
    lane = eng.new_cache(1)
    for i, m in enumerate((40, 5, 64)):
        toks = torch.randint(0, 512, (1, m), generator=gen, device="cuda",
                             dtype=torch.int32)
        want, exact = eng.prefill({"tokens": toks}, eng.new_cache(1))
        padded = torch.zeros((1, 64), dtype=torch.int32, device="cuda")
        padded[:, :m] = toks
        before = (SS.ssd_scan.launches, ME.moe_experts.launches)
        got, _ = eng.prefill({"tokens": padded, "n_valid": m}, lane)
        torch.cuda.synchronize()
        assert eng.graphs.captures == 1 and eng.graphs.replays == i
        assert (SS.ssd_scan.launches - before[0],
                ME.moe_experts.launches - before[1]) == (3, 2)
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) < 2e-2 * scale, m
        for k, tol in (("ssm", 5e-2), ("conv", 2e-2)):
            err = (lane[k].float() - exact[k].float()).abs().max()
            assert float(err) <= tol * float(exact[k].abs().max()), (m, k)
        assert int(lane["pos"][0]) == m

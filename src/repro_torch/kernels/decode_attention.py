"""K2, K3 and K4: one query token against a dense, a paged or an int8 paged
KV cache — the Hopper kernels' wrappers and their plain versions.

K2 replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py::
decode_attention`` (body ``_decode_kernel``); K3 replaces
``paged_decode_attention`` (body ``_paged_decode_kernel``); K4 replaces
``paged_decode_attention_int8`` (body ``_paged_decode_int8_kernel``). All
three are ``csrc/decode_attention.cu``: the KV axis is cut into splits of
``block_k`` keys, one kernel walks a work list of the live (lane, KV head,
split) items that it builds on the device from ``kv_len``, on a grid fixed
from the card's SM count and the kernel's occupancy, and a second launch
merges each lane's live splits' float32 partials (two device kernels per
call, one count). Any batch B: the kernel lists the lanes 128 at a time.
The three differ only in where a key row lives (a dense slab, or a pool
block found through the block table) and in what it holds (float or bf16
values, or int8 values with a float32 scale, converted in registers). Its
header note says what bounds them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import DTYPE_CODES, check_inputs

SPLIT_KS = (32, 64, 128)   # K3's and K4's keys per split; any pool block size


def num_splits(smax: int, block_k: int) -> int:
    """K2's, K3's and K4's KV splits, the workspace's third axis: fixed from
    the cache's extent (Smax, or block_size * max_blocks), never from
    kv_len, so a call needs no host sync and captures into a CUDA graph.
    Only a lane's live splits are computed and written."""
    return max(1, -(-smax // block_k))


def decode_attention_ref(q, k_cache, v_cache, kv_len, *,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """The plain version of K2."""
    return _ref.decode_attention(q, k_cache, v_cache, kv_len=kv_len,
                                 window=window, softcap=softcap)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, kv_len, *,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None) -> torch.Tensor:
    """The plain version of K3."""
    return _ref.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                       kv_len=kv_len, window=window,
                                       softcap=softcap)


def paged_decode_attention_int8_ref(q, k_pool, v_pool, k_scale_pool,
                                    v_scale_pool, block_tables, kv_len, *,
                                    window: Optional[int] = None,
                                    softcap: Optional[float] = None
                                    ) -> torch.Tensor:
    """The plain version of K4: the scale-folded int8 read."""
    return _ref.paged_decode_attention_quant_fused(
        q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables,
        kv_len=kv_len, window=window, softcap=softcap)


def _check_common(name, q, kv_len, window, softcap, block_k) -> None:
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"{name}: q must be (B, Hq, 1, D), got {tuple(q.shape)}")
    if kv_len.dtype != torch.int32 or kv_len.shape != (q.shape[0],) \
            or kv_len.device != q.device or not kv_len.is_contiguous():
        raise ValueError(f"{name}: kv_len must be a contiguous ({q.shape[0]},) "
                         f"int32 tensor on {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"{name}: softcap must be > 0, got {softcap}")
    if block_k % 32 or not 32 <= block_k <= 128:
        raise ValueError(f"{name}: block_k {block_k} not a multiple of 32 "
                         f"in [32, 128]")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     block_k: int = 64, lib=None) -> torch.Tensor:
    """K2. q: (B, Hq, 1, D); caches (B, Hkv, Smax, D); kv_len (B,) int32,
    the new token's K/V already written at kv_len-1. Returns (B, Hq, 1, D).
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``block_k`` keys per split; the float32 workspace of the
    splits' partials, (B, Hq, splits, D + 2), is allocated here. ``lib``: a
    kernel library to launch from (``_build.bind``; default the port's own),
    such as another checkout's, timed on the same call."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, kv_len,
                                    window=window, softcap=softcap)
    check_inputs("decode_attention", q, k_cache, v_cache)
    _check_common("decode_attention", q, kv_len, window, softcap, block_k)
    B, Hq, _, D = q.shape
    Bc, Hkv, Smax, Dc = k_cache.shape
    if v_cache.shape != k_cache.shape or Bc != B or Dc != D or Hq % Hkv:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, "
                         f"cache {tuple(k_cache.shape)}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ws = torch.empty((B, Hq, num_splits(Smax, block_k), D + 2),
                     dtype=torch.float32, device=q.device)
    code = (lib or _build.library()).repro_decode_attention(
        DTYPE_CODES[q.dtype], D, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), kv_len.data_ptr(), ws.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, Smax, window or 0, float(softcap or 0.0),
        float(D ** -0.5), block_k,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "decode_attention")
    decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           block_k: int = 64, lib=None) -> torch.Tensor:
    """K3. q: (B, Hq, 1, D); pools (num_blocks, Hkv, block_size, D);
    block_tables (B, max_blocks) int32 whose every entry is a valid pool
    index (dead entries point at the null block 0); kv_len (B,) int32.
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``block_k`` keys per split, one of ``SPLIT_KS``; the float32
    workspace of the splits' partials, (B, Hq, splits, D + 2) with splits =
    ceil(block_size * max_blocks / block_k), is allocated here. ``lib`` as
    K2's."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                          kv_len, window=window,
                                          softcap=softcap)
    check_inputs("paged_decode_attention", q, k_pool, v_pool)
    _check_common("paged_decode_attention", q, kv_len, window, softcap,
                  block_k)
    _check_split("paged_decode_attention", block_k)
    B, Hq, _, D = q.shape
    _, Hkv, bs, Dp = k_pool.shape
    if v_pool.shape != k_pool.shape or Dp != D or Hq % Hkv:
        raise ValueError(f"paged_decode_attention: shapes q {tuple(q.shape)}, "
                         f"pool {tuple(k_pool.shape)}")
    _check_tables("paged_decode_attention", block_tables, B, q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    max_blocks = block_tables.shape[1]
    ws = _paged_workspace(q, bs * max_blocks, block_k)
    code = (lib or _build.library()).repro_paged_decode_attention(
        DTYPE_CODES[q.dtype], D, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_tables.data_ptr(), kv_len.data_ptr(),
        ws.data_ptr(), out.data_ptr(), B, Hq, Hkv, bs, max_blocks,
        window or 0, float(softcap or 0.0), float(D ** -0.5), block_k,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


def _check_split(name, block_k) -> None:
    if block_k not in SPLIT_KS:
        raise ValueError(f"{name}: block_k {block_k} not in {SPLIT_KS}")


def _paged_workspace(q, limit, block_k) -> torch.Tensor:
    """The float32 partials (B, Hq, splits, D + 2) of a paged call, splits =
    ceil(block_size * max_blocks / block_k)."""
    B, Hq, _, D = q.shape
    return torch.empty((B, Hq, num_splits(limit, block_k), D + 2),
                       dtype=torch.float32, device=q.device)


def _check_tables(name, block_tables, B, device) -> None:
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != B or block_tables.device != device \
            or not block_tables.is_contiguous():
        raise ValueError(f"{name}: block_tables must be a contiguous "
                         f"({B}, max_blocks) int32 tensor on {device}")


def _check_int8_pools(q, k_pool, v_pool, k_scale_pool, v_scale_pool) -> None:
    """What K4 takes: q float32 or bfloat16, head dim 64 or 128; int8
    pools (num_blocks, Hkv, block_size, D) and float32 scale pools
    (num_blocks, Hkv, block_size, 1), all contiguous, 16-byte aligned, on
    q's device."""
    name = "paged_decode_attention_int8"
    check_inputs(name, q)
    for t, what in ((k_pool, "k_pool"), (v_pool, "v_pool")):
        if t.dtype != torch.int8:
            raise ValueError(f"{name}: {what} must be int8, got {t.dtype}")
    for t, what in ((k_scale_pool, "k_scale_pool"),
                    (v_scale_pool, "v_scale_pool")):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be float32, got {t.dtype}")
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape \
            or k_pool.shape[3] != q.shape[3] or q.shape[1] % k_pool.shape[1]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    want = (*k_pool.shape[:3], 1)
    for t, what in ((k_scale_pool, "k_scale_pool"),
                    (v_scale_pool, "v_scale_pool")):
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {what} must be {want}, got "
                             f"{tuple(t.shape)}")
    for t in (k_pool, v_pool, k_scale_pool, v_scale_pool):
        if t.device != q.device:
            raise ValueError(f"{name}: all inputs must be on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: pools must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: pools must be 16-byte aligned")


def paged_decode_attention_int8(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                k_scale_pool: torch.Tensor,
                                v_scale_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                kv_len: torch.Tensor, *,
                                window: Optional[int] = None,
                                softcap: Optional[float] = None,
                                block_k: int = 64,
                                lib=None) -> torch.Tensor:
    """K4. q: (B, Hq, 1, D) float32 or bfloat16; k/v pools (num_blocks,
    Hkv, block_size, D) int8; k/v scale pools (num_blocks, Hkv, block_size,
    1) float32; block_tables (B, max_blocks) int32, every entry a valid pool
    index; kv_len (B,) int32. Returns (B, Hq, 1, D) in q's dtype. CUDA
    tensors launch the kernel (or raise); CPU tensors take the plain
    version. ``block_k`` keys per split, one of ``SPLIT_KS``; the float32
    workspace is K3's, allocated here. ``lib`` as K2's."""
    if q.device.type == "cpu":
        return paged_decode_attention_int8_ref(
            q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables,
            kv_len, window=window, softcap=softcap)
    _check_int8_pools(q, k_pool, v_pool, k_scale_pool, v_scale_pool)
    _check_common("paged_decode_attention_int8", q, kv_len, window, softcap,
                  block_k)
    _check_split("paged_decode_attention_int8", block_k)
    B, Hq, _, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    _check_tables("paged_decode_attention_int8", block_tables, B, q.device)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    max_blocks = block_tables.shape[1]
    ws = _paged_workspace(q, bs * max_blocks, block_k)
    code = (lib or _build.library()).repro_paged_decode_attention_int8(
        DTYPE_CODES[q.dtype], D, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), k_scale_pool.data_ptr(), v_scale_pool.data_ptr(),
        block_tables.data_ptr(), kv_len.data_ptr(), ws.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, bs, max_blocks, window or 0,
        float(softcap or 0.0), float(D ** -0.5), block_k,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "paged_decode_attention_int8")
    paged_decode_attention_int8.launches += 1
    return out


decode_attention.launches = 0
paged_decode_attention.launches = 0
paged_decode_attention_int8.launches = 0

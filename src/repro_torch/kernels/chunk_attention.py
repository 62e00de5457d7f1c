"""K6: one lane's prefill chunk attending over its paged KV cache — the
Hopper kernel's wrapper and its plain version.

Replaces no Pallas kernel: the JAX package runs chunked prefill's attention
on its plain path (``ref.gather_paged_kv`` of the lane's whole table, then
``ref.mha_attention``), and so did this port until that float32 path over
every row a lane could hold bounded chat's device time. The CUDA source is
``csrc/chunk_attention.cu``: bfloat16 runs K1 v3's wgmma products and online
softmax, float32 K1 v4's FMA micro-tiles, both fed through the block table
by cp.async. Its header note says what bounds it.

``q_offset`` and ``kv_len`` are device tensors and the kernel reads them
there, so a CUDA graph captured once per chunk shape serves every lane and
valid count. Rows past n_valid = kv_len - q_offset come back as zeros, in
the kernel and in the plain version: nothing reads them (their K/V writes
already went to the null block, and only the last valid row's logits are
used).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import DTYPE_CODES, check_inputs


def paged_chunk_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, table: torch.Tensor,
                              kv_len: torch.Tensor, q_offset: torch.Tensor,
                              *,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None
                              ) -> torch.Tensor:
    """The plain version of K6: the path it replaced (the lane's whole table
    gathered, then ``ref.mha_attention`` in float32, causal at ``q_offset``
    and masked at ``kv_len``), with rows at or past kv_len set to 0."""
    out = ref.mha_attention(q, ref.gather_paged_kv(k_pool, table[None]),
                            ref.gather_paged_kv(v_pool, table[None]),
                            causal=True, window=window, softcap=softcap,
                            q_offset=q_offset, kv_len=kv_len)
    qpos = q_offset + torch.arange(q.shape[2], device=q.device)
    return torch.where((qpos < kv_len)[None, None, :, None], out, 0.0)


def _check(q, k_pool, v_pool, table, kv_len, q_offset, window, softcap):
    name = "paged_chunk_attention"
    check_inputs(name, q, k_pool, v_pool)
    if q.dim() != 4 or q.shape[0] != 1 or k_pool.dim() != 4 \
            or v_pool.shape != k_pool.shape or k_pool.shape[3] != q.shape[3] \
            or q.shape[1] % k_pool.shape[1]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} (one lane), "
                         f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)}")
    for t, what, dims in ((table, "table", 1), (kv_len, "kv_len", 1),
                          (q_offset, "q_offset", 0)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
                or t.dim() != dims or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous {dims}-d "
                             f"int32 tensor on {q.device}")
    if kv_len.numel() != 1 or table.numel() < 1:
        raise ValueError(f"{name}: kv_len must be (1,) and table "
                         f"(max_blocks,), got {tuple(kv_len.shape)} and "
                         f"{tuple(table.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"{name}: softcap must be > 0, got {softcap}")


def paged_chunk_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, table: torch.Tensor,
                          kv_len: torch.Tensor, q_offset: torch.Tensor, *,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """K6. q: (1, Hq, C, D), the chunk's queries from absolute position
    ``q_offset`` (0-d int32); pools (num_blocks, Hkv, block_size, D), the
    chunk's own K/V already written; table (max_blocks,) int32, every entry
    a valid pool index (dead ones the null block); kv_len (1,) int32, the
    valid keys including the chunk's. Returns (1, Hq, C, D), rows past
    kv_len - q_offset zero. CUDA tensors launch the kernel (or raise); CPU
    tensors take the plain version."""
    if q.device.type == "cpu":
        return paged_chunk_attention_ref(q, k_pool, v_pool, table, kv_len,
                                         q_offset, window=window,
                                         softcap=softcap)
    _check(q, k_pool, v_pool, table, kv_len, q_offset, window, softcap)
    _, Hq, C, D = q.shape
    _, Hkv, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    code = _build.library().repro_paged_chunk_attention(
        DTYPE_CODES[q.dtype], D, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), table.data_ptr(), kv_len.data_ptr(),
        q_offset.data_ptr(), out.data_ptr(), Hq, Hkv, C, bs, table.shape[0],
        window or 0, float(softcap or 0.0), float(D ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "paged_chunk_attention")
    paged_chunk_attention.launches += 1
    return out


paged_chunk_attention.launches = 0

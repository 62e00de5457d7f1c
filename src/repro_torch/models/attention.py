"""Attention for the dense family and the hybrid's shared block: GQA with
RoPE, KV-cache prefill and decode on a dense or a paged cache (counterpart of
``repro/models/attention.py``; the int8 KV branches wait for ROADMAP Queue 1
item 6).

The reference package returns new caches; here cache writes are in place
(indexed assignment into the given tensors), which saves a copy of the whole
cache per step. Every such write is marked "in place".
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    hd = cfg.resolved_head_dim
    bias = cfg.qkv_bias
    return {
        "q": L.dense_init(gen, cfg.d_model, cfg.num_heads * hd, dtype, device,
                          bias=bias),
        "k": L.dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                          device, bias=bias),
        "v": L.dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dtype,
                          device, bias=bias),
        "o": L.dense_init(gen, cfg.num_heads * hd, cfg.d_model, dtype, device),
    }


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n_heads, hd).transpose(1, 2)    # (B, H, S, D)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def _qkv(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Projections, heads split, RoPE on q and k; contiguous (B, H, S, D),
    the layout the kernels take."""
    hd = cfg.resolved_head_dim
    q = _split_heads(L.linear(params["q"], x), cfg.num_heads, hd)
    k = _split_heads(L.linear(params["k"], x), cfg.num_kv_heads, hd)
    v = _split_heads(L.linear(params["v"], x), cfg.num_kv_heads, hd)
    if cfg.pos_emb == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos_emb != "none":
        raise NotImplementedError(f"pos_emb {cfg.pos_emb!r} is not ported")
    return q.contiguous(), k.contiguous(), v.contiguous()


def prefill_attention(params, cfg: ModelConfig, x: torch.Tensor, *,
                      positions: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, window: Optional[int] = None,
                      backend: str = "auto") -> torch.Tensor:
    """Self attention over the prompt that also writes its K/V into the
    cache. x: (B, S, d); k_cache/v_cache: (B, Hkv, Smax, D), Smax >= S,
    written in place. Returns the attention output (B, S, d)."""
    q, k, v = _qkv(params, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_logit_softcap, backend=backend)
    S = x.shape[1]
    k_cache[:, :, :S] = k.to(k_cache.dtype)                 # in place
    v_cache[:, :, :S] = v.to(v_cache.dtype)                 # in place
    return L.linear(params["o"], _merge_heads(out))


def decode_self_attention(params, cfg: ModelConfig, x: torch.Tensor, *,
                          positions: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kv_len: torch.Tensor,
                          window: Optional[int] = None,
                          backend: str = "auto") -> torch.Tensor:
    """One-token decode. x: (B, 1, d); kv_len (B,) int32: length INCLUDING
    this token. The new K/V row is written in place at kv_len-1 (clamped to
    the cache, as the reference's dynamic_update_slice clamps), then decode
    attention runs over the cache."""
    q, k, v = _qkv(params, cfg, x, positions)
    B, Smax = x.shape[0], k_cache.shape[2]
    lanes = torch.arange(B, device=x.device)
    idx = (kv_len - 1).clamp(0, Smax - 1).long()
    k_cache[lanes, :, idx] = k[:, :, 0].to(k_cache.dtype)   # in place
    v_cache[lanes, :, idx] = v[:, :, 0].to(v_cache.dtype)   # in place
    out = ops.decode_attention(q, k_cache, v_cache, kv_len, window=window,
                               softcap=cfg.attn_logit_softcap, backend=backend)
    return L.linear(params["o"], _merge_heads(out))


def paged_prefill_chunk_attention(params, cfg: ModelConfig, x: torch.Tensor,
                                  *, positions: torch.Tensor,
                                  k_pool: torch.Tensor, v_pool: torch.Tensor,
                                  table: torch.Tensor, block_ids: torch.Tensor,
                                  rows: torch.Tensor, kv_len: torch.Tensor,
                                  q_offset: torch.Tensor,
                                  window: Optional[int] = None,
                                  backend: str = "auto") -> torch.Tensor:
    """Chunked-prefill self attention for ONE lane of a paged cache.

    x: (1, C, d), the lane's next C prompt tokens (rows past the valid count
    are padding; their writes are already redirected to the null block by
    ``block_ids``). The chunk's K/V rows go into the pools in place at
    (block_ids, rows); then the chunk's queries attend over the lane's
    gathered blocks, causal at absolute offset ``q_offset`` (0-d tensor)
    and masked at ``kv_len`` (shape (1,)).
    """
    q, k, v = _qkv(params, cfg, x, positions)
    k_pool[block_ids, :, rows] = k[0].transpose(0, 1).to(k_pool.dtype)  # in place
    v_pool[block_ids, :, rows] = v[0].transpose(0, 1).to(v_pool.dtype)  # in place
    k_read = ref.gather_paged_kv(k_pool, table[None])
    v_read = ref.gather_paged_kv(v_pool, table[None])
    # chunk attention runs on the masked plain path, as in the reference: it
    # needs both a device-side q_offset and kv_len masking, which the flash
    # prefill kernel does not take; chunks are short, so the O(C * ctx)
    # dense scores are cheap
    out = ref.mha_attention(q, k_read, v_read, causal=True, window=window,
                            softcap=cfg.attn_logit_softcap, q_offset=q_offset,
                            kv_len=kv_len)
    return L.linear(params["o"], _merge_heads(out))


def paged_decode_self_attention(params, cfg: ModelConfig, x: torch.Tensor, *,
                                positions: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                block_ids: torch.Tensor, rows: torch.Tensor,
                                kv_len: torch.Tensor,
                                window: Optional[int] = None,
                                backend: str = "auto") -> torch.Tensor:
    """One-token decode over a paged cache, batched across lanes.

    x: (B, 1, d); pools (num_blocks, Hkv, block_size, D); block_tables
    (B, max_blocks) int32; block_ids/rows (B,) write targets (non-live lanes
    already redirected to the null block); kv_len (B,) int32 INCLUDING this
    token. The new rows are written in place."""
    q, k, v = _qkv(params, cfg, x, positions)
    k_pool[block_ids, :, rows] = k[:, :, 0].to(k_pool.dtype)  # in place
    v_pool[block_ids, :, rows] = v[:, :, 0].to(v_pool.dtype)  # in place
    out = ops.paged_decode_attention(q, k_pool, v_pool, block_tables, kv_len,
                                     window=window,
                                     softcap=cfg.attn_logit_softcap,
                                     backend=backend)
    return L.linear(params["o"], _merge_heads(out))

"""Attention: GQA/MQA/MHA with RoPE or M-RoPE, causal or bidirectional,
sliding window, KV-cache prefill and decode on a dense or a paged cache,
float or int8 with per-row float32 scales, and cross-attention over an
encoder's K/V (counterpart of ``repro/models/attention.py``).

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

MROPE_SECTIONS_FRAC = (0.25, 0.375, 0.375)  # qwen2-vl [16, 24, 24] of 64 half-dims


def attn_init(gen: torch.Generator, cfg: ModelConfig, dtype, device, *,
              cross: bool = False):
    """q/k/v/o projections; a cross-attention block (``cross``) has the same
    leaves, its k/v applied to the encoder's output."""
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


def quantize_kv(x: torch.Tensor, axis: int = -1):
    """Symmetric per-row int8 quantization, bit for bit the reference's:
    x (..., D) -> (int8, scale (..., 1) float32). ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


dequantize_kv = ref.dequantize_kv      # (int8, scale) -> dtype, as the reference


def _write_int8(k_cache, v_cache, k_scale, v_scale, at, k, v) -> None:
    """Quantize k and v per row and write them and their scales at index
    ``at`` of the int8 caches and scale tensors (in place)."""
    for cache, scale, x in ((k_cache, k_scale, k), (v_cache, v_scale, v)):
        xq, xs = quantize_kv(x)
        cache[at] = xq                                      # in place
        scale[at] = xs                                      # in place


def _mrope_sections(head_dim: int):
    half = head_dim // 2
    s0 = int(half * MROPE_SECTIONS_FRAC[0])
    s1 = int(half * MROPE_SECTIONS_FRAC[1])
    return (s0, s1, half - s0 - s1)


def _position_encode(cfg: ModelConfig, q, k, positions):
    """RoPE on positions (B, S), or M-RoPE on positions (B, S, 3); "learned"
    and "none" are handled at the embedding."""
    if cfg.pos_emb == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    elif cfg.pos_emb == "mrope":
        sec = _mrope_sections(cfg.resolved_head_dim)
        q = L.apply_mrope(q, positions, cfg.rope_theta, sec)
        k = L.apply_mrope(k, positions, cfg.rope_theta, sec)
    return q, k


def _qkv(params, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor):
    """Projections, heads split, position encoding on q and k; contiguous
    (B, H, S, D), the layout the kernels take."""
    hd = cfg.resolved_head_dim
    q = _split_heads(L.linear(params["q"], x), cfg.num_heads, hd)
    k = _split_heads(L.linear(params["k"], x), cfg.num_kv_heads, hd)
    v = _split_heads(L.linear(params["v"], x), cfg.num_kv_heads, hd)
    q, k = _position_encode(cfg, q, k, positions)
    return q.contiguous(), k.contiguous(), v.contiguous()


def self_attention(params, cfg: ModelConfig, x: torch.Tensor, *,
                   positions: torch.Tensor, causal: bool = True,
                   window: Optional[int] = None,
                   backend: str = "auto") -> torch.Tensor:
    """Full-sequence self attention with no cache (the audio encoder's,
    bidirectional). positions: (B, S) or (B, S, 3)."""
    q, k, v = _qkv(params, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cfg.attn_logit_softcap, backend=backend)
    return L.linear(params["o"], _merge_heads(out))


def prefill_attention(params, cfg: ModelConfig, x: torch.Tensor, *,
                      positions: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, window: Optional[int] = None,
                      backend: str = "auto",
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self attention over the prompt that also writes its K/V into the
    cache. x: (B, S, d); k_cache/v_cache: (B, Hkv, Smax, D), Smax >= S,
    written in place; int8 caches (k_scale/v_scale (B, Hkv, Smax, 1) given)
    are written quantized per row. Attention runs on the fresh K/V. Returns
    the attention output (B, S, d)."""
    q, k, v = _qkv(params, cfg, x, positions)
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_logit_softcap, backend=backend)
    S = x.shape[1]
    if k_scale is not None:
        _write_int8(k_cache, v_cache, k_scale, v_scale,
                    (slice(None), slice(None), slice(None, S)), k, v)
    else:
        k_cache[:, :, :S] = k.to(k_cache.dtype)             # in place
        v_cache[:, :, :S] = v.to(v_cache.dtype)             # in place
    return L.linear(params["o"], _merge_heads(out))


def decode_self_attention(params, cfg: ModelConfig, x: torch.Tensor, *,
                          positions: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kv_len: torch.Tensor,
                          window: Optional[int] = None,
                          backend: str = "auto",
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """One-token decode. x: (B, 1, d); kv_len (B,) int32: length INCLUDING
    this token. The new K/V row is written in place at kv_len-1 (clamped to
    the cache, as the reference's dynamic_update_slice clamps), then decode
    attention runs over the cache. int8 caches (k_scale/v_scale given)
    quantize the new row and are dequantized to q's dtype for the read, as
    in the reference."""
    q, k, v = _qkv(params, cfg, x, positions)
    B, Smax = x.shape[0], k_cache.shape[2]
    lanes = torch.arange(B, device=x.device)
    idx = (kv_len - 1).clamp(0, Smax - 1).long()
    if k_scale is not None:
        _write_int8(k_cache, v_cache, k_scale, v_scale,
                    (lanes, slice(None), idx), k[:, :, 0], v[:, :, 0])
        k_read = dequantize_kv(k_cache, k_scale, q.dtype)
        v_read = dequantize_kv(v_cache, v_scale, q.dtype)
    else:
        k_cache[lanes, :, idx] = k[:, :, 0].to(k_cache.dtype)   # in place
        v_cache[lanes, :, idx] = v[:, :, 0].to(v_cache.dtype)   # in place
        k_read, v_read = k_cache, v_cache
    out = ops.decode_attention(q, k_read, v_read, kv_len, window=window,
                               softcap=cfg.attn_logit_softcap, backend=backend)
    return L.linear(params["o"], _merge_heads(out))


def paged_prefill_chunk_attention(params, cfg: ModelConfig, x: torch.Tensor,
                                  *, positions: torch.Tensor,
                                  k_pool: torch.Tensor, v_pool: torch.Tensor,
                                  table: torch.Tensor, block_ids: torch.Tensor,
                                  rows: torch.Tensor, kv_len: torch.Tensor,
                                  q_offset: torch.Tensor,
                                  window: Optional[int] = None,
                                  backend: str = "auto",
                                  k_scale_pool: Optional[torch.Tensor] = None,
                                  v_scale_pool: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Chunked-prefill self attention for ONE lane of a paged cache.

    x: (1, C, d), the lane's next C prompt tokens (rows past the valid count
    are padding; their writes are already redirected to the null block by
    ``block_ids``). The chunk's K/V rows go into the pools in place at
    (block_ids, rows); then the chunk's queries attend over the lane's
    gathered blocks, causal at absolute offset ``q_offset`` (0-d tensor)
    and masked at ``kv_len`` (shape (1,)). int8 pools (scale pools given)
    are written quantized per row and read gathered and dequantized to q's
    dtype, as in the reference.
    """
    q, k, v = _qkv(params, cfg, x, positions)
    krows = k[0].transpose(0, 1)                             # (C, Hkv, D)
    vrows = v[0].transpose(0, 1)
    if k_scale_pool is not None:
        _write_int8(k_pool, v_pool, k_scale_pool, v_scale_pool,
                    (block_ids, slice(None), rows), krows, vrows)
        tab = table[None]
        k_read = dequantize_kv(ref.gather_paged_kv(k_pool, tab),
                               ref.gather_paged_kv(k_scale_pool, tab), q.dtype)
        v_read = dequantize_kv(ref.gather_paged_kv(v_pool, tab),
                               ref.gather_paged_kv(v_scale_pool, tab), q.dtype)
    else:
        k_pool[block_ids, :, rows] = krows.to(k_pool.dtype)  # in place
        v_pool[block_ids, :, rows] = vrows.to(v_pool.dtype)  # in place
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
                                backend: str = "auto",
                                k_scale_pool: Optional[torch.Tensor] = None,
                                v_scale_pool: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """One-token decode over a paged cache, batched across lanes.

    x: (B, 1, d); pools (num_blocks, Hkv, block_size, D); block_tables
    (B, max_blocks) int32; block_ids/rows (B,) write targets (non-live lanes
    already redirected to the null block); kv_len (B,) int32 INCLUDING this
    token. The new rows are written in place. int8 pools (scale pools
    (num_blocks, Hkv, block_size, 1) given) are read by
    ``ops.paged_decode_attention_quant``, whose read path (gather then K2,
    or K4) comes from the installed autotune cache, else gather."""
    q, k, v = _qkv(params, cfg, x, positions)
    if k_scale_pool is not None:
        _write_int8(k_pool, v_pool, k_scale_pool, v_scale_pool,
                    (block_ids, slice(None), rows), k[:, :, 0], v[:, :, 0])
        out = ops.paged_decode_attention_quant(
            q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables,
            kv_len, window=window, softcap=cfg.attn_logit_softcap,
            backend=backend)
    else:
        k_pool[block_ids, :, rows] = k[:, :, 0].to(k_pool.dtype)  # in place
        v_pool[block_ids, :, rows] = v[:, :, 0].to(v_pool.dtype)  # in place
        out = ops.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                         kv_len, window=window,
                                         softcap=cfg.attn_logit_softcap,
                                         backend=backend)
    return L.linear(params["o"], _merge_heads(out))


def cross_attention(params, cfg: ModelConfig, x: torch.Tensor, *,
                    enc_k: torch.Tensor, enc_v: torch.Tensor,
                    backend: str = "auto") -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V (B, Hkv, S_enc,
    D). A prompt (S > 1) runs the non-causal flash prefill (K1 on the card);
    a one-token decode is a (1, S_enc) score row per head, on the plain path
    on every device, as in the reference."""
    hd = cfg.resolved_head_dim
    q = _split_heads(L.linear(params["q"], x), cfg.num_heads, hd)
    if x.shape[1] == 1:
        out = ref.mha_attention(q, enc_k, enc_v, causal=False)
    else:
        out = ops.flash_attention(q.contiguous(), enc_k.contiguous(),
                                  enc_v.contiguous(), causal=False,
                                  backend=backend)
    return L.linear(params["o"], _merge_heads(out))


def encode_kv(params, cfg: ModelConfig, enc_out: torch.Tensor):
    """Cross-attention K/V (B, Hkv, S_enc, D) from the encoder's output,
    computed once per request."""
    hd = cfg.resolved_head_dim
    k = _split_heads(L.linear(params["k"], enc_out), cfg.num_kv_heads, hd)
    v = _split_heads(L.linear(params["v"], enc_out), cfg.num_kv_heads, hd)
    return k, v

"""Model assembly for the dense family (counterpart of
``repro/models/model.py``; the other families wait for ROADMAP Queue 1
item 8).

Public API (``cfg`` is a frozen ``ModelConfig``):

    init_params(cfg, generator, dtype, device)               -> params
    init_cache(cfg, batch_size, max_len, dtype, device)      -> cache
    prefill(params, cfg, batch, cache)                       -> (last_logits, cache)
    decode_step(params, cfg, tokens, cache)                  -> (logits, cache)
    init_paged_cache(cfg, lanes, num_blocks, block_size, ...) -> paged cache
    prefill_paged_chunk(params, cfg, tokens, cache, lane=, n_valid=)
    decode_step_paged(params, cfg, tokens, cache, live=)

Params are the reference's pytree with the stacked ``layers`` subtree split
into a list of per-layer dicts; a Python loop over that list takes the place
of ``layer_scan``. Caches are dicts of tensors updated in place (the
functions still return them, so call sites read like the reference).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L

Params = Dict[str, Any]

# Families this port runs so far.
FAMILIES = ("dense",)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 8); "
            f"supported: {FAMILIES}")


# ===========================================================================
# init
# ===========================================================================
def _dense_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    return {"attn_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, device),
            "attn": ATT.attn_init(gen, cfg, dtype, device),
            "mlp_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                              dtype, device)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> Params:
    """Random weights with the reference's shapes and scales, drawn on
    ``device`` from ``generator`` (which must live on that device). The
    numbers differ from the reference's (JAX PRNG); use ``convert`` to run
    both packages on the same weights."""
    _check_family(cfg)
    params: Params = {
        "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                              device),
        "final_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(generator, cfg.d_model,
                                         cfg.vocab_size, dtype, device)
    params["layers"] = [_dense_layer_init(generator, cfg, dtype, device)
                        for _ in range(cfg.num_layers)]
    return params


def param_count(params) -> int:
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return sum(param_count(v) for v in params)


def _logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    h = L.norm_apply(cfg.norm, params["final_norm"], h)
    if cfg.tie_embeddings:
        return h @ params["embed"]["emb"].T
    return L.linear(params["unembed"], h)


def _mlp_block(lp, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    m = L.norm_apply(cfg.norm, lp["mlp_norm"], h)
    return h + L.mlp_apply(lp["mlp"], m, cfg.activation)


# ===========================================================================
# dense KV cache
# ===========================================================================
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.float32, device="cpu") -> Dict[str, torch.Tensor]:
    """k/v (layers, B, Hkv, max_len, hd) and pos (B,) int32."""
    _check_family(cfg)
    shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, max_len,
             cfg.resolved_head_dim)
    return {"pos": torch.zeros((batch_size,), dtype=torch.int32, device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(params: Params, cfg: ModelConfig, batch, cache, *,
            backend: str = "auto"):
    """Process the whole prompt, fill the cache in place. batch["tokens"]
    (B, S). Returns (last_logits (B, V), cache)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h = params["embed"]["emb"][tokens]
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    for i, lp in enumerate(params["layers"]):
        a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
        h = h + ATT.prefill_attention(
            lp["attn"], cfg, a, positions=positions, k_cache=cache["k"][i],
            v_cache=cache["v"][i], window=cfg.sliding_window, backend=backend)
        h = _mlp_block(lp, cfg, h)
    cache["pos"].fill_(S)                                   # in place
    return _logits(params, cfg, h[:, -1]), cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor, cache,
                *, backend: str = "auto"):
    """One decode step. tokens (B, 1) int. Returns (logits (B, V), cache)."""
    _check_family(cfg)
    pos = cache["pos"]                                      # length BEFORE
    kv_len = pos + 1
    h = params["embed"]["emb"][tokens]
    positions = pos[:, None]
    for i, lp in enumerate(params["layers"]):
        a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
        h = h + ATT.decode_self_attention(
            lp["attn"], cfg, a, positions=positions, k_cache=cache["k"][i],
            v_cache=cache["v"][i], kv_len=kv_len, window=cfg.sliding_window,
            backend=backend)
        h = _mlp_block(lp, cfg, h)
    pos.copy_(kv_len)                                       # in place
    return _logits(params, cfg, h[:, -1]), cache


# ===========================================================================
# paged KV cache
# ===========================================================================
# Pool block 0 is the NULL BLOCK: never allocated, all dead block-table
# entries point at it, and writes from padded chunk rows and idle decode
# lanes are redirected into it. Readers mask by kv_len, so its contents are
# unreachable garbage by construction.
NULL_BLOCK = 0


def init_paged_cache(cfg: ModelConfig, lanes: int, num_blocks: int,
                     block_size: int, dtype=torch.float32, device="cpu", *,
                     max_blocks_per_lane: Optional[int] = None
                     ) -> Dict[str, torch.Tensor]:
    """Paged KV cache: one shared block pool plus per-lane tables.

      kp/vp         (layers, num_blocks, Hkv, block_size, hd)  shared pool
      block_tables  (lanes, max_blocks_per_lane) int32         logical->physical
      pos           (lanes,) int32                             valid context
    """
    _check_family(cfg)
    if num_blocks < 2:
        raise ValueError("need >= 2 blocks (block 0 is the reserved null block)")
    mb = max_blocks_per_lane if max_blocks_per_lane is not None else num_blocks
    shape = (cfg.num_layers, num_blocks, cfg.num_kv_heads, block_size,
             cfg.resolved_head_dim)
    return {"pos": torch.zeros((lanes,), dtype=torch.int32, device=device),
            "block_tables": torch.full((lanes, mb), NULL_BLOCK,
                                       dtype=torch.int32, device=device),
            "kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_paged_chunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                        cache, *, lane: int, n_valid: int,
                        backend: str = "auto"):
    """Prefill ONE chunk of one lane's prompt into its allocated blocks.

    tokens: (1, C), the next C prompt tokens of ``lane`` from the lane's
    current ``pos`` (rows past ``n_valid`` are padding). Writes the chunk's
    K/V into the lane's blocks, advances ``pos`` by ``n_valid``, and returns
    (logits of the LAST VALID token (1, V), cache). ``pos`` stays on the
    device: nothing here waits for the card.
    """
    _check_family(cfg)
    C = tokens.shape[1]
    dev = tokens.device
    start = cache["pos"][lane]                               # 0-d tensor
    h = params["embed"]["emb"][tokens]
    offs = torch.arange(C, dtype=torch.int32, device=dev)
    abs_pos = start + offs
    positions = abs_pos[None]                                # (1, C)
    table = cache["block_tables"][lane]                      # (mb,)
    bs = cache["kp"].shape[3]
    # padded rows may run past the table: clamp the read, as the reference's
    # gather clamps, then redirect their writes to the null block
    slot = (abs_pos // bs).clamp(max=table.shape[0] - 1).long()
    block_ids = torch.where(offs < n_valid, table[slot],
                            NULL_BLOCK).long()
    rows = (abs_pos % bs).long()
    kv_len = (start + n_valid)[None]                         # (1,)
    for i, lp in enumerate(params["layers"]):
        a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
        h = h + ATT.paged_prefill_chunk_attention(
            lp["attn"], cfg, a, positions=positions, k_pool=cache["kp"][i],
            v_pool=cache["vp"][i], table=table, block_ids=block_ids, rows=rows,
            kv_len=kv_len, q_offset=start, window=cfg.sliding_window,
            backend=backend)
        h = _mlp_block(lp, cfg, h)
    cache["pos"][lane] = kv_len[0]                           # in place
    last = h[0, max(n_valid - 1, 0)]
    return _logits(params, cfg, last[None]), cache


def decode_step_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      cache, *, live: Optional[torch.Tensor] = None,
                      backend: str = "auto"):
    """One batched decode step over every lane of a paged cache.

    tokens (lanes, 1) int; ``live`` (lanes,) bool — lanes that are empty or
    still prefilling run the math for shape stability, but their K/V writes
    go to the null block and their ``pos`` does not advance (a freed lane's
    blocks may already belong to another request). Returns
    (logits (lanes, V), cache).
    """
    _check_family(cfg)
    B = tokens.shape[0]
    pos = cache["pos"]
    if live is None:
        live = torch.ones((B,), dtype=torch.bool, device=tokens.device)
    kv_len = pos + 1
    h = params["embed"]["emb"][tokens]
    positions = pos[:, None]
    tables = cache["block_tables"]
    bs = cache["kp"].shape[3]
    lanes = torch.arange(B, device=tokens.device)
    slot = (pos // bs).clamp(max=tables.shape[1] - 1).long()
    block_ids = torch.where(live, tables[lanes, slot], NULL_BLOCK).long()
    rows = (pos % bs).long()
    for i, lp in enumerate(params["layers"]):
        a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
        h = h + ATT.paged_decode_self_attention(
            lp["attn"], cfg, a, positions=positions, k_pool=cache["kp"][i],
            v_pool=cache["vp"][i], block_tables=tables, block_ids=block_ids,
            rows=rows, kv_len=kv_len, window=cfg.sliding_window,
            backend=backend)
        h = _mlp_block(lp, cfg, h)
    pos.copy_(torch.where(live, kv_len, pos))                # in place
    return _logits(params, cfg, h[:, -1]), cache

"""Model assembly for the dense, SSM and hybrid families (counterpart of
``repro/models/model.py``; the MoE, VLM and audio families wait for ROADMAP
Queue 1 item 8).

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
functions still return them, so call sites read like the reference). The
paged cache holds attention K/V only: SSM and hybrid lanes carry
fixed-size recurrent state and are served from the dense cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

Params = Dict[str, Any]

# Families this port runs so far.
FAMILIES = ("dense", "ssm", "hybrid")


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


def _mamba_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    return {"norm": L.norm_init(cfg.norm, cfg.d_model, dtype, device),
            "mamba": SSM.mamba_init(gen, cfg, dtype, device)}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu") -> Params:
    """Random weights with the reference's shapes, scales and leaf dtypes
    (``ssm.FLOAT32_LEAVES`` stay float32), drawn on ``device`` from
    ``generator`` (which must live on that device). The numbers differ from
    the reference's (JAX PRNG); use ``convert`` to run both packages on the
    same weights."""
    _check_family(cfg)
    params: Params = {
        "embed": L.embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                              device),
        "final_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(generator, cfg.d_model,
                                         cfg.vocab_size, dtype, device)
    layer_init = _dense_layer_init if cfg.family == "dense" \
        else _mamba_layer_init
    params["layers"] = [layer_init(generator, cfg, dtype, device)
                        for _ in range(cfg.num_layers)]
    if cfg.family == "hybrid":
        # the reference's _encdec_layer_init(cross=False): a dense layer's
        # leaves, one block shared by every attention call
        params["shared_attn"] = _dense_layer_init(generator, cfg, dtype,
                                                  device)
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


def _hybrid_segments(cfg: ModelConfig):
    """[(start, end, attn_after?)] covering all layers (one segment, with no
    attention, when ``hybrid_attn_every`` is 0)."""
    every = cfg.hybrid_attn_every
    segs = []
    s = 0
    while s < cfg.num_layers:
        e = min(s + every, cfg.num_layers) if every else cfg.num_layers
        segs.append((s, e, every > 0 and e - s == every))
        s = e
    return segs


# ===========================================================================
# dense cache: K/V, or conv/SSM state (+ shared-attention K/V)
# ===========================================================================
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.float32, device="cpu") -> Dict[str, torch.Tensor]:
    """pos (B,) int32, and per family:

      dense   k/v   (layers, B, Hkv, max_len, hd)
      ssm     conv  (layers, B, conv_width-1, d_inner+2N)  in ``dtype``
              ssm   (layers, B, H, P, N)                   float32
      hybrid  conv/ssm as above, and ak/av (attention calls, B, Hkv,
              max_len, hd): one slot per call of the shared block
    """
    _check_family(cfg)
    z = dict(dtype=dtype, device=device)
    cache = {"pos": torch.zeros((batch_size,), dtype=torch.int32,
                                device=device)}
    hd = cfg.resolved_head_dim
    if cfg.family == "dense":
        shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, max_len, hd)
        cache["k"] = torch.zeros(shape, **z)
        cache["v"] = torch.zeros(shape, **z)
        return cache
    s = cfg.ssm
    ch = cfg.d_inner + 2 * s.state_dim
    cache["conv"] = torch.zeros((cfg.num_layers, batch_size,
                                 s.conv_width - 1, ch), **z)
    cache["ssm"] = torch.zeros((cfg.num_layers, batch_size, cfg.ssm_heads,
                                s.head_dim, s.state_dim), dtype=torch.float32,
                               device=device)
    if cfg.family == "hybrid":
        n_attn = sum(1 for *_, a in _hybrid_segments(cfg) if a)
        shape = (n_attn, batch_size, cfg.num_kv_heads, max_len, hd)
        cache["ak"] = torch.zeros(shape, **z)
        cache["av"] = torch.zeros(shape, **z)
    return cache


def _recurrent_layers(params: Params, cfg: ModelConfig, h: torch.Tensor,
                      cache, mamba_layer, shared_attention) -> torch.Tensor:
    """The ssm/hybrid layer walk shared by prefill and decode: each segment
    of Mamba layers, then (hybrid) the shared attention block on its own
    ak/av slot. ``mamba_layer(lp, x, i)`` returns the block output and
    writes layer i's states; ``shared_attention(lp, x, k_cache, v_cache)``
    returns the attention output."""
    attn_i = 0
    for a, b, attn_after in _hybrid_segments(cfg):
        for i in range(a, b):
            lp = params["layers"][i]
            h = h + mamba_layer(lp["mamba"],
                                L.norm_apply(cfg.norm, lp["norm"], h), i)
        if attn_after:
            lp = params["shared_attn"]
            x = L.norm_apply(cfg.norm, lp["attn_norm"], h)
            h = h + shared_attention(lp["attn"], x, cache["ak"][attn_i],
                                     cache["av"][attn_i])
            h = _mlp_block(lp, cfg, h)
            attn_i += 1
    return h


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
    if cfg.family in ("ssm", "hybrid"):
        def mamba_layer(mp, x, i):
            y, conv_st, ssm_st = SSM.mamba_apply_with_state(mp, cfg, x,
                                                            backend=backend)
            cache["conv"][i].copy_(conv_st)                 # in place
            cache["ssm"][i].copy_(ssm_st)                   # in place
            return y

        def shared_attention(ap, x, kc, vc):
            return ATT.prefill_attention(ap, cfg, x, positions=positions,
                                         k_cache=kc, v_cache=vc,
                                         window=cfg.sliding_window,
                                         backend=backend)

        h = _recurrent_layers(params, cfg, h, cache, mamba_layer,
                              shared_attention)
    else:
        for i, lp in enumerate(params["layers"]):
            a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
            h = h + ATT.prefill_attention(
                lp["attn"], cfg, a, positions=positions,
                k_cache=cache["k"][i], v_cache=cache["v"][i],
                window=cfg.sliding_window, backend=backend)
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
    if cfg.family in ("ssm", "hybrid"):
        def mamba_layer(mp, x, i):
            y, conv_st, ssm_st = SSM.mamba_decode_step(
                mp, cfg, x, cache["conv"][i], cache["ssm"][i])
            cache["conv"][i].copy_(conv_st)                 # in place
            cache["ssm"][i].copy_(ssm_st)                   # in place
            return y

        def shared_attention(ap, x, kc, vc):
            return ATT.decode_self_attention(
                ap, cfg, x, positions=positions, k_cache=kc, v_cache=vc,
                kv_len=kv_len, window=cfg.sliding_window, backend=backend)

        h = _recurrent_layers(params, cfg, h, cache, mamba_layer,
                              shared_attention)
    else:
        for i, lp in enumerate(params["layers"]):
            a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
            h = h + ATT.decode_self_attention(
                lp["attn"], cfg, a, positions=positions,
                k_cache=cache["k"][i], v_cache=cache["v"][i], kv_len=kv_len,
                window=cfg.sliding_window, backend=backend)
            h = _mlp_block(lp, cfg, h)
    pos.copy_(kv_len)                                       # in place
    return _logits(params, cfg, h[:, -1]), cache


# ===========================================================================
# paged KV cache
# ===========================================================================
# Families whose serving cache is attention K/V and therefore pageable (the
# reference's list; moe is not ported yet). SSM and hybrid lanes carry
# fixed-size recurrent state: paging buys nothing.
PAGED_FAMILIES = ("dense", "moe")

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
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(f"paged KV cache supports families {PAGED_FAMILIES}, "
                         f"not {cfg.family!r}")
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

"""Model assembly for every assigned family: dense, MoE, VLM, SSM, hybrid
and audio (counterpart of ``repro/models/model.py``).

Public API (``cfg`` is a frozen ``ModelConfig``):

    init_params(cfg, generator, dtype, device, max_positions=) -> params
    forward_train(params, cfg, batch, remat=)                -> (logits, aux_loss)
    init_cache(cfg, batch_size, max_len, dtype, device, enc_len=, kv_quant=)
    prefill(params, cfg, batch, cache)                       -> (last_logits, cache)
    decode_step(params, cfg, tokens, cache)                  -> (logits, cache)
    encode(params, cfg, frames)                              -> encoder output
    init_paged_cache(cfg, lanes, num_blocks, block_size, ..., kv_quant=)
    prefill_paged_chunk(params, cfg, tokens, cache, lane=, n_valid=)
    decode_step_paged(params, cfg, tokens, cache, live= or lanes=)

``batch`` holds ``tokens`` (B, S) for every family, and ``vision`` (B,
n_vis, d_model) for the VLM family (patch embeddings put before the text)
or ``frames`` (B, S_enc, d_model) for the audio family (frame embeddings
for the encoder); the frontends that would make them are stubs, as in the
reference.

Params are the reference's pytree with each stacked layer subtree
(``layers``, ``enc_layers``, ``dec_layers``) split into a list of
per-layer dicts; a Python loop over that list takes the place of
``layer_scan`` (and ``torch.utils.checkpoint`` per layer, with ``remat``,
of ``jax.checkpoint``). Caches are dicts of tensors updated in place (the
functions still return them, so call sites read like the reference). The
paged cache holds attention K/V only (dense and MoE): SSM and hybrid lanes
carry fixed-size recurrent state, and VLM and audio prompts carry
embeddings a chunk cannot split, so they are served from the dense cache.
With ``kv_quant`` the dense, MoE and VLM families' K/V are int8 with
per-row float32 scales (``k_scale``/``v_scale``, ``kp_scale``/``vp_scale``);
every step function takes the int8 branch when the cache holds those keys,
as the reference does. MoE layers route with capacity in ``prefill`` and
``forward_train`` and dropless everywhere else, as the reference's do.

A hybrid config with a ``block_pattern`` (Nemotron-H) walks one block per
character, each with weights of its own: M a Mamba2 mixer, E a
sigmoid-routed MoE FFN (dropless everywhere, ``moe.moe_apply_sigmoid``),
* attention; each block is h + mixer(norm(h)). Its dense cache holds conv
and SSM state for the M blocks, K/V (ak/av) for the * blocks, ``live``
(B,) bool, set by ``prefill`` and cleared by the batcher at retirement,
which ``decode_step`` reads (a lane that is not live routes to no
expert), and ``moe_stats`` (2,) int64, the routed rows and the experts
touched of the last step, summed over its E blocks.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Params = Dict[str, Any]

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")
# families whose layers are attention plus an MLP or MoE FFN over a K/V cache
KV_FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; one of {FAMILIES}")


# ===========================================================================
# init
# ===========================================================================
def _dense_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    p = {"attn_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, device),
         "attn": ATT.attn_init(gen, cfg, dtype, device),
         "mlp_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, device)}
    if cfg.family == "moe":
        p["moe"] = MOE.moe_init(gen, cfg, dtype, device)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                              dtype, device)
    return p


def _encdec_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype, device,
                       *, cross: bool):
    p = {"attn_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, device),
         "attn": ATT.attn_init(gen, cfg, dtype, device),
         "mlp_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, device),
         "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype,
                           device)}
    if cross:
        p["cross_norm"] = L.norm_init(cfg.norm, cfg.d_model, dtype, device)
        p["cross"] = ATT.attn_init(gen, cfg, dtype, device, cross=True)
    return p


def _mamba_layer_init(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    return {"norm": L.norm_init(cfg.norm, cfg.d_model, dtype, device),
            "mamba": SSM.mamba_init(gen, cfg, dtype, device)}


def _pattern_layer_init(gen: torch.Generator, cfg: ModelConfig, kind: str,
                        dtype, device):
    if kind == "M":
        return _mamba_layer_init(gen, cfg, dtype, device)
    p = {"norm": L.norm_init(cfg.norm, cfg.d_model, dtype, device)}
    if kind == "E":
        p["moe"] = MOE.moe_init(gen, cfg, dtype, device)
    else:
        p["attn"] = ATT.attn_init(gen, cfg, dtype, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.float32, device="cpu",
                max_positions: Optional[int] = None) -> Params:
    """Random weights with the reference's shapes, scales and leaf dtypes
    (``ssm.FLOAT32_LEAVES`` stay float32), drawn on ``device`` from
    ``generator`` (which must live on that device). The numbers differ from
    the reference's (JAX PRNG); use ``convert`` to run both packages on the
    same weights. ``max_positions``: rows of the audio decoder's learned
    position table (default ``cfg.max_seq_len``)."""
    _check_family(cfg)
    g = generator
    params: Params = {
        "embed": L.embed_init(g, cfg.vocab_size, cfg.d_model, dtype, device),
        "final_norm": L.norm_init(cfg.norm, cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(g, cfg.d_model, cfg.vocab_size,
                                         dtype, device)
    if cfg.family in KV_FAMILIES:
        params["layers"] = [_dense_layer_init(g, cfg, dtype, device)
                            for _ in range(cfg.num_layers)]
    elif cfg.block_pattern:
        params["layers"] = [_pattern_layer_init(g, cfg, kind, dtype, device)
                            for kind in cfg.block_pattern]
    elif cfg.family in ("ssm", "hybrid"):
        params["layers"] = [_mamba_layer_init(g, cfg, dtype, device)
                            for _ in range(cfg.num_layers)]
        if cfg.family == "hybrid":
            # one block shared by every attention call
            params["shared_attn"] = _encdec_layer_init(g, cfg, dtype, device,
                                                       cross=False)
    else:                                                   # audio
        mp = max_positions or cfg.max_seq_len
        params["enc_layers"] = [
            _encdec_layer_init(g, cfg, dtype, device, cross=False)
            for _ in range(cfg.encoder_layers)]
        params["enc_final_norm"] = L.norm_init(cfg.norm, cfg.d_model, dtype,
                                               device)
        params["dec_layers"] = [
            _encdec_layer_init(g, cfg, dtype, device, cross=True)
            for _ in range(cfg.num_layers)]
        params["dec_pos"] = {"emb": L._normal(g, (mp, cfg.d_model), 0.01,
                                              dtype, device)}
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


def _mlp_block(lp, cfg: ModelConfig, h: torch.Tensor, *,
               dropless: bool = True) -> torch.Tensor:
    """The norm and FFN half of a layer: an MLP, or (MoE) the routed
    experts, dropless unless the caller asks for capacity dispatch."""
    m = L.norm_apply(cfg.norm, lp["mlp_norm"], h)
    if "moe" in lp:
        y, _ = MOE.moe_apply(lp["moe"], cfg, m, dropless=dropless)
        return h + y
    return h + L.mlp_apply(lp["mlp"], m, cfg.activation)


# ===========================================================================
# position helpers
# ===========================================================================
def mrope_positions(cfg: ModelConfig, B: int, seq_len: int, n_vis: int,
                    start: int = 0, device="cpu") -> torch.Tensor:
    """(B, seq_len, 3) int32 position ids: vision tokens get a (t=0, h, w)
    grid, text tokens equal (t, h, w) = grid_side + text_index (qwen2-vl)."""
    g = max(1, int(round(n_vis ** 0.5)))
    idx = torch.arange(seq_len, device=device) + start
    is_vis = idx < n_vis
    text = idx - n_vis + g
    t = torch.where(is_vis, 0, text)
    h = torch.where(is_vis, idx // g, text)
    w = torch.where(is_vis, idx % g, text)
    pos = torch.stack([t, h, w], dim=-1)                    # (S, 3)
    return pos[None].expand(B, seq_len, 3).to(torch.int32)


def _positions(cfg: ModelConfig, B: int, S: int, n_vis: int = 0,
               device="cpu") -> torch.Tensor:
    if cfg.pos_emb == "mrope":
        return mrope_positions(cfg, B, S, n_vis, device=device)
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _decode_positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """Positions of one decode token per lane from the length before it:
    (B, 1), or (B, 1, 3) under M-RoPE, where the text stream's position is
    pos - n_vis + grid_side on all three streams, n_vis taken from the
    config, as in the reference."""
    if cfg.pos_emb == "mrope":
        n_vis = cfg.num_vision_tokens
        g = max(1, int(round(n_vis ** 0.5)))
        p = (pos - n_vis + g).to(torch.int32)
        return torch.stack([p, p, p], dim=-1)[:, None, :]
    return pos[:, None]


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
# forward (train / full sequence)
# ===========================================================================
def _maybe_remat(fn, remat: bool):
    """``fn`` itself, or ``fn`` recomputed in the backward (its activations
    not kept), as ``jax.checkpoint`` does for the reference's layer body."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _dense_block(lp, cfg: ModelConfig, h, positions, backend: str):
    """One dense, MoE or VLM layer: (h, aux). MoE routes with capacity
    dispatch, as the reference's training forward does."""
    a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
    h = h + ATT.self_attention(lp["attn"], cfg, a, positions=positions,
                               causal=True, window=cfg.sliding_window,
                               backend=backend)
    m = L.norm_apply(cfg.norm, lp["mlp_norm"], h)
    if cfg.family == "moe":
        y, aux = MOE.moe_apply(lp["moe"], cfg, m, dropless=False)
        return h + y, aux
    return (h + L.mlp_apply(lp["mlp"], m, cfg.activation),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _mamba_block(lp, cfg: ModelConfig, h, backend: str):
    x = L.norm_apply(cfg.norm, lp["norm"], h)
    return h + SSM.mamba_apply(lp["mamba"], cfg, x, backend=backend)


def _pattern_block(lp, cfg: ModelConfig, kind: str, h, positions,
                   backend: str):
    """One block of a ``block_pattern`` model over a whole sequence."""
    x = L.norm_apply(cfg.norm, lp["norm"], h)
    if kind == "M":
        return h + SSM.mamba_apply(lp["mamba"], cfg, x, backend=backend)
    if kind == "E":
        return h + MOE.moe_apply_sigmoid(lp["moe"], cfg, x,
                                         backend=backend)[0]
    return h + ATT.self_attention(lp["attn"], cfg, x, positions=positions,
                                  causal=True, window=cfg.sliding_window,
                                  backend=backend)


def _shared_attn_block(params, cfg: ModelConfig, h, positions, backend: str):
    lp = params["shared_attn"]
    a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
    h = h + ATT.self_attention(lp["attn"], cfg, a, positions=positions,
                               causal=True, window=cfg.sliding_window,
                               backend=backend)
    return _mlp_block(lp, cfg, h)


def forward_train(params: Params, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor], *, backend: str = "auto",
                  remat: bool = False):
    """Full-sequence forward. Returns (logits (B, S_total, V), aux_loss
    float32 scalar). VLM logits keep the vision positions (S_total = n_vis
    + S), as the reference's do; aux is the MoE load-balance loss summed
    over the layers, 0 for the other families. ``remat`` recomputes each
    layer in the backward (the audio encoder is not rematerialised, as in
    the reference)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    if cfg.family == "audio":
        enc_out = encode(params, cfg, batch["frames"], backend=backend)
        return _decode_train(params, cfg, tokens, enc_out, backend=backend,
                             remat=remat)
    B, S_text = tokens.shape
    h = params["embed"]["emb"][tokens]
    if cfg.family == "vlm":
        h = torch.cat([batch["vision"].to(h.dtype), h], dim=1)
    S = h.shape[1]
    positions = _positions(cfg, B, S, S - S_text, tokens.device)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)

    if cfg.family in KV_FAMILIES:
        block = _maybe_remat(
            lambda lp, x: _dense_block(lp, cfg, x, positions, backend), remat)
        auxs = []
        for lp in params["layers"]:
            h, aux = block(lp, h)
            auxs.append(aux)
        return _logits(params, cfg, h), torch.stack(auxs).sum()

    if cfg.block_pattern:
        for kind, lp in zip(cfg.block_pattern, params["layers"]):
            h = _maybe_remat(lambda p, x, kind=kind: _pattern_block(
                p, cfg, kind, x, positions, backend), remat)(lp, h)
        return _logits(params, cfg, h), zero

    block = _maybe_remat(lambda lp, x: _mamba_block(lp, cfg, x, backend),
                         remat)
    for a, b, attn_after in _hybrid_segments(cfg):
        for lp in params["layers"][a:b]:
            h = block(lp, h)
        if attn_after:                              # hybrid only
            h = _shared_attn_block(params, cfg, h, positions, backend)
    return _logits(params, cfg, h), zero


def _decode_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  enc_out: torch.Tensor, *, backend: str, remat: bool):
    """The audio decoder over a whole token sequence: causal self attention
    (no window), cross-attention over the encoder's output (non-causal, K1
    with Sq != Sk on the card), then the MLP, per layer."""
    B, S = tokens.shape
    h = params["embed"]["emb"][tokens] + params["dec_pos"]["emb"][None, :S]
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)

    def layer(lp, x):
        a = L.norm_apply(cfg.norm, lp["attn_norm"], x)
        x = x + ATT.self_attention(lp["attn"], cfg, a, positions=positions,
                                   causal=True, backend=backend)
        c = L.norm_apply(cfg.norm, lp["cross_norm"], x)
        ek, ev = ATT.encode_kv(lp["cross"], cfg, enc_out)
        x = x + ATT.cross_attention(lp["cross"], cfg, c, enc_k=ek, enc_v=ev,
                                    backend=backend)
        return _mlp_block(lp, cfg, x)

    layer = _maybe_remat(layer, remat)
    for lp in params["dec_layers"]:
        h = layer(lp, h)
    return _logits(params, cfg, h), torch.zeros((), dtype=torch.float32,
                                                device=h.device)


# ===========================================================================
# dense cache: K/V, or conv/SSM state (+ shared-attention K/V)
# ===========================================================================
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.float32, device="cpu",
               enc_len: Optional[int] = None,
               kv_quant: bool = False) -> Dict[str, torch.Tensor]:
    """pos (B,) int32, and per family:

      dense, moe, vlm
              k/v   (layers, B, Hkv, max_len, hd); with ``kv_quant`` int8,
                    and k_scale/v_scale (layers, B, Hkv, max_len, 1) float32
      ssm     conv  (layers, B, conv_width-1, d_inner+2N)  in ``dtype``
              ssm   (layers, B, H, P, N)                   float32
      hybrid  conv/ssm as above, and ak/av (attention calls, B, Hkv,
              max_len, hd): one slot per call of the shared block
      audio   k/v as dense (never int8), and ck/cv (layers, B, Hkv,
              enc_len, hd): the cross-attention K/V of the encoder's output
              (``enc_len`` defaults to ``cfg.encoder_seq_len``)
    """
    _check_family(cfg)
    z = dict(dtype=dtype, device=device)
    cache = {"pos": torch.zeros((batch_size,), dtype=torch.int32,
                                device=device)}
    hd = cfg.resolved_head_dim
    if cfg.family == "audio":
        shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, max_len, hd)
        cache["k"] = torch.zeros(shape, **z)
        cache["v"] = torch.zeros(shape, **z)
        el = enc_len or cfg.encoder_seq_len
        cshape = (cfg.num_layers, batch_size, cfg.num_kv_heads, el, hd)
        cache["ck"] = torch.zeros(cshape, **z)
        cache["cv"] = torch.zeros(cshape, **z)
        return cache
    if cfg.family in KV_FAMILIES:
        shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, max_len, hd)
        kv_dtype = torch.int8 if kv_quant else dtype
        cache["k"] = torch.zeros(shape, dtype=kv_dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=kv_dtype, device=device)
        if kv_quant:
            sshape = shape[:-1] + (1,)
            cache["k_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                           device=device)
            cache["v_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                           device=device)
        return cache
    s = cfg.ssm
    ch = cfg.d_inner + 2 * s.n_groups * s.state_dim
    n_mamba = cfg.blocks("M") if cfg.block_pattern else cfg.num_layers
    cache["conv"] = torch.zeros((n_mamba, batch_size,
                                 s.conv_width - 1, ch), **z)
    cache["ssm"] = torch.zeros((n_mamba, batch_size, cfg.ssm_heads,
                                s.head_dim, s.state_dim), dtype=torch.float32,
                               device=device)
    if cfg.block_pattern:
        shape = (cfg.blocks("*"), batch_size, cfg.num_kv_heads, max_len, hd)
        cache["ak"] = torch.zeros(shape, **z)
        cache["av"] = torch.zeros(shape, **z)
        cache["live"] = torch.zeros((batch_size,), dtype=torch.bool,
                                    device=device)
        if cfg.blocks("E"):
            cache["moe_stats"] = torch.zeros((2,), dtype=torch.int64,
                                             device=device)
    elif cfg.family == "hybrid":
        n_attn = sum(1 for *_, a in _hybrid_segments(cfg) if a)
        shape = (n_attn, batch_size, cfg.num_kv_heads, max_len, hd)
        cache["ak"] = torch.zeros(shape, **z)
        cache["av"] = torch.zeros(shape, **z)
    return cache


def _scales(cache, i: int, *, paged: bool = False) -> Dict[str, Any]:
    """Layer i's scale tensors as attention kwargs when the cache is int8,
    else none (the float branch)."""
    key = "kp_scale" if paged else "k_scale"
    if key not in cache:
        return {}
    if paged:
        return {"k_scale_pool": cache["kp_scale"][i],
                "v_scale_pool": cache["vp_scale"][i]}
    return {"k_scale": cache["k_scale"][i], "v_scale": cache["v_scale"][i]}


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


def _pattern_layers(params: Params, cfg: ModelConfig, h: torch.Tensor,
                    cache, mamba_layer, attention, moe_layer) -> torch.Tensor:
    """The ``block_pattern`` walk shared by prefill and decode:
    ``mamba_layer(mp, x, i)`` (the i-th M block; writes its states),
    ``attention(ap, x, k_cache, v_cache)`` (the i-th * block on its ak/av
    slot) and ``moe_layer(mp, x)`` -> (y, routed rows, experts touched);
    the E blocks' counts are summed into ``moe_stats``."""
    counts = {"M": 0, "*": 0, "E": 0}
    rows, touched = [], []
    for kind, lp in zip(cfg.block_pattern, params["layers"]):
        x = L.norm_apply(cfg.norm, lp["norm"], h)
        if kind == "M":
            h = h + mamba_layer(lp["mamba"], x, counts["M"])
        elif kind == "*":
            i = counts["*"]
            h = h + attention(lp["attn"], x, cache["ak"][i], cache["av"][i])
        else:
            y, r, t = moe_layer(lp["moe"], x)
            h = h + y
            rows.append(r)
            touched.append(t)
        counts[kind] += 1
    if rows:
        cache["moe_stats"].copy_(torch.stack([torch.stack(rows).sum(),
                                              torch.stack(touched).sum()]))
    return h


# --------------------------------------------------------------------- audio
def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor, *,
           backend: str = "auto") -> torch.Tensor:
    """Bidirectional encoder over the stub frame embeddings (B, S_enc, d):
    sinusoidal positions, then non-causal self attention (K1 on the card)
    and an MLP per layer, then the final norm."""
    B, S_enc, _ = frames.shape
    h = frames + L.sinusoidal_positions(S_enc, cfg.d_model,
                                        frames.device).to(frames.dtype)[None]
    positions = torch.arange(S_enc, dtype=torch.int32,
                             device=frames.device)[None].expand(B, S_enc)
    for lp in params["enc_layers"]:
        a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
        h = h + ATT.self_attention(lp["attn"], cfg, a, positions=positions,
                                   causal=False, backend=backend)
        h = _mlp_block(lp, cfg, h)
    return L.norm_apply(cfg.norm, params["enc_final_norm"], h)


def _decoder_layers(params: Params, cfg: ModelConfig, h: torch.Tensor, cache,
                    self_attention, backend: str) -> torch.Tensor:
    """The audio decoder's layer walk shared by prefill and decode: self
    attention (``self_attention(lp, x, i)``, which writes layer i's K/V),
    cross-attention over the cached encoder K/V, then the MLP."""
    for i, lp in enumerate(params["dec_layers"]):
        a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
        h = h + self_attention(lp["attn"], a, i)
        c = L.norm_apply(cfg.norm, lp["cross_norm"], h)
        h = h + ATT.cross_attention(lp["cross"], cfg, c, enc_k=cache["ck"][i],
                                    enc_v=cache["cv"][i], backend=backend)
        h = _mlp_block(lp, cfg, h)
    return h


def _prefill_audio(params: Params, cfg: ModelConfig, batch, cache, *,
                   backend: str):
    """Encode once, keep each decoder layer's cross K/V in the cache, then
    prefill the decoder prompt with the learned positions added."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = encode(params, cfg, batch["frames"], backend=backend)
    ckv = [ATT.encode_kv(lp["cross"], cfg, enc_out)
           for lp in params["dec_layers"]]
    dt = cache["ck"].dtype
    # replaced, not written in place: the encoder's length is the frames'
    cache["ck"] = torch.stack([k for k, _ in ckv]).to(dt)
    cache["cv"] = torch.stack([v for _, v in ckv]).to(dt)
    h = params["embed"]["emb"][tokens] + params["dec_pos"]["emb"][None, :S]
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)

    def self_attention(ap, x, i):
        return ATT.prefill_attention(ap, cfg, x, positions=positions,
                                     k_cache=cache["k"][i],
                                     v_cache=cache["v"][i], backend=backend)

    h = _decoder_layers(params, cfg, h, cache, self_attention, backend)
    cache["pos"].fill_(S)                                   # in place
    return _logits(params, cfg, h[:, -1]), cache


def prefill(params: Params, cfg: ModelConfig, batch, cache, *,
            backend: str = "auto", n_valid: Optional[torch.Tensor] = None):
    """Process the whole prompt, fill the cache in place. batch["tokens"]
    (B, S), with batch["vision"] (VLM) or batch["frames"] (audio). Returns
    (last_logits (B, V), cache). ``n_valid`` (0-d int, device; a
    ``block_pattern`` model): the prompt is the first n_valid tokens and the
    rest padding, which leaves every state as it was and routes to no
    expert, so one captured step serves every prompt up to S; the logits
    are position n_valid - 1's and the cache's length is n_valid."""
    _check_family(cfg)
    if n_valid is not None and not cfg.block_pattern:
        raise ValueError("a padded prefill needs a block_pattern model")
    if cfg.family == "audio":
        return _prefill_audio(params, cfg, batch, cache, backend=backend)
    tokens = batch["tokens"]
    B, S_text = tokens.shape
    h = params["embed"]["emb"][tokens]
    if cfg.family == "vlm":
        h = torch.cat([batch["vision"].to(h.dtype), h], dim=1)
    S = h.shape[1]
    n_vis = S - S_text
    positions = _positions(cfg, B, S, n_vis, tokens.device)
    if cfg.family in ("ssm", "hybrid"):
        def mamba_layer(mp, x, i):
            y, conv_st, ssm_st = SSM.mamba_apply_with_state(
                mp, cfg, x, backend=backend, n_valid=n_valid)
            cache["conv"][i].copy_(conv_st)                 # in place
            cache["ssm"][i].copy_(ssm_st)                   # in place
            return y

        def shared_attention(ap, x, kc, vc):
            return ATT.prefill_attention(ap, cfg, x, positions=positions,
                                         k_cache=kc, v_cache=vc,
                                         window=cfg.sliding_window,
                                         backend=backend)

        if cfg.block_pattern:
            live = None if n_valid is None else \
                (torch.arange(S, device=h.device) < n_valid).expand(B, S)
            h = _pattern_layers(
                params, cfg, h, cache, mamba_layer, shared_attention,
                lambda mp, x: MOE.moe_apply_sigmoid(mp, cfg, x, live=live,
                                                    backend=backend))
            cache["live"].fill_(True)                       # in place
        else:
            h = _recurrent_layers(params, cfg, h, cache, mamba_layer,
                                  shared_attention)
    else:
        for i, lp in enumerate(params["layers"]):
            a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
            h = h + ATT.prefill_attention(
                lp["attn"], cfg, a, positions=positions,
                k_cache=cache["k"][i], v_cache=cache["v"][i],
                window=cfg.sliding_window, backend=backend,
                **_scales(cache, i))
            # MoE: capacity dispatch over the whole prompt
            h = _mlp_block(lp, cfg, h, dropless=False)
    if n_valid is not None:
        cache["pos"].copy_(n_valid)                         # in place
        last = (n_valid - 1).reshape(1).long()
        return _logits(params, cfg, h.index_select(1, last)[:, 0]), cache
    cache["pos"].fill_(S)                                   # in place
    return _logits(params, cfg, h[:, -1]), cache


def decode_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor, cache,
                *, backend: str = "auto"):
    """One decode step. tokens (B, 1) int. Returns (logits (B, V), cache)."""
    _check_family(cfg)
    pos = cache["pos"]                                      # length BEFORE
    kv_len = pos + 1
    h = params["embed"]["emb"][tokens]
    positions = _decode_positions(cfg, pos)
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

        if cfg.block_pattern:
            h = _pattern_layers(
                params, cfg, h, cache, mamba_layer, shared_attention,
                lambda mp, x: MOE.moe_apply_sigmoid(
                    mp, cfg, x, live=cache["live"], backend=backend))
        else:
            h = _recurrent_layers(params, cfg, h, cache, mamba_layer,
                                  shared_attention)
    elif cfg.family == "audio":
        h = h + params["dec_pos"]["emb"][pos.long()][:, None, :]

        def self_attention(ap, x, i):
            return ATT.decode_self_attention(
                ap, cfg, x, positions=positions, k_cache=cache["k"][i],
                v_cache=cache["v"][i], kv_len=kv_len, backend=backend)

        h = _decoder_layers(params, cfg, h, cache, self_attention, backend)
    else:
        for i, lp in enumerate(params["layers"]):
            a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
            h = h + ATT.decode_self_attention(
                lp["attn"], cfg, a, positions=positions,
                k_cache=cache["k"][i], v_cache=cache["v"][i], kv_len=kv_len,
                window=cfg.sliding_window, backend=backend,
                **_scales(cache, i))
            h = _mlp_block(lp, cfg, h)
    pos.copy_(kv_len)                                       # in place
    return _logits(params, cfg, h[:, -1]), cache


# ===========================================================================
# paged KV cache
# ===========================================================================
# Families whose serving cache is attention K/V and therefore pageable, the
# reference's list. SSM and hybrid lanes carry fixed-size recurrent state
# (paging buys nothing); audio and VLM prompts carry embeddings that the
# chunked path cannot split.
PAGED_FAMILIES = ("dense", "moe")

# Pool block 0 is the NULL BLOCK: never allocated, all dead block-table
# entries point at it, and writes from padded chunk rows and idle decode
# lanes are redirected into it. Readers mask by kv_len, so its contents are
# unreachable garbage by construction.
NULL_BLOCK = 0


def init_paged_cache(cfg: ModelConfig, lanes: int, num_blocks: int,
                     block_size: int, dtype=torch.float32, device="cpu", *,
                     max_blocks_per_lane: Optional[int] = None,
                     kv_quant: bool = False) -> Dict[str, torch.Tensor]:
    """Paged KV cache: one shared block pool plus per-lane tables.

      kp/vp         (layers, num_blocks, Hkv, block_size, hd)  shared pool
      block_tables  (lanes, max_blocks_per_lane) int32         logical->physical
      pos           (lanes,) int32                             valid context

    ``kv_quant`` stores int8 blocks with per-row float32 scale pools
    kp_scale/vp_scale (layers, num_blocks, Hkv, block_size, 1).
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
    kv_dtype = torch.int8 if kv_quant else dtype
    cache = {"pos": torch.zeros((lanes,), dtype=torch.int32, device=device),
             "block_tables": torch.full((lanes, mb), NULL_BLOCK,
                                        dtype=torch.int32, device=device),
             "kp": torch.zeros(shape, dtype=kv_dtype, device=device),
             "vp": torch.zeros(shape, dtype=kv_dtype, device=device)}
    if kv_quant:
        sshape = shape[:-1] + (1,)
        cache["kp_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                        device=device)
        cache["vp_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                        device=device)
    return cache


def _index(x, device) -> torch.Tensor:
    """A lane or a count as a 0-d int32 tensor on ``device``: a tensor as
    given, a Python int filled in on the device (no host-to-device copy)."""
    if isinstance(x, torch.Tensor):
        if x.dim() != 0:
            raise ValueError(f"expected a 0-d tensor, got {tuple(x.shape)}")
        return x
    return torch.full((), x, dtype=torch.int32, device=device)


def prefill_paged_chunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                        cache, *, lane, n_valid, backend: str = "auto"):
    """Prefill ONE chunk of one lane's prompt into its allocated blocks.

    tokens: (1, C), the next C prompt tokens of ``lane`` from the lane's
    current ``pos`` (rows past ``n_valid`` are padding). ``lane`` and
    ``n_valid`` are 0-d int32 device tensors, as the reference traces them
    (a Python int is filled into one), and no value is read on the host:
    the step can be captured once per chunk shape and replayed for every
    lane and valid count. Writes the chunk's K/V into the lane's blocks,
    advances ``pos`` by ``n_valid``, and returns (logits of the LAST VALID
    token (1, V), cache).
    """
    _check_family(cfg)
    C = tokens.shape[1]
    dev = tokens.device
    lane = _index(lane, dev).reshape(1).long()               # (1,)
    n_valid = _index(n_valid, dev)
    start = cache["pos"].index_select(0, lane)[0]            # 0-d tensor
    h = params["embed"]["emb"][tokens]
    offs = torch.arange(C, dtype=torch.int32, device=dev)
    abs_pos = start + offs
    positions = abs_pos[None]                                # (1, C)
    table = cache["block_tables"].index_select(0, lane)[0]   # (mb,)
    bs = cache["kp"].shape[3]
    # padded rows may run past the table: clamp the read, as the reference's
    # gather clamps, then redirect their writes to the null block
    slot = (abs_pos // bs).clamp(max=table.shape[0] - 1).long()
    block_ids = torch.where(offs < n_valid, table[slot],
                            NULL_BLOCK).long()
    rows = (abs_pos % bs).long()
    kv_len = (start + n_valid)[None].to(torch.int32)         # (1,)
    for i, lp in enumerate(params["layers"]):
        a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
        h = h + ATT.paged_prefill_chunk_attention(
            lp["attn"], cfg, a, positions=positions, k_pool=cache["kp"][i],
            v_pool=cache["vp"][i], table=table, block_ids=block_ids, rows=rows,
            kv_len=kv_len, q_offset=start, window=cfg.sliding_window,
            backend=backend, **_scales(cache, i, paged=True))
        # MoE dropless, so a chunk routes as the whole prompt would when
        # the prompt's capacity never binds (the reduced configs)
        h = _mlp_block(lp, cfg, h)
    cache["pos"].index_copy_(0, lane, kv_len)                # in place
    last = h[0].index_select(0, (n_valid - 1).clamp(min=0).reshape(1).long())
    return _logits(params, cfg, last), cache


def decode_step_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      cache, *, live: Optional[torch.Tensor] = None,
                      lanes: Optional[torch.Tensor] = None,
                      backend: str = "auto"):
    """One batched decode step over the lanes of a paged cache.

    tokens (lanes, 1) int; ``live`` (lanes,) bool — lanes that are empty or
    still prefilling run the math for shape stability, but their K/V writes
    go to the null block and their ``pos`` does not advance (a freed lane's
    blocks may already belong to another request). Returns
    (logits (lanes, V), cache).

    ``lanes`` (n,) int64 instead of ``live``: the step runs n rows, row j
    lane ``lanes[j]``, so its products cost n rows, not every lane's; an
    entry of -1 is padding (kv_len 1 over null blocks, nothing written).
    Every other lane is left as it is. Returns (logits (n, V), cache).
    """
    _check_family(cfg)
    pos = cache["pos"]
    tables = cache["block_tables"]
    if lanes is not None:
        if live is not None:
            raise ValueError("give live or lanes, not both")
        live = lanes >= 0
        slots = lanes.clamp(min=0)
        tokens = tokens[slots]
        pos = torch.where(live, pos[slots], 0)
        tables = torch.where(live[:, None], tables[slots], NULL_BLOCK)
    B = tokens.shape[0]
    if live is None:
        live = torch.ones((B,), dtype=torch.bool, device=tokens.device)
    kv_len = pos + 1
    h = params["embed"]["emb"][tokens]
    positions = pos[:, None]
    bs = cache["kp"].shape[3]
    rows_b = torch.arange(B, device=tokens.device)
    slot = (pos // bs).clamp(max=tables.shape[1] - 1).long()
    block_ids = torch.where(live, tables[rows_b, slot], NULL_BLOCK).long()
    rows = (pos % bs).long()
    for i, lp in enumerate(params["layers"]):
        a = L.norm_apply(cfg.norm, lp["attn_norm"], h)
        h = h + ATT.paged_decode_self_attention(
            lp["attn"], cfg, a, positions=positions, k_pool=cache["kp"][i],
            v_pool=cache["vp"][i], block_tables=tables, block_ids=block_ids,
            rows=rows, kv_len=kv_len, window=cfg.sliding_window,
            backend=backend, **_scales(cache, i, paged=True))
        h = _mlp_block(lp, cfg, h)
    if lanes is None:
        pos.copy_(torch.where(live, kv_len, pos))            # in place
    else:   # padding adds 0 (to lane 0): a sum, so no write is lost
        cache["pos"].index_add_(0, slots, live.to(pos.dtype))  # in place
    return _logits(params, cfg, h[:, -1]), cache

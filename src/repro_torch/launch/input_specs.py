"""Meta-device stand-ins for every (arch x input-shape) combination
(counterpart of ``repro/launch/input_specs.py``).

No memory is allocated: params, optimizer state and caches come from the
port's own init functions on ``torch.device("meta")``, so their shapes and
dtypes are exactly the ones the serving and training paths build on the
card. A CPU ``torch.Generator`` draws nothing on the meta device. Every
function takes ``device=`` too, so the same code builds the same
structures on the card, where their bytes can be counted.

The port's params hold each stacked layer subtree as a list of per-layer
dicts (``models/convert.py``), so a leaf has no layer axis; the caches keep
the reference's leading layer axis.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import model as M
from repro_torch.training import optimizer as OPT

META = torch.device("meta")


def adapt_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Shape-driven config adjustments: long_500k on attention archs runs
    the sliding-window variant."""
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        cfg = dataclasses.replace(cfg, sliding_window=8192)
    return cfg


def batch_specs(cfg: ModelConfig, shape: InputShape, dtype=torch.bfloat16,
                device=META) -> Dict[str, torch.Tensor]:
    B = shape.global_batch
    empty = lambda shp, dt: torch.empty(shp, dtype=dt, device=device)
    if shape.kind == "decode":
        return {"tokens": empty((B, 1), torch.int32)}
    S = shape.seq_len
    out: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        S_text = S - cfg.num_vision_tokens
        out["vision"] = empty((B, cfg.num_vision_tokens, cfg.d_model), dtype)
        out["tokens"] = empty((B, S_text), torch.int32)
    elif cfg.family == "audio":
        out["frames"] = empty((B, cfg.encoder_seq_len, cfg.d_model), dtype)
        out["tokens"] = empty((B, S), torch.int32)
    else:
        out["tokens"] = empty((B, S), torch.int32)
    return out


def params_specs(cfg: ModelConfig, shape: InputShape, dtype=torch.bfloat16,
                 device=META):
    """Random params from seed 0 on ``device`` (nothing drawn on meta)."""
    device = torch.device(device)
    gen = torch.Generator("cpu" if device.type == "meta" else device)
    max_pos = max(cfg.max_seq_len, shape.seq_len + 1) \
        if cfg.family == "audio" else None
    return M.init_params(cfg, gen.manual_seed(0), dtype, device,
                         max_positions=max_pos)


def opt_specs(params_tree):
    return OPT.init_state(params_tree)


def cache_specs(cfg: ModelConfig, shape: InputShape, dtype=torch.bfloat16,
                device=META):
    kv_quant = (os.environ.get("REPRO_KV_QUANT") == "1"
                and cfg.family in ("dense", "moe", "vlm"))
    return M.init_cache(cfg, shape.global_batch, shape.seq_len, dtype, device,
                        enc_len=cfg.encoder_seq_len or None,
                        kv_quant=kv_quant)


def input_specs(cfg: ModelConfig, shape: InputShape, dtype=torch.bfloat16,
                device=META) -> Tuple[Any, ...]:
    """Everything the step function for this shape takes, on ``device``
    (the meta device unless asked).

    train:   (params, opt_state, batch)
    prefill: (params, batch, cache)
    decode:  (params, tokens, cache)
    """
    cfg = adapt_config(cfg, shape)
    params = params_specs(cfg, shape, dtype, device)
    batch = batch_specs(cfg, shape, dtype, device)
    if shape.kind == "train":
        return params, opt_specs(params), batch
    cache = cache_specs(cfg, shape, dtype, device)
    if shape.kind == "prefill":
        return params, batch, cache
    return params, batch["tokens"], cache

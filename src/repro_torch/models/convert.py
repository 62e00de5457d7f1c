"""Weights from the reference package's pytree, so both packages compute the
same function on the same numbers.

The caller hands over the JAX params as numpy arrays (``jax.tree.map(
np.asarray, params)``); nothing here imports JAX. Each stacked layer
subtree (leading layer axis) becomes a list of per-layer dicts:
``layers`` (dense, MoE, VLM, SSM, hybrid), and the audio family's
``enc_layers`` and ``dec_layers``. Every other subtree is carried as it
is: the hybrid's ``shared_attn``, the audio family's ``enc_final_norm``
and ``dec_pos``; so are a layer's MoE leaves (``router.w`` (d, E);
``gate``, ``up`` (E, d, ff); ``down`` (E, ff, d)), whose expert axis is
not a layer axis. numpy has no native bfloat16, so every array comes
across through float32 numpy and is cast to ``dtype`` on the device, except
the Mamba leaves the reference keeps in float32 whatever the model dtype
(``ssm.FLOAT32_LEAVES``), which stay float32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Params, _check_family
from repro_torch.models.ssm import FLOAT32_LEAVES


def _tensor(a, dtype, device) -> torch.Tensor:
    arr = np.asarray(a).astype(np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _tree(x: Any, dtype, device, parent: str = ""):
    if isinstance(x, dict):
        return {k: _tree(v, _leaf_dtype(parent, k, dtype), device, k)
                for k, v in x.items()}
    return _tensor(x, dtype, device)


def _leaf_dtype(parent: str, key: str, dtype):
    return torch.float32 if parent == "mamba" and key in FLOAT32_LEAVES \
        else dtype


def _layer(x: Any, i: int):
    if isinstance(x, dict):
        return {k: _layer(v, i) for k, v in x.items()}
    return np.asarray(x)[i]


def from_jax_params(params_np, cfg: ModelConfig, dtype=torch.float32,
                    device="cpu") -> Params:
    """The reference's params (numpy leaves) as this port's params: the
    stacked ``layers``, ``enc_layers`` and ``dec_layers`` subtrees become
    lists of per-layer dicts, every other subtree is carried as it is."""
    _check_family(cfg)
    depth = {"layers": cfg.num_layers, "enc_layers": cfg.encoder_layers,
             "dec_layers": cfg.num_layers}             # the stacked subtrees
    return {k: [_tree(_layer(v, i), dtype, device) for i in range(depth[k])]
            if k in depth else _tree(v, dtype, device)
            for k, v in params_np.items()}

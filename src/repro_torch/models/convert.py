"""Weights from the reference package's pytree, so both packages compute the
same function on the same numbers.

The caller hands over the JAX params as numpy arrays (``jax.tree.map(
np.asarray, params)``); nothing here imports JAX. The stacked
``params["layers"]`` subtree (leading layer axis) becomes a list of
per-layer dicts. numpy has no native bfloat16, so every array comes across
through float32 numpy and is cast to ``dtype`` on the device.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Params, _check_family


def _tensor(a, dtype, device) -> torch.Tensor:
    arr = np.asarray(a).astype(np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _tree(x: Any, dtype, device):
    if isinstance(x, dict):
        return {k: _tree(v, dtype, device) for k, v in x.items()}
    return _tensor(x, dtype, device)


def _layer(x: Any, i: int):
    if isinstance(x, dict):
        return {k: _layer(v, i) for k, v in x.items()}
    return np.asarray(x)[i]


def from_jax_params(params_np, cfg: ModelConfig, dtype=torch.float32,
                    device="cpu") -> Params:
    """The reference's params (numpy leaves) as this port's params."""
    _check_family(cfg)
    out = {k: _tree(v, dtype, device) for k, v in params_np.items()
           if k != "layers"}
    out["layers"] = [_tree(_layer(params_np["layers"], i), dtype, device)
                     for i in range(cfg.num_layers)]
    return out

"""Weights between the reference package's pytree and this port's, so both
packages compute the same function on the same numbers.

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

``to_jax_params`` is the inverse: per-layer lists are stacked back into
the reference's layer axis, every leaf a numpy array (float32 for bfloat16
leaves). ``opt_state_from_jax`` and ``opt_state_to_jax`` carry the AdamW
state (``{"mu", "nu", "step"}``, mu and nu float32 trees of the params'
structure) across the same way.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Params, _check_family
from repro_torch.models.ssm import FLOAT32_LEAVES


# the reference's stacked layer subtrees (a leading layer axis)
STACKED = ("layers", "enc_layers", "dec_layers")


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
             "dec_layers": cfg.num_layers}
    return {k: [_tree(_layer(v, i), dtype, device) for i in range(depth[k])]
            if k in depth else _tree(v, dtype, device)
            for k, v in params_np.items()}


def to_numpy(x: Any):
    """A tensor, or a dict tree of them, as numpy on the host (bfloat16 as
    float32: numpy has no bfloat16)."""
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    t = x.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def stack_layers(layers: list):
    """Per-layer dicts -> one dict of numpy arrays with a leading layer
    axis, the reference's layout of a layer stack."""
    if isinstance(layers[0], dict):
        return {k: stack_layers([lp[k] for lp in layers]) for k in layers[0]}
    return np.stack([to_numpy(t) for t in layers])


def to_jax_params(params: Params):
    """This port's params as the reference's pytree of numpy arrays (the
    caller makes JAX arrays of them): each per-layer list stacked into one
    subtree with a leading layer axis."""
    return {k: stack_layers(v) if k in STACKED else to_numpy(v)
            for k, v in params.items()}


def opt_state_from_jax(state_np, cfg: ModelConfig, device="cpu") -> dict:
    """The reference's AdamW state (numpy leaves) as this port's."""
    conv = lambda tree: from_jax_params(tree, cfg, torch.float32, device)
    return {"mu": conv(state_np["mu"]), "nu": conv(state_np["nu"]),
            "step": torch.as_tensor(np.array(state_np["step"]),
                                    dtype=torch.int32, device=device)}


def opt_state_to_jax(state) -> dict:
    """This port's AdamW state as the reference's, numpy leaves."""
    return {"mu": to_jax_params(state["mu"]), "nu": to_jax_params(state["nu"]),
            "step": state["step"].detach().cpu().numpy()}

"""Checkpoints in the reference's format (``repro/training/checkpoint.py``):
one ``.npz`` of the params and optimizer trees flattened to ``params/...``
and ``opt/...`` keys (dict keys sorted) plus a ``.meta.json``. The port's
per-layer lists (``layers``, ``enc_layers``, ``dec_layers``) are stacked
back into the reference's layer axis on save and split again on restore,
so a file written by either package restores in the other. numpy has no bfloat16: such leaves are written as float32
and cast back to the template's dtype on restore.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.convert import (STACKED, opt_state_to_jax,
                                        to_jax_params)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save(path: str, params, opt_state=None,
         meta: Dict[str, Any] = None) -> None:
    """params (the port's tree) and, optionally, the AdamW state, in the
    reference's layout (``convert.to_jax_params``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tree = {"params": to_jax_params(params)}
    if opt_state:
        tree["opt"] = opt_state_to_jax(opt_state)
    np.savez(path, **_flatten(tree))
    with open(path + ".meta.json", "w") as f:
        json.dump(meta or {}, f, indent=2, default=str)


def restore(path: str, params_template,
            opt_template=None) -> Tuple[Any, Any, Dict]:
    """Restore into the structure, dtypes and devices of the templates."""
    meta = {}
    mp = path + ".meta.json"
    if os.path.exists(mp):
        with open(mp) as f:
            meta = json.load(f)
    # an NpzFile reads a member from the archive on every access: each is
    # read once here, since a stacked member is indexed once per layer
    data: Dict[str, np.ndarray] = {}

    def rebuild(template, prefix, layer=None):
        if isinstance(template, dict):
            return {k: (
                [rebuild(lp, f"{prefix}{k}/", i) for i, lp in enumerate(v)]
                if k in STACKED and isinstance(v, list)
                else rebuild(v, f"{prefix}{k}/", layer))
                for k, v in template.items()}
        if isinstance(template, (list, tuple)):
            return type(template)(rebuild(v, f"{prefix}{i}/", layer)
                                  for i, v in enumerate(template))
        key = prefix[:-1]
        if key not in data:
            data[key] = npz[key]
        arr = data[key] if layer is None else data[key][layer]
        return torch.from_numpy(np.array(arr)).to(
            device=template.device, dtype=template.dtype)

    with np.load(path if path.endswith(".npz") else path + ".npz") as npz:
        params = rebuild(params_template, "params/")
        opt = rebuild(opt_template, "opt/") \
            if opt_template is not None else None
    return params, opt, meta

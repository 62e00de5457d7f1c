"""AdamW and its schedule, on the params tree as written in the reference
(``repro/training/optimizer.py``), not ``torch.optim``, so that the updates
are the reference's.

The learning rate and the bias corrections run on float32 tensors, as
JAX's do: ``b1 ** step`` is a float32 power of a float32 step. Weight decay
applies to every leaf. The state is ``{"mu", "nu", "step"}``, mu and nu
float32 trees with the params' structure (the port's per-layer lists
included) and step an int32 scalar.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Tuple

import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> list:
    """Leaves in the reference's order: dict keys sorted (as
    ``jax.tree.leaves`` orders them), lists in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [x for v in tree for x in tree_leaves(v)]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure from leaves in ``tree_leaves``
    order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}        # the template's key order
        return [build(v) for v in node]
    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return [tree_map(fn, v, *(r[i] for r in rest))
            for i, v in enumerate(tree)]


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to min_lr_frac; a float32 scalar on
    ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params) -> dict:
    zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
    dev = tree_leaves(params)[0].device
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over the leaves, in float32. A stacked
    reference leaf is one sum here per layer, so the order of the float
    additions differs from JAX's (float noise)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads,
                  state) -> Tuple[Any, dict, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics); the inputs
    are not modified."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
        mhat = mu / b1c
        nhat = nu / b2c
        delta = mhat / (torch.sqrt(nhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    trip = tree_map(upd, params, grads, state["mu"], state["nu"])
    pick = lambda i: tree_map(lambda _, t: t[i], params, trip)
    return (pick(0), {"mu": pick(1), "nu": pick(2), "step": step},
            {"lr": lr, "grad_norm": gnorm})

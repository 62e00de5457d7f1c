"""Mixture-of-Experts FFN with top-k routing and fixed-capacity dispatch
(counterpart of ``repro/models/moe.py``).

The reference's dispatch, step for step: tokens are sorted by expert id
(a stable argsort), ranked within their expert by a one-hot cumsum, and
scattered into an (E, capacity) buffer; the expert FFNs are one batched
product over the expert axis; results are combined back weighted by the
renormalised router probabilities. Tokens past an expert's capacity are
dropped (Switch/GShard semantics).

Both scatters are ``index_add_``, which adds atomically on the card, in no
fixed order. The result does not depend on that order all the same: a
buffer slot takes one kept token plus exact zeros from dropped ones, and
each output row is zero plus its k = 2 weighted expert outputs, and
floating-point addition is commutative. A change that breaks either fact
needs a deterministic scatter.

A sigmoid router (``moe.router == "sigmoid"``, Nemotron-H) takes the
dropless grouped path instead (``moe_apply_sigmoid``): scores =
sigmoid(x W_r) in float32, the top k of scores + a correction bias (which
only selects), the chosen scores normalised and scaled; the (token,
choice) rows sorted by expert on the device and only those computed
(``ops.moe_experts``: K7 on the card), each token's k outputs summed in
a fixed order, plus a shared expert. Tokens of dead lanes route to no
expert. Expert weights: ``w_up`` (E, f, d) and ``w_down`` (E, d, f), each
expert's rows its output channels.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import moe_experts as ME
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.serving.trace import span

NUM_DISPATCH_GROUPS = 16     # the reference's data-axis groups


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    E, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    scale = d ** -0.5
    if cfg.moe.router == "sigmoid":
        return _sigmoid_init(gen, cfg, dtype, device)
    p = {"router": {"w": L._normal(gen, (d, E), scale, dtype, device)},
         "up": L._normal(gen, (E, d, ff), scale, dtype, device),
         "down": L._normal(gen, (E, ff, d), ff ** -0.5, dtype, device)}
    if cfg.activation in ("swiglu", "geglu"):
        p["gate"] = L._normal(gen, (E, d, ff), scale, dtype, device)
    return p


def _route(params, cfg: ModelConfig, xt: torch.Tensor):
    """Router probabilities (..., E) float32 and the top-k gates (renormalised)
    and expert ids (..., k)."""
    logits = (xt @ params["router"]["w"]).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.moe.num_experts_per_tok,
                                       dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, expert_idx


def _aux_loss(cfg: ModelConfig, probs: torch.Tensor,
              top1: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss: probs (T, E), top1 (T,) expert ids."""
    E = cfg.moe.num_experts
    me = probs.mean(dim=0)
    ce = F.one_hot(top1, E).float().mean(dim=0)
    return E * torch.sum(me * ce) * cfg.moe.router_aux_loss_coef


def _dispatch(xt: torch.Tensor, expert_idx: torch.Tensor,
              gate_vals: torch.Tensor, E: int, C: int):
    """Tokens xt (T, d) into an (E, C, d) buffer by expert; returns the
    buffer and what the combine needs (slot, token, gate, keep per
    (token, choice), sorted by expert)."""
    T, d = xt.shape
    k = expert_idx.shape[-1]
    flat_expert = expert_idx.reshape(-1)                          # (T*k,)
    flat_gate = gate_vals.reshape(-1)
    flat_token = torch.arange(T, device=xt.device).repeat_interleave(k)
    order = torch.argsort(flat_expert, stable=True)               # group by expert
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_gate = flat_gate[order]
    # rank within the expert's group
    same = torch.cumsum(F.one_hot(sorted_expert, E), dim=0)
    rank = same.gather(1, sorted_expert[:, None])[:, 0] - 1
    keep = rank < C
    slot = sorted_expert * C + torch.where(keep, rank, 0)
    src = xt[sorted_token] * keep[:, None].to(xt.dtype)
    buf = torch.zeros((E * C, d), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, slot, src)              # one kept token per slot
    return buf.reshape(E, C, d), (slot, sorted_token, sorted_gate, keep)


def _experts(params, buf: torch.Tensor, spec: str) -> torch.Tensor:
    """The expert FFNs over a dispatched buffer; ``spec`` names its axes
    before the model axis (``"ec"`` or ``"gec"``)."""
    up = torch.einsum(f"{spec}d,edf->{spec}f", buf, params["up"])
    if "gate" in params:
        h = F.silu(torch.einsum(f"{spec}d,edf->{spec}f", buf,
                                params["gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")    # jax.nn.gelu's default
    return torch.einsum(f"{spec}f,efd->{spec}d", h, params["down"])


def _combine(out: torch.Tensor, meta, T: int) -> torch.Tensor:
    """Expert outputs (E*C, d) back to (T, d), weighted by the gates."""
    slot, sorted_token, sorted_gate, keep = meta
    gathered = out[slot] * (sorted_gate * keep).to(out.dtype)[:, None]
    y = torch.zeros((T, out.shape[-1]), dtype=out.dtype, device=out.device)
    return y.index_add_(0, sorted_token, gathered)   # k terms onto zero


def moe_apply(params, cfg: ModelConfig, x: torch.Tensor, *,
              dropless: bool = False):
    """x: (B, S, d) -> (y (B, S, d), aux_loss). Fixed-capacity top-k
    dispatch with C = int(capacity_factor * T * k / E) slots per expert;
    ``dropless`` sets C = T (no token is dropped), as decode and the paged
    chunks use. ``REPRO_MOE_DISPATCH=grouped`` routes capacity dispatch of
    T >= 4096 tokens per group of tokens, as in the reference."""
    mcfg = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = mcfg.num_experts, mcfg.num_experts_per_tok
    if (os.environ.get("REPRO_MOE_DISPATCH", "global") == "grouped"
            and not dropless and T >= 4096):
        return _moe_apply_grouped(params, cfg, x)
    C = T if dropless else max(1, min(T, int(mcfg.capacity_factor * T * k / E)))

    xt = x.reshape(T, d)
    probs, gate_vals, expert_idx = _route(params, cfg, xt)
    aux = _aux_loss(cfg, probs, expert_idx[:, 0])
    buf, meta = _dispatch(xt, expert_idx, gate_vals, E, C)
    out = _experts(params, buf, "ec").reshape(E * C, d)
    return _combine(out, meta, T).reshape(B, S, d), aux


def _moe_apply_grouped(params, cfg: ModelConfig, x: torch.Tensor):
    """Group-local dispatch: the sort and capacity machinery per group of
    Tg = T / G tokens, with Cg = int(capacity_factor * Tg * k / E) slots
    per expert and group; one expert product over all groups' buffers."""
    mcfg = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = mcfg.num_experts, mcfg.num_experts_per_tok
    G = min(NUM_DISPATCH_GROUPS, T)
    while T % G:
        G //= 2
    Tg = T // G
    Cg = max(1, min(Tg, int(mcfg.capacity_factor * Tg * k / E)))

    xt = x.reshape(G, Tg, d)
    probs, gate_vals, expert_idx = _route(params, cfg, xt)         # (G, Tg, .)
    aux = _aux_loss(cfg, probs.reshape(T, E), expert_idx[..., 0].reshape(T))
    groups = [_dispatch(xt[g], expert_idx[g], gate_vals[g], E, Cg)
              for g in range(G)]
    buf = torch.stack([b for b, _ in groups])                      # (G,E,Cg,d)
    out = _experts(params, buf, "gec")
    y = torch.stack([_combine(out[g].reshape(E * Cg, d), meta, Tg)
                     for g, (_, meta) in enumerate(groups)])
    return y.reshape(B, S, d), aux


# --------------------------------------------------- sigmoid router, dropless
def _sigmoid_init(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    m = cfg.moe
    E, d, ff = m.num_experts, cfg.d_model, cfg.d_ff
    p = {"router": {"w": L._normal(gen, (d, E), d ** -0.5, dtype, device)},
         "w_up": L._normal(gen, (E, ff, d), d ** -0.5, dtype, device),
         "w_down": L._normal(gen, (E, d, ff), ff ** -0.5, dtype, device)}
    if m.score_bias:
        p["router"]["bias"] = torch.zeros((E,), dtype=torch.float32,
                                          device=device)
    if m.shared_expert_dim:
        fs = m.shared_expert_dim
        p["shared"] = {"up": L.dense_init(gen, d, fs, dtype, device),
                       "down": L.dense_init(gen, fs, d, dtype, device)}
    return p


def route_sigmoid(params, cfg: ModelConfig, xt: torch.Tensor):
    """xt (T, d) -> (expert ids (T, k), weights (T, k) float32): the top k
    of sigmoid(x W_r) + bias, weighted by their scores, normalised and
    scaled."""
    m = cfg.moe
    scores = torch.sigmoid(xt.float() @ params["router"]["w"].float())
    sel = scores + params["router"]["bias"] if "bias" in params["router"] \
        else scores
    idx = torch.topk(sel, m.num_experts_per_tok, dim=-1).indices
    w = scores.gather(1, idx)
    if m.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, w * m.routed_scale


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x).square()


def moe_apply_sigmoid(params, cfg: ModelConfig, x: torch.Tensor, *,
                      live: Optional[torch.Tensor] = None,
                      backend: str = "auto"):
    """x (B, S, d) -> (y (B, S, d), routed rows, experts touched), the
    counts 0-d device tensors. Dropless: every routed row is computed.
    ``live`` (B,) bool: a lane that is not live routes to no expert and its
    routed output is 0; (B, S) bool: the same per token (a padded prompt's
    pads)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    with span("moe.route"):
        idx, w = route_sigmoid(params, cfg, xt)
        tok_live = None if live is None else live.reshape(T) \
            if live.dim() == 2 else live.repeat_interleave(S)
        routes = ME.route_table(idx, w, cfg.moe.num_experts, tok_live)
    with span("moe.experts"):
        out = ops.moe_experts(xt, params["w_up"], params["w_down"], routes,
                              backend=backend)
    with span("moe.combine"):
        y = out.view(T, -1, d).sum(dim=1)          # the k slots, in order
        if "shared" in params:
            sp = params["shared"]
            y = y + L.linear(sp["down"], _relu2(L.linear(sp["up"], xt))
                             ).float()
        y = y.to(x.dtype).reshape(B, S, d)
    return y, routes.offsets[-1], ME.experts_touched(routes)

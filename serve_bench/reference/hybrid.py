"""Plain float32 reference of the Mamba2 + shared-attention hybrid
(zamba2-1.2b, arXiv:2411.15242) as the served package arranges it:
``num_layers`` Mamba2 blocks (pre-RMSNorm, residual) and, after every
``hybrid_attn_every`` of them, one shared transformer block (RMSNorm,
RoPE'd attention with a causal window, residual, RMSNorm, a tanh-GELU MLP
with biases, residual) whose weights every use shares.

A Mamba2 block: [z | x] and [B | C] and one step size per head are
projections of the normed input; a causal depthwise conv (width
``conv_width``, bias) and SiLU run over (x, B, C); dt = softplus(dt +
dt_bias), A = -exp(A_log); the SSD recurrence per head
    state_t = exp(dt_t A) state_{t-1} + dt_t x_t B_tᵀ,   y_t = state_t C_t
(B and C shared by the heads) is computed chunk by chunk in its exact
quadratic form, the cumulative decays in float64; then y + D x, a
gated RMSNorm of y * silu(z), and the output projection.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from serve_bench.reference import common as C

CHUNK = 64


def _dims(m: Dict):
    s = m["ssm"]
    d = m["d_model"]
    di = s["expand"] * d
    return d, di, s["state_dim"], di // s["head_dim"], s["head_dim"], \
        s["conv_width"]


def make_weights(m: Dict, gen: torch.Generator, dtype, device) -> Dict:
    if m["activation"] != "gelu" or m.get("norm", "rmsnorm") != "rmsnorm":
        raise ValueError("the hybrid reference's shared MLP is tanh-GELU")
    d, di, N, H, P, W = _dims(m)
    f = m["d_ff"]
    hd = m.get("head_dim") or d // m["num_heads"]
    ch = di + 2 * N
    leaves = C.head_leaves(m)
    for i in range(m["num_layers"]):
        p = ("layers", str(i))
        mb = p + ("mamba",)
        leaves += [(p + ("norm", "scale"), (d,), "scale", 0.1),
                   (mb + ("zx_proj", "w"), (d, 2 * di), "normal", d ** -0.5),
                   (mb + ("bc_proj", "w"), (d, 2 * N), "normal", d ** -0.5),
                   (mb + ("dt_proj", "w"), (d, H), "normal", d ** -0.5),
                   (mb + ("conv_w",), (W, ch), "normal", 0.2),
                   (mb + ("conv_b",), (ch,), "zeros", 0.0),
                   (mb + ("gate_norm", "scale"), (di,), "scale", 0.1),
                   (mb + ("out_proj", "w"), (di, d), "normal", di ** -0.5)]
    sa = ("shared_attn",)
    leaves += [(sa + ("attn_norm", "scale"), (d,), "scale", 0.1)]
    leaves += C.attn_leaves(sa + ("attn",), d, m["num_heads"],
                            m["num_kv_heads"], hd)
    leaves += [(sa + ("mlp_norm", "scale"), (d,), "scale", 0.1),
               (sa + ("mlp", "up", "w"), (d, f), "normal", d ** -0.5),
               (sa + ("mlp", "up", "b"), (f,), "zeros", 0.0),
               (sa + ("mlp", "down", "w"), (f, d), "normal", f ** -0.5),
               (sa + ("mlp", "down", "b"), (d,), "zeros", 0.0)]
    w = C.draw(leaves, gen, dtype, device)
    C.listify(w, "layers", m["num_layers"])
    # the decay rates, skips and step-size biases are float32 leaves
    fl = dict(dtype=torch.float32, device=device)
    extra = torch.rand((m["num_layers"], H), generator=gen, **fl) * 3.0 - 4.0
    for i, lp in enumerate(w["layers"]):
        lp["mamba"]["A_log"] = torch.log(torch.linspace(1.0, 16.0, H, **fl))
        lp["mamba"]["D"] = torch.ones((H,), **fl)
        lp["mamba"]["dt_bias"] = extra[i].clone()
    return w


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """x (S, H, P), dt (S, H), A (H,), Bm/Cm (S, N) -> y (S, H, P), from a
    zero state."""
    S, H, P = x.shape
    state = x.new_zeros((H, P, Bm.shape[1]))
    ys = []
    for a in range(0, S, CHUNK):
        b = min(S, a + CHUNK)
        xs, dts, Bs, Cs = x[a:b], dt[a:b], Bm[a:b], Cm[a:b]
        cum = torch.cumsum((dts * A).double(), dim=0)             # (l, H)
        seg = cum[:, None, :] - cum[None, :, :]                    # (i, j, H)
        l = b - a
        causal = torch.ones((l, l), dtype=torch.bool,
                            device=x.device).tril()[:, :, None]
        decay = torch.exp(seg.masked_fill(~causal, -math.inf)).float()
        wgt = (Cs @ Bs.T)[:, :, None] * decay * dts[None, :, :]  # (i, j, H)
        y = torch.einsum("ijh,jhp->ihp", wgt, xs)
        y = y + torch.exp(cum).float()[:, :, None] * torch.einsum(
            "in,hpn->ihp", Cs, state)
        ys.append(y)
        tot = cum[-1]
        carry = torch.exp(tot[None, :] - cum).float() * dts        # (j, H)
        state = torch.exp(tot).float()[:, None, None] * state + torch.einsum(
            "jhp,jn->hpn", xs * carry[:, :, None], Bs)
    return torch.cat(ys, dim=0)


def _mamba(mp: Dict, m: Dict, x: torch.Tensor,
           quant: Optional[str]) -> torch.Tensor:
    d, di, N, H, P, W = _dims(m)
    S = x.shape[0]
    z, xb = C.linear(x, mp["zx_proj"]["w"], quant=quant).split([di, di], -1)
    bc = C.linear(x, mp["bc_proj"]["w"], quant=quant)
    dt = C.linear(x, mp["dt_proj"]["w"], quant=quant)
    u = torch.cat([xb, bc], dim=-1)                                # (S, ch)
    up = torch.cat([u.new_zeros((W - 1, u.shape[1])), u], dim=0)
    conv = mp["conv_b"] + sum(mp["conv_w"][k] * up[k:k + S]
                              for k in range(W))
    conv = F.silu(conv)
    xb, Bm, Cm = conv.split([di, N, N], dim=-1)
    dt = torch.logaddexp(dt + mp["dt_bias"], torch.zeros_like(dt))  # softplus
    A = -torch.exp(mp["A_log"])
    xh = xb.view(S, H, P)
    y = ssd(xh, dt, A, Bm, Cm) + mp["D"][None, :, None] * xh
    y = C.rmsnorm(y.reshape(S, di) * F.silu(z), mp["gate_norm"]["scale"])
    return C.linear(y, mp["out_proj"]["w"], quant=quant)


def _shared(sp: Dict, m: Dict, h: torch.Tensor, pos: torch.Tensor,
            quant: Optional[str]) -> torch.Tensor:
    a = C.rmsnorm(h, sp["attn_norm"]["scale"])
    h = h + C.self_attention(sp["attn"], a, pos, heads=m["num_heads"],
                             kv_heads=m["num_kv_heads"],
                             theta=m.get("rope_theta", 10000.0),
                             window=m.get("sliding_window"), quant=quant)
    x = C.rmsnorm(h, sp["mlp_norm"]["scale"])
    mp = sp["mlp"]
    u = F.gelu(C.linear(x, mp["up"]["w"], mp["up"]["b"], quant),
               approximate="tanh")
    return h + C.linear(u, mp["down"]["w"], mp["down"]["b"], quant)


@torch.no_grad()
def forward(w: Dict, m: Dict, seqs: List[torch.Tensor], starts: List[int],
            quant: Optional[str] = None) -> List[torch.Tensor]:
    """seqs: 1-D int token tensors on the weights' device. Returns, per
    sequence, float32 logits (S - start, V) of rows start..S-1."""
    C.no_tf32()
    hs = [C.f32(w["embed"]["emb"][s.long()]) for s in seqs]
    pos = [torch.arange(s.shape[0], device=s.device) for s in seqs]
    every = m.get("hybrid_attn_every", 0)
    shared = C.to_f32(w["shared_attn"]) if every else None
    for i, lp in enumerate(w["layers"]):
        lf = C.to_f32(lp)
        hs = [h + _mamba(lf["mamba"], m, C.rmsnorm(h, lf["norm"]["scale"]),
                         quant) for h in hs]
        del lf
        if every and (i + 1) % every == 0:
            hs = [_shared(shared, m, h, p, quant) for h, p in zip(hs, pos)]
    return [C.logits(w, m, h[st:], quant) for h, st in zip(hs, starts)]

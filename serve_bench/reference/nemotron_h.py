"""Plain float32 reference of a Nemotron-H hybrid (Nemotron-3-Nano-30B-A3B,
hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16): token embedding, then one
block per character of ``block_pattern``, each h + mixer(RMSNorm(h)) with
weights of its own, then the final RMSNorm and an untied unembedding.

  M  Mamba2: [z | x] and [B | C] (G groups of N each) and one step size
     per head are projections of the normed input; a causal depthwise conv
     (width ``conv_width``, bias) and SiLU over (x, B, C); dt = softplus(dt
     + dt_bias), A = -exp(A_log); per head h, with B and C of group
     h // (H / G),
         state_t = exp(dt_t A) state_{t-1} + dt_t x_t B_tᵀ,  y_t = state_t C_t
     computed chunk by chunk in its exact quadratic form, the cumulative
     decays in float64; then y + D x, an RMSNorm of y * silu(z) over each
     group of d_inner / G channels, and the output projection.
  *  GQA attention, causal, with no positional encoding (NoPE, as in
     Nemotron-H, arXiv:2504.03624) and no MLP.
  E  MoE: scores = sigmoid(x W_r); the top k of scores + b (b, the
     correction bias, only selects); weights = the chosen scores,
     normalised to sum 1 and times ``routed_scale``; the output is
     Σ w_i down_i(relu(up_i x)²) plus the shared expert's
     down(relu(up x)²).

The weights follow the served package's layout (``common``), the experts
as (E, f, d) up and (E, d, f) down: each expert's rows are its output
channels. ``make_weights`` draws one layer at a time (no single draw
passes 2^31 elements); ``forward`` computes a layer at a time over all the
given sequences, so it fits beside the bf16 weights on one card.

The draw's scales: embeddings N(0, 0.02) and norm gains 1 + N(0, 0.1), as
for the other cells; every block's output projection (Mamba's out_proj,
attention's o, the shared expert's down) N(0, 1/fan_in) / sqrt(2 · blocks),
the residual-scaled init of GPT-2 and Megatron (Nemotron-H's config sets
``rescale_prenorm_residual``); every other weight N(0, 1/fan_in). A layer's
routed experts are one draw they share plus SPREAD = a tenth of a draw of
each one's own (as experts start after sparse upcycling, arXiv:2212.05055),
their down projections over ``routed_scale``: the chosen weights sum to
``routed_scale``, so the routed sum is a block's output at full scale, and
a token's choices move it by the experts' own tenth. Experts drawn each on
their own make top-k routing of random weights chaotic: near-ties among
the sigmoid scores flip on any rounding, each flip moves the layer's output
as much as the layer itself, and through 23 routers the float32 reference
moved by one bf16 step in its input serves tokens a mean 1.35-1.69 logits
below its own best (PERF.md), so no limit could tell a sound bf16 program
from the int8 control. Here a flip moves little, while a routed row lost,
a gate left unnormalised or a lane's live bit wrong moves the layer's
output by a share of a whole block.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from serve_bench.reference import common as C

CHUNK = 64
SPREAD = 0.1          # each routed expert's own part, of the shared draw


def _dims(m: Dict):
    s = m["ssm"]
    P = s["head_dim"]
    H = s.get("num_heads") or s["expand"] * m["d_model"] // P
    return m["d_model"], H * P, s["state_dim"], s.get("n_groups", 1), H, P, \
        s["conv_width"]


def _layer_leaves(m: Dict, i: int, kind: str) -> List[C.Leaf]:
    d = m["d_model"]
    r = (2 * len(m["block_pattern"])) ** -0.5
    p = ("layers", str(i))
    out = [(p + ("norm", "scale"), (d,), "scale", 0.1)]
    if kind == "M":
        _, di, N, G, H, _, W = _dims(m)
        mb = p + ("mamba",)
        ch = di + 2 * G * N
        out += [(mb + ("zx_proj", "w"), (d, 2 * di), "normal", d ** -0.5),
                (mb + ("bc_proj", "w"), (d, 2 * G * N), "normal", d ** -0.5),
                (mb + ("dt_proj", "w"), (d, H), "normal", d ** -0.5),
                (mb + ("conv_w",), (W, ch), "normal", 0.2),
                (mb + ("conv_b",), (ch,), "zeros", 0.0),
                (mb + ("gate_norm", "scale"), (di,), "scale", 0.1),
                (mb + ("out_proj", "w"), (di, d), "normal", di ** -0.5 * r)]
    elif kind == "E":
        mo, f = m["moe"], m["d_ff"]
        E, fs = mo["num_experts"], mo.get("shared_expert_dim", 0)
        e = p + ("moe",)
        down = f ** -0.5 * r / mo["routed_scale"]
        out += [(e + ("router", "w"), (d, E), "normal", d ** -0.5),
                (e + ("w_up",), (E, f, d), "normal", d ** -0.5 * SPREAD),
                (e + ("w_down",), (E, d, f), "normal", down * SPREAD),
                (e + ("up_shared",), (f, d), "normal", d ** -0.5),
                (e + ("down_shared",), (d, f), "normal", down)]
        if fs:
            out += [(e + ("shared", "up", "w"), (d, fs), "normal", d ** -0.5),
                    (e + ("shared", "down", "w"), (fs, d), "normal",
                     fs ** -0.5 * r)]
    else:
        hd = m.get("head_dim") or d // m["num_heads"]
        out += [(path, shape, kind_, sc * (r if path[-2] == "o" else 1.0))
                for path, shape, kind_, sc in C.attn_leaves(
                    p + ("attn",), d, m["num_heads"], m["num_kv_heads"], hd)]
    return out


def make_weights(m: Dict, gen: torch.Generator, dtype, device) -> Dict:
    pattern = m["block_pattern"]
    if m["activation"] != "relu2" or m.get("pos_emb") != "none" or \
            m.get("norm", "rmsnorm") != "rmsnorm" or \
            m["moe"].get("router") != "sigmoid":
        raise ValueError("the Nemotron-H reference is RMSNorm, NoPE "
                         "attention and sigmoid-routed relu² experts")
    w = C.draw(C.head_leaves(m), gen, dtype, device)
    w["layers"] = []
    fl = dict(dtype=torch.float32, device=device)
    for i, kind in enumerate(pattern):
        lp = C.draw(_layer_leaves(m, i, kind), gen, dtype, device)
        lp = lp["layers"][str(i)]
        if kind == "M":
            H = _dims(m)[4]
            # the decay rates, skips and step-size biases are float32 leaves
            lp["mamba"]["A_log"] = torch.log(torch.linspace(1.0, 16.0, H,
                                                            **fl))
            lp["mamba"]["D"] = torch.ones((H,), **fl)
            lp["mamba"]["dt_bias"] = torch.rand((H,), generator=gen,
                                                **fl) * 3.0 - 4.0
        elif kind == "E":
            mo = lp["moe"]
            # each expert: the shared draw plus its own (in place)
            mo["w_up"].add_(mo.pop("up_shared")[None])
            mo["w_down"].add_(mo.pop("down_shared")[None])
            if m["moe"].get("score_bias"):
                mo["router"]["bias"] = torch.zeros(
                    (m["moe"]["num_experts"],), **fl)
        w["layers"].append(lp)
    return w


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """x (S, H, P), dt (S, H), A (H,), Bm/Cm (S, G, N), head h reading group
    h // (H / G) -> y (S, H, P), from a zero state."""
    S, H, P = x.shape
    Bh = Bm.repeat_interleave(H // Bm.shape[1], dim=1)          # (S, H, N)
    Ch = Cm.repeat_interleave(H // Cm.shape[1], dim=1)
    state = x.new_zeros((H, P, Bm.shape[2]))
    ys = []
    for a in range(0, S, CHUNK):
        b = min(S, a + CHUNK)
        xs, dts, Bs, Cs = x[a:b], dt[a:b], Bh[a:b], Ch[a:b]
        cum = torch.cumsum((dts * A).double(), dim=0)             # (l, H)
        seg = cum[:, None, :] - cum[None, :, :]                    # (i, j, H)
        l = b - a
        causal = torch.ones((l, l), dtype=torch.bool,
                            device=x.device).tril()[:, :, None]
        decay = torch.exp(seg.masked_fill(~causal, -math.inf)).float()
        cb = torch.einsum("ihn,jhn->ijh", Cs, Bs)
        wgt = cb * decay * dts[None, :, :]                         # (i, j, H)
        y = torch.einsum("ijh,jhp->ihp", wgt, xs)
        y = y + torch.exp(cum).float()[:, :, None] * torch.einsum(
            "ihn,hpn->ihp", Cs, state)
        ys.append(y)
        tot = cum[-1]
        carry = torch.exp(tot[None, :] - cum).float() * dts        # (j, H)
        state = torch.exp(tot).float()[:, None, None] * state + torch.einsum(
            "jhp,jhn->hpn", xs * carry[:, :, None], Bs)
    return torch.cat(ys, dim=0)


def _mamba(mp: Dict, m: Dict, x: torch.Tensor,
           quant: Optional[str]) -> torch.Tensor:
    d, di, N, G, H, P, W = _dims(m)
    S = x.shape[0]
    z, xb = C.linear(x, mp["zx_proj"]["w"], quant=quant).split([di, di], -1)
    bc = C.linear(x, mp["bc_proj"]["w"], quant=quant)
    dt = C.linear(x, mp["dt_proj"]["w"], quant=quant)
    u = torch.cat([xb, bc], dim=-1)                                # (S, ch)
    up = torch.cat([u.new_zeros((W - 1, u.shape[1])), u], dim=0)
    conv = mp["conv_b"] + sum(mp["conv_w"][k] * up[k:k + S]
                              for k in range(W))
    conv = F.silu(conv)
    xb, Bm, Cm = conv.split([di, G * N, G * N], dim=-1)
    dt = torch.logaddexp(dt + mp["dt_bias"], torch.zeros_like(dt))  # softplus
    A = -torch.exp(mp["A_log"])
    xh = xb.view(S, H, P)
    y = ssd(xh, dt, A, Bm.view(S, G, N), Cm.view(S, G, N)) \
        + mp["D"][None, :, None] * xh
    g = (y.reshape(S, di) * F.silu(z)).view(S, G, di // G)
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + C.EPS)
    y = g.reshape(S, di) * mp["gate_norm"]["scale"]
    return C.linear(y, mp["out_proj"]["w"], quant=quant)


def _attention(ap: Dict, m: Dict, x: torch.Tensor,
               quant: Optional[str]) -> torch.Tensor:
    S = x.shape[0]
    q = C.linear(x, ap["q"]["w"], quant=quant).view(S, m["num_heads"], -1)
    k = C.linear(x, ap["k"]["w"], quant=quant).view(S, m["num_kv_heads"], -1)
    v = C.linear(x, ap["v"]["w"], quant=quant).view(S, m["num_kv_heads"], -1)
    o = C.attention(q, k, v, m.get("sliding_window")).reshape(S, -1)
    return C.linear(o, ap["o"]["w"], quant=quant)


def route(mp: Dict, m: Dict, x: torch.Tensor, quant: Optional[str] = None):
    """x (T, d) -> (expert ids (T, k), weights (T, k))."""
    mo = m["moe"]
    scores = torch.sigmoid(C.linear(x, mp["router"]["w"], quant=quant))
    sel = scores + mp["router"]["bias"] if "bias" in mp["router"] else scores
    idx = torch.topk(sel, mo["num_experts_per_tok"], dim=-1).indices
    wts = scores.gather(1, idx)
    if mo.get("norm_topk_prob", True):
        wts = wts / (wts.sum(-1, keepdim=True) + 1e-20)
    return idx, wts * mo.get("routed_scale", 1.0)


def _moe(mp: Dict, m: Dict, x: torch.Tensor,
         quant: Optional[str]) -> torch.Tensor:
    """x (T, d), every sequence's tokens together."""
    idx, wts = route(mp, m, x, quant)
    y = torch.zeros_like(x)
    for e in range(m["moe"]["num_experts"]):
        tok, j = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = torch.relu(C.linear(x[tok], mp["w_up"][e].T, quant=quant)) ** 2
        out = C.linear(h, mp["w_down"][e].T, quant=quant)
        y.index_add_(0, tok, out * wts[tok, j][:, None])
    if "shared" in mp:
        sp = mp["shared"]
        h = torch.relu(C.linear(x, sp["up"]["w"], quant=quant)) ** 2
        y = y + C.linear(h, sp["down"]["w"], quant=quant)
    return y


@torch.no_grad()
def forward(w: Dict, m: Dict, seqs: List[torch.Tensor], starts: List[int],
            quant: Optional[str] = None) -> List[torch.Tensor]:
    """seqs: 1-D int token tensors on the weights' device. Returns, per
    sequence, float32 logits (S - start, V) of rows start..S-1."""
    C.no_tf32()
    if not seqs:
        return []
    hs = [C.f32(w["embed"]["emb"][s.long()]) for s in seqs]
    lens = [h.shape[0] for h in hs]
    for kind, lp in zip(m["block_pattern"], w["layers"]):
        lf = C.to_f32(lp)
        xs = [C.rmsnorm(h, lf["norm"]["scale"]) for h in hs]
        if kind == "M":
            ys = [_mamba(lf["mamba"], m, x, quant) for x in xs]
        elif kind == "*":
            ys = [_attention(lf["attn"], m, x, quant) for x in xs]
        else:
            ys = list(_moe(lf["moe"], m, torch.cat(xs), quant).split(lens))
        hs = [h + y for h, y in zip(hs, ys)]
        del lf
    return [C.logits(w, m, h[st:], quant) for h, st in zip(hs, starts)]

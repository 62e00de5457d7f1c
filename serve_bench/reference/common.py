"""Plain float32 building blocks of the references: RMSNorm, split-half
RoPE, causal GQA attention with a sliding window, the linear layer, and
the seeded weight draw.

Nothing here imports the system under test. The weights follow the
served package's parameter layout (nested dicts, linear weights laid out
(in, out)), because the benchmark hands the very same tensors to both
sides; everything computed from them is worked out here again.

``quant="int8"`` is the correctness control: every linear layer runs on
int8 operands (weights per output channel, activations per row, scales
absmax / 127), the step below the bfloat16 that the configurations state.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

EPS = 1e-5


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def no_tf32() -> None:
    """float32 products stay float32 on the card (TF32 is a lower
    precision than the reference states)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * scale


def _int8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to int8 steps along ``dim`` (symmetric, absmax / 127)."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 127.0
    return torch.clamp(torch.round(x / s), -127, 127) * s


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           quant: Optional[str] = None) -> torch.Tensor:
    """x (..., in) @ w (in, out) [+ b], float32."""
    if quant == "int8":
        x = _int8(x, -1)
        w = _int8(w, 0)
    elif quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    y = x @ w
    return y if b is None else y + b


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D), pos (S,): the first and second halves of D rotate as
    pairs (split-half convention)."""
    half = x.shape[-1] // 2
    inv = theta ** -(torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = (pos.to(torch.float64)[:, None] * inv)[:, None, :]      # (S, 1, half)
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int], block: int = 256) -> torch.Tensor:
    """Causal attention over one sequence. q (S, Hq, D), k/v (S, Hkv, D);
    query i sees key j iff j <= i and i - j < window. Queries go in blocks
    so the scores stay small."""
    S, Hq, D = q.shape
    g = Hq // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).transpose(0, 1)            # (Hq, S, D)
    vv = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    kpos = torch.arange(S, device=q.device)
    for a in range(0, S, block):
        b = min(S, a + block)
        qb = q[a:b].transpose(0, 1) / math.sqrt(D)                # (Hq, n, D)
        s = qb @ kk.transpose(1, 2)                               # (Hq, n, S)
        qpos = torch.arange(a, b, device=q.device)[:, None]
        ok = kpos[None] <= qpos
        if window is not None:
            ok &= (qpos - kpos[None]) < window
        s = s.masked_fill(~ok, float("-inf"))
        out[a:b] = (torch.softmax(s, dim=-1) @ vv).transpose(0, 1)
    return out


def self_attention(lp: Dict, x: torch.Tensor, pos: torch.Tensor, *,
                   heads: int, kv_heads: int, theta: float,
                   window: Optional[int], quant: Optional[str]) -> torch.Tensor:
    """RoPE'd GQA with its projections; ``lp`` holds float32 q/k/v/o."""
    S = x.shape[0]
    q = linear(x, lp["q"]["w"], lp["q"].get("b"), quant).view(S, heads, -1)
    k = linear(x, lp["k"]["w"], lp["k"].get("b"), quant).view(S, kv_heads, -1)
    v = linear(x, lp["v"]["w"], lp["v"].get("b"), quant).view(S, kv_heads, -1)
    q, k = rope(q, pos, theta), rope(k, pos, theta)
    o = attention(q, k, v, window).reshape(S, -1)
    return linear(o, lp["o"]["w"], lp["o"].get("b"), quant)


def to_f32(tree):
    """A float32 copy of a (nested) parameter subtree."""
    if isinstance(tree, torch.Tensor):
        return f32(tree)
    return {k: to_f32(v) for k, v in tree.items()}


# ------------------------------------------------------------------ weights
# A leaf: (path, shape, kind, scale). kind "normal": N(0, 1) * scale;
# "scale": 1 + scale * N(0, 1) (a norm's gain); "zeros".
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, float]


def draw(leaves: List[Leaf], gen: torch.Generator, dtype,
         device) -> Dict:
    """Every normal and gain leaf as a view of ONE seeded normal draw in
    ``dtype`` on ``device``, scaled in place; zeros apart."""
    n = sum(math.prod(s) for _, s, kind, _ in leaves if kind != "zeros")
    flat = torch.randn((n,), generator=gen, dtype=dtype, device=device)
    tree: Dict = {}
    at = 0
    for path, shape, kind, scale in leaves:
        if kind == "zeros":
            t = torch.zeros(shape, dtype=dtype, device=device)
        else:
            k = math.prod(shape)
            t = flat[at:at + k].view(shape)
            at += k
            t.mul_(scale)
            if kind == "scale":
                t.add_(1.0)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = t
    return tree


def listify(tree: Dict, key: str, n: int) -> None:
    """tree[key] {"0": ..., "1": ...} -> a list of n per-layer dicts."""
    tree[key] = [tree[key][str(i)] for i in range(n)]


def attn_leaves(prefix, d: int, heads: int, kv_heads: int,
                hd: int) -> List[Leaf]:
    return [(prefix + ("q", "w"), (d, heads * hd), "normal", d ** -0.5),
            (prefix + ("k", "w"), (d, kv_heads * hd), "normal", d ** -0.5),
            (prefix + ("v", "w"), (d, kv_heads * hd), "normal", d ** -0.5),
            (prefix + ("o", "w"), (heads * hd, d), "normal",
             (heads * hd) ** -0.5)]


def head_leaves(m: Dict) -> List[Leaf]:
    d, V = m["d_model"], m["vocab_size"]
    out = [(("embed", "emb"), (V, d), "normal", 0.02),
           (("final_norm", "scale"), (d,), "scale", 0.1)]
    if not m.get("tie_embeddings", False):
        out.append((("unembed", "w"), (d, V), "normal", d ** -0.5))
    return out


def logits(w: Dict, m: Dict, h: torch.Tensor, quant: Optional[str]):
    h = rmsnorm(h, f32(w["final_norm"]["scale"]))
    if m.get("tie_embeddings", False):
        return linear(h, f32(w["embed"]["emb"]).T, quant=quant)
    return linear(h, f32(w["unembed"]["w"]), quant=quant)

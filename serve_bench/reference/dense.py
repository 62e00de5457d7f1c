"""Plain float32 reference of a dense decoder: token embedding, then per
layer RMSNorm, GQA self attention with split-half RoPE and a causal
sliding window, a residual, RMSNorm, a SwiGLU MLP, a residual; then the
final RMSNorm and the unembedding (mistral-7b, arXiv:2310.06825).

``make_weights`` draws the weights in the served package's layout;
``forward`` computes, a layer at a time over all the given sequences,
the logits of each sequence from row ``start`` on.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from serve_bench.reference import common as C


def make_weights(m: Dict, gen: torch.Generator, dtype, device) -> Dict:
    if m["activation"] != "swiglu" or m.get("qkv_bias") or \
            m.get("norm", "rmsnorm") != "rmsnorm":
        raise ValueError("the dense reference is RMSNorm + SwiGLU, no biases")
    d, f = m["d_model"], m["d_ff"]
    hd = m.get("head_dim") or d // m["num_heads"]
    leaves = C.head_leaves(m)
    for i in range(m["num_layers"]):
        p = ("layers", str(i))
        leaves += [(p + ("attn_norm", "scale"), (d,), "scale", 0.1)]
        leaves += C.attn_leaves(p + ("attn",), d, m["num_heads"],
                                m["num_kv_heads"], hd)
        leaves += [(p + ("mlp_norm", "scale"), (d,), "scale", 0.1),
                   (p + ("mlp", "gate", "w"), (d, f), "normal", d ** -0.5),
                   (p + ("mlp", "up", "w"), (d, f), "normal", d ** -0.5),
                   (p + ("mlp", "down", "w"), (f, d), "normal", f ** -0.5)]
    w = C.draw(leaves, gen, dtype, device)
    C.listify(w, "layers", m["num_layers"])
    return w


def _layer(lp: Dict, m: Dict, h: torch.Tensor, pos: torch.Tensor,
           quant: Optional[str]) -> torch.Tensor:
    a = C.rmsnorm(h, lp["attn_norm"]["scale"])
    h = h + C.self_attention(lp["attn"], a, pos, heads=m["num_heads"],
                             kv_heads=m["num_kv_heads"],
                             theta=m.get("rope_theta", 10000.0),
                             window=m.get("sliding_window"), quant=quant)
    x = C.rmsnorm(h, lp["mlp_norm"]["scale"])
    mp = lp["mlp"]
    g = F.silu(C.linear(x, mp["gate"]["w"], quant=quant))
    u = C.linear(x, mp["up"]["w"], quant=quant)
    return h + C.linear(g * u, mp["down"]["w"], quant=quant)


@torch.no_grad()
def forward(w: Dict, m: Dict, seqs: List[torch.Tensor], starts: List[int],
            quant: Optional[str] = None) -> List[torch.Tensor]:
    """seqs: 1-D int token tensors on the weights' device. Returns, per
    sequence, float32 logits (S - start, V) of rows start..S-1."""
    C.no_tf32()
    hs = [C.f32(w["embed"]["emb"][s.long()]) for s in seqs]
    pos = [torch.arange(s.shape[0], device=s.device) for s in seqs]
    for lp in w["layers"]:
        lf = C.to_f32(lp)
        hs = [_layer(lf, m, h, p, quant) for h, p in zip(hs, pos)]
        del lf
    return [C.logits(w, m, h[st:], quant) for h, st in zip(hs, starts)]

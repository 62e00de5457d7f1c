"""The yardstick's arithmetic: the card's peaks, a call's bound time, and
the model FLOPs of the tokens a serving step computes.

Model FLOPs count the products of the useful work only: each valid
prompt or decode token's projections, MLP and attention over the keys it
sees (capped at the window), and one unembedding per emitted token; no
padded chunk row, no dead lane, no intermediate chunk's logits. A
Mamba2 layer counts its projections, its conv, and the recurrent form of
its scan (4 H P N a token: the state update and the read-out).
"""
from __future__ import annotations

from typing import Dict, Optional

# NVIDIA's data sheet, H100 SXM, dense bf16 and HBM3 at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: max(FLOPs / peak, bytes / peak
    bandwidth)."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S)


def head_dim(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def keys_sum(start: int, n: int, window: Optional[int]) -> int:
    """Sum over positions p in [start, start + n) of min(p + 1, window)."""
    lo, hi = start + 1, start + n            # key counts run lo..hi
    if window is None or hi <= window:
        return (lo + hi) * n // 2
    if lo > window:
        return window * n
    below = (lo + window) * (window - lo + 1) // 2
    return below + window * (hi - window)


def _attn_mm(m: Dict) -> int:
    d, hd = m["d_model"], head_dim(m)
    return 2 * (2 * d * m["num_heads"] * hd + 2 * d * m["num_kv_heads"] * hd)


def attention_layers(m: Dict) -> int:
    if m["family"] == "hybrid":
        every = m.get("hybrid_attn_every", 0)
        return m["num_layers"] // every if every else 0
    return m["num_layers"]


def token_mm_flops(m: Dict) -> int:
    """Projection and MLP FLOPs of one token through every layer (no
    attention scores, no unembedding)."""
    d, f = m["d_model"], m["d_ff"]
    if m["family"] == "dense":
        n_mat = 3 if m["activation"] in ("swiglu", "geglu") else 2
        return m["num_layers"] * (_attn_mm(m) + 2 * n_mat * d * f)
    if m["family"] == "hybrid":
        s = m["ssm"]
        di = s["expand"] * d
        N, P = s["state_dim"], s["head_dim"]
        H = di // P
        mamba = 2 * (d * (2 * di + 2 * N + H) + di * d) \
            + 2 * s["conv_width"] * (di + 2 * N) + 4 * H * P * N
        n_mat = 3 if m["activation"] in ("swiglu", "geglu") else 2
        shared = _attn_mm(m) + 2 * n_mat * d * f
        return m["num_layers"] * mamba + attention_layers(m) * shared
    raise ValueError(f"no FLOP count for family {m['family']!r}")


def attn_flops(m: Dict, keys: int) -> int:
    """Score and value products of one query row over ``keys`` keys, in
    every attention layer."""
    return attention_layers(m) * 4 * m["num_heads"] * head_dim(m) * keys


def unembed_flops(m: Dict) -> int:
    return 2 * m["d_model"] * m["vocab_size"]


def prefill_flops(m: Dict, start: int, n: int, last: bool) -> int:
    """Prompt tokens [start, start + n); ``last``: this call yields the
    request's first output token (one row of logits)."""
    win = m.get("sliding_window")
    return n * token_mm_flops(m) + attn_flops(m, keys_sum(start, n, win)) \
        + (unembed_flops(m) if last else 0)


def decode_flops(m: Dict, kv_len: int) -> int:
    """One decode token whose attention sees ``kv_len`` keys (itself
    included), before the window cap."""
    win = m.get("sliding_window")
    keys = min(kv_len, win) if win else kv_len
    return token_mm_flops(m) + attn_flops(m, keys) + unembed_flops(m)

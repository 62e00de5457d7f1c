"""Shared neural-net layers on plain dicts of tensors (counterpart of
``repro/models/layers.py``).

Conventions, as in the reference package:
  * params are nested dicts of tensors; weights are laid out (in, out), so
    ``linear`` is ``x @ w``;
  * every ``*_init`` returns the param subtree, drawn on ``device`` from an
    explicit ``torch.Generator``;
  * compute-sensitive reductions run in float32 and cast back.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------- init
def _normal(gen: torch.Generator, shape, scale: float, dtype, device):
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype, device,
               *, scale: Optional[float] = None, bias: bool = False):
    if scale is None:
        scale = in_dim ** -0.5
    p = {"w": _normal(gen, (in_dim, out_dim), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype, device):
    return {"emb": _normal(gen, (vocab, dim), 0.02, dtype, device)}


def linear(params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


# --------------------------------------------------------------------------- norms
def rmsnorm_init(dim: int, dtype, device):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(dim: int, dtype, device):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


def norm_init(kind: str, dim: int, dtype, device):
    if kind == "rmsnorm":
        return rmsnorm_init(dim, dtype, device)
    return layernorm_init(dim, dtype, device)


def norm_apply(kind: str, params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


# --------------------------------------------------------------------------- rope
def _rope_angles(positions: torch.Tensor, head_dim: int,
                 theta: float) -> torch.Tensor:
    """positions (..., S) -> angles (..., S, head_dim//2), float32."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    inv_freq = 1.0 / (theta ** exponent)
    return positions.float()[..., None] * inv_freq


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, H, S, D), positions (B, S). Split-half (llama) convention."""
    ang = _rope_angles(positions, x.shape[-1], theta)      # (B, S, D/2)
    cos = torch.cos(ang)[:, None]
    sin = torch.sin(ang)[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Sequence[int]) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL, arXiv:2409.12191).

    x (B, H, S, D); positions3 (B, S, 3) = (temporal, height, width) ids.
    The D/2 rotary frequencies are split into 3 contiguous sections, each
    rotated by its own position stream; float32 throughout.
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"{half}")
    dev = x.device
    exponent = torch.arange(half, dtype=torch.float32, device=dev) / half
    inv_freq = 1.0 / (theta ** exponent)
    # per frequency index, the position stream that drives it, from device
    # comparisons alone (no host values copied in: the decode step replays
    # as a CUDA graph)
    idx = torch.arange(half, device=dev)
    sec_id = (idx >= sections[0]).long() \
        + (idx >= sections[0] + sections[1]).long()
    pos = positions3.float()[..., sec_id]                  # (B, S, half)
    ang = pos * inv_freq
    cos = torch.cos(ang)[:, None]
    sin = torch.sin(ang)[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, dim: int, device="cpu") -> torch.Tensor:
    """Classic transformer sinusoids (whisper encoder), float32 (S, dim)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10000.0 ** (2 * idx / dim))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# --------------------------------------------------------------------------- mlp
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype, device):
    if activation in ("swiglu", "geglu"):
        return {"gate": dense_init(gen, d_model, d_ff, dtype, device),
                "up": dense_init(gen, d_model, d_ff, dtype, device),
                "down": dense_init(gen, d_ff, d_model, dtype, device)}
    return {"up": dense_init(gen, d_model, d_ff, dtype, device, bias=True),
            "down": dense_init(gen, d_ff, d_model, dtype, device, bias=True)}


def mlp_apply(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; so does this port
    if activation == "swiglu":
        h = F.silu(linear(params["gate"], x)) * linear(params["up"], x)
    elif activation == "geglu":
        h = (F.gelu(linear(params["gate"], x), approximate="tanh")
             * linear(params["up"], x))
    else:  # gelu
        h = F.gelu(linear(params["up"], x), approximate="tanh")
    return linear(params["down"], h)

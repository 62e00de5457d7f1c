"""Mamba2 block in its SSD form, arXiv:2405.21060 (counterpart of
``repro/models/ssm.py``).

Projections are split as in the reference: ``zx_proj`` gives [z | x]
(d_inner each), ``bc_proj`` gives [B | C] (G·N each: one B and one C per
group of heads), ``dt_proj`` one step size per head. A causal depthwise
conv runs over the concatenated (x, B, C) channels; the sequence mix is the
chunked SSD scan (``ops.ssd_scan``: the Hopper kernel K5 on the card, its
plain version on the host). With G = ``ssm.n_groups`` > 1 (Nemotron-H)
head h reads group h // (H / G), B and C go to the scan as (B, S, G, N),
and the gated RMSNorm normalises each group of d_inner / G channels.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

# Leaves of the block that stay float32 whatever the model dtype, as in the
# reference: the decay rates, the skip and the step-size bias.
FLOAT32_LEAVES = frozenset({"A_log", "D", "dt_bias"})


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype, device):
    s = cfg.ssm
    d, di, GN = cfg.d_model, cfg.d_inner, s.n_groups * s.state_dim
    H = cfg.ssm_heads
    conv_ch = di + 2 * GN
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((s.conv_width, conv_ch), generator=gen, **f32) * 0.2
    return {
        "zx_proj": L.dense_init(gen, d, 2 * di, dtype, device),
        "bc_proj": L.dense_init(gen, d, 2 * GN, dtype, device),
        "dt_proj": L.dense_init(gen, d, H, dtype, device),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        # FLOAT32_LEAVES
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.rand((H,), generator=gen, **f32) * 3.0 - 4.0,
        "gate_norm": L.rmsnorm_init(di, dtype, device),
        "out_proj": L.dense_init(gen, di, d, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), w (W, C) depthwise causal conv, b (C,); in float32."""
    W, C = w.shape
    xp = F.pad(x.float().transpose(1, 2), (W - 1, 0))      # (B, C, S+W-1)
    out = F.conv1d(xp, w.float().t()[:, None, :], groups=C)  # (B, C, S)
    return (out.transpose(1, 2) + b.float()).to(x.dtype)


def _project(params, cfg: ModelConfig, x: torch.Tensor):
    di, GN = cfg.d_inner, cfg.ssm.n_groups * cfg.ssm.state_dim
    z, xb = L.linear(params["zx_proj"], x).split([di, di], dim=-1)
    Bm, Cm = L.linear(params["bc_proj"], x).split([GN, GN], dim=-1)
    dt = L.linear(params["dt_proj"], x)                       # (B, S, H)
    return z, xb, Bm, Cm, dt


def _groups(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    """B or C (..., G·N) as the scan takes it: (..., N) at G = 1, else
    (..., G, N)."""
    s = cfg.ssm
    if s.n_groups == 1:
        return t
    return t.reshape(*t.shape[:-1], s.n_groups, s.state_dim)


def _gated_norm(params, cfg: ModelConfig, y: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """RMSNorm of y * silu(z), over each group of d_inner / G channels."""
    G = cfg.ssm.n_groups
    if G == 1:
        return L.rmsnorm(params["gate_norm"], y * F.silu(z))
    g = y * F.silu(z)
    gf = g.float().reshape(*g.shape[:-1], G, -1)
    gf = gf * torch.rsqrt(gf.pow(2).mean(-1, keepdim=True) + 1e-5)
    return (gf.reshape(g.shape) * params["gate_norm"]["scale"].float()
            ).to(g.dtype)


def mamba_apply(params, cfg: ModelConfig, x: torch.Tensor, *,
                backend: str = "auto") -> torch.Tensor:
    """Full sequence without a cache. x (B, S, d) -> y (B, S, d)."""
    y, _, _ = mamba_apply_with_state(params, cfg, x, backend=backend)
    return y


def mamba_apply_with_state(params, cfg: ModelConfig, x: torch.Tensor, *,
                           backend: str = "auto",
                           n_valid: Optional[torch.Tensor] = None):
    """Returns (y (B, S, d), conv_state (B, W-1, conv_ch),
    ssm_state (B, H, P, N) float32). ``n_valid`` (0-d int, device): only
    the first n_valid positions are the prompt, the rest padding; a pad's
    step size is 0, so it leaves the state as it was, and the conv state
    is the last W-1 inputs before it (the outputs at pads are garbage)."""
    s = cfg.ssm
    B, S, _ = x.shape
    di, H, P = cfg.d_inner, cfg.ssm_heads, s.head_dim
    GN = s.n_groups * s.state_dim
    z, xb, Bm, Cm, dt = _project(params, cfg, x)
    conv_in = torch.cat([xb, Bm, Cm], dim=-1)                 # (B, S, conv_ch)
    conv_out = F.silu(_causal_conv(conv_in, params["conv_w"],
                                   params["conv_b"]))
    xb, Bm, Cm = conv_out.split([di, GN, GN], dim=-1)
    # jax.nn.softplus has no threshold; F.softplus is the identity above 20,
    # where log1p(exp(x)) rounds to x in float32 anyway
    dt = F.softplus(dt.float() + params["dt_bias"])           # (B, S, H)
    if n_valid is not None:
        valid = torch.arange(S, device=x.device) < n_valid
        dt = dt * valid[None, :, None]
    A = -torch.exp(params["A_log"])                           # (H,) negative
    # the kernel's layouts, contiguous: x (B, H, S, P), dt (B, H, S)
    xh = xb.reshape(B, S, H, P).transpose(1, 2).contiguous()
    dth = dt.transpose(1, 2).contiguous()
    yh, final_state = ops.ssd_scan(xh, dth, A, _groups(cfg, Bm).contiguous(),
                                   _groups(cfg, Cm).contiguous(),
                                   chunk=s.chunk_size, backend=backend)
    yh = (yh + params["D"][None, :, None, None] * xh).to(x.dtype)   # skip
    y = yh.transpose(1, 2).reshape(B, S, di)
    y = _gated_norm(params, cfg, y, z)                        # gated norm
    y = L.linear(params["out_proj"], y)
    W1 = s.conv_width - 1
    if n_valid is not None:
        # positions n_valid - W1 .. n_valid - 1 of the zero-padded input
        at = n_valid + torch.arange(W1, device=x.device)
        conv_state = F.pad(conv_in, (0, 0, W1, 0)).index_select(1, at)
    elif S >= W1:
        conv_state = conv_in[:, S - W1:]
    else:
        conv_state = F.pad(conv_in, (0, 0, W1 - S, 0))
    return y, conv_state, final_state


def mamba_decode_step(params, cfg: ModelConfig, x: torch.Tensor,
                      conv_state: torch.Tensor, ssm_state: torch.Tensor):
    """One-token decode. x (B, 1, d); conv_state (B, W-1, conv_ch);
    ssm_state (B, H, P, N). Returns (y (B, 1, d), conv_state, ssm_state),
    the states new tensors (the caller writes them into its cache)."""
    s = cfg.ssm
    B = x.shape[0]
    di, H, P = cfg.d_inner, cfg.ssm_heads, s.head_dim
    GN = s.n_groups * s.state_dim
    z, xb, Bm, Cm, dt = _project(params, cfg, x)
    conv_in = torch.cat([xb, Bm, Cm], dim=-1)[:, 0]           # (B, conv_ch)
    window = torch.cat([conv_state, conv_in[:, None]], dim=1)  # (B, W, ch)
    conv_out = torch.einsum("bwc,wc->bc", window.float(),
                            params["conv_w"].float()) \
        + params["conv_b"].float()
    conv_out = F.silu(conv_out).to(x.dtype)                   # (B, ch)
    xb1, Bm1, Cm1 = conv_out.split([di, GN, GN], dim=-1)
    dt1 = F.softplus(dt[:, 0].float() + params["dt_bias"])    # (B, H)
    A = -torch.exp(params["A_log"])
    xh = xb1.reshape(B, H, P)
    yh, new_state = ops.ssd_decode_step(ssm_state, xh, dt1, A,
                                        _groups(cfg, Bm1), _groups(cfg, Cm1))
    yh = (yh + params["D"][None, :, None] * xh).to(x.dtype)
    y = yh.reshape(B, 1, di)
    y = _gated_norm(params, cfg, y, z)
    y = L.linear(params["out_proj"], y)
    return y, window[:, 1:], new_state

"""Analytic roofline performance model: R(m, n, s) per architecture.

The paper measures R and E empirically per (model, system); we derive them
from the architecture config and the system profile so the scheduler can
price *any* of the 10 assigned architectures on *any* system. The model is
the standard two-phase LLM-inference roofline:

  prefill:  t = max(FLOPs / peak_flops, weight+activation bytes / hbm_bw)
  decode:   per-token t at context c, memory term dominated by weight
            streaming (amortized over batch) + KV/state reads.

The same FLOPs/bytes functions feed the §Roofline analysis — the dry-run's
compiled cost_analysis validates them (see benchmarks/roofline.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.systems import SystemProfile

BYTES_PER_PARAM = 2.0   # bf16 weights
BYTES_PER_ACT = 2.0


@dataclass(frozen=True)
class QueryPhases:
    """Per-phase seconds and utilization for one query."""
    t_prefill: float
    t_decode: float
    t_overhead: float
    util_prefill: float
    util_decode: float

    @property
    def total(self) -> float:
        return self.t_prefill + self.t_decode + self.t_overhead


# --------------------------------------------------------------------- FLOPs/bytes
def flops_prefill(cfg: ModelConfig, m: int) -> float:
    """Forward FLOPs to process m prompt tokens."""
    n_act = cfg.active_param_count()
    f = 2.0 * n_act * m
    # causal attention: 2 matmuls (QK^T, PV) x 2 FLOPs, halved by causal mask
    if not cfg.is_attention_free:
        d_attn = cfg.num_heads * cfg.resolved_head_dim
        layers = cfg.num_layers if cfg.family != "audio" else cfg.num_layers + cfg.encoder_layers
        eff_ctx = min(m, cfg.sliding_window) if cfg.sliding_window else m
        f += 2.0 * layers * m * eff_ctx * d_attn
    if cfg.family in ("ssm", "hybrid"):
        s = cfg.ssm
        # SSD state algebra: ~ 6 * d_inner * N per token per layer
        f += 6.0 * cfg.num_layers * m * cfg.d_inner * s.state_dim
    return f


def flops_decode_token(cfg: ModelConfig, ctx: int) -> float:
    """FLOPs to emit one token at context length ctx."""
    n_act = cfg.active_param_count()
    f = 2.0 * n_act
    if not cfg.is_attention_free:
        d_attn = cfg.num_heads * cfg.resolved_head_dim
        eff_ctx = min(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
        n_attn_layers = cfg.num_layers
        if cfg.family == "hybrid":
            n_attn_layers = max(1, cfg.num_layers // max(1, cfg.hybrid_attn_every))
        f += 4.0 * n_attn_layers * eff_ctx * d_attn
    if cfg.family in ("ssm", "hybrid"):
        f += 6.0 * cfg.num_layers * cfg.d_inner * cfg.ssm.state_dim
    return f


def kv_bytes_per_token_ctx(cfg: ModelConfig, ctx: int) -> float:
    """KV-cache bytes read to emit one token at context ctx."""
    if cfg.is_attention_free:
        s = cfg.ssm
        return cfg.num_layers * cfg.ssm_heads * s.head_dim * s.state_dim * 4.0
    hd = cfg.resolved_head_dim
    eff_ctx = min(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
    n_attn_layers = cfg.num_layers
    if cfg.family == "hybrid":
        n_attn_layers = max(1, cfg.num_layers // max(1, cfg.hybrid_attn_every))
        ssm_bytes = cfg.num_layers * cfg.ssm_heads * cfg.ssm.head_dim * cfg.ssm.state_dim * 4.0
        return 2.0 * n_attn_layers * cfg.num_kv_heads * hd * eff_ctx * BYTES_PER_ACT + ssm_bytes
    return 2.0 * n_attn_layers * cfg.num_kv_heads * hd * eff_ctx * BYTES_PER_ACT


def weight_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * BYTES_PER_PARAM


# --------------------------------------------------------------------- time model
def query_phases(cfg: ModelConfig, m: int, n: int, s: SystemProfile,
                 batch: int = 1) -> QueryPhases:
    """Roofline time for one query of m input / n output tokens on system s,
    amortizing weight streaming over `batch` concurrent queries."""
    peak = s.instance_peak_flops * s.compute_eff
    bw = s.instance_hbm_bw * s.mem_eff
    wb = weight_bytes(cfg)

    # ---- prefill ----
    f_pf = flops_prefill(cfg, m)
    b_pf = wb / batch + 2.0 * m * cfg.d_model * BYTES_PER_ACT * cfg.num_layers
    t_pf_compute = f_pf / peak
    t_pf_mem = b_pf / bw
    t_pf = max(t_pf_compute, t_pf_mem) * s.degradation(m)
    util_pf = min(1.0, t_pf_compute / max(t_pf, 1e-12))

    # ---- decode: integrate per-token time at mid-context (trapezoid approx) ----
    t_dec = 0.0
    util_dec = 0.0
    if n > 0:
        ctx_mid = m + n / 2.0
        f_tok = flops_decode_token(cfg, int(ctx_mid))
        b_tok = wb / batch + kv_bytes_per_token_ctx(cfg, int(ctx_mid))
        t_tok_compute = f_tok / peak
        t_tok_mem = b_tok / bw
        t_tok = max(t_tok_compute, t_tok_mem) * s.degradation(ctx_mid)
        t_dec = n * t_tok
        util_dec = min(1.0, t_tok_compute / max(t_tok, 1e-12))

    return QueryPhases(t_prefill=t_pf, t_decode=t_dec, t_overhead=s.overhead_s,
                       util_prefill=util_pf, util_decode=util_dec)


@dataclass(frozen=True)
class BatchPhases:
    """Vectorized `QueryPhases`: one float64 array per field, aligned by index.

    Produced by `query_phases_batch`; every element is bit-for-bit identical to
    the corresponding scalar `query_phases` result (same operand values, same
    operation order, same IEEE-754 double ops).
    """
    t_prefill: np.ndarray
    t_decode: np.ndarray
    t_overhead: np.ndarray
    util_prefill: np.ndarray
    util_decode: np.ndarray

    @property
    def total(self) -> np.ndarray:
        # same association as QueryPhases.total: (t_prefill + t_decode) + t_overhead
        return (self.t_prefill + self.t_decode) + self.t_overhead


def query_phases_batch(cfg: ModelConfig, m, n, s: SystemProfile,
                       batch: int = 1) -> BatchPhases:
    """Vectorized `query_phases` over arrays of (m, n) token counts.

    Elementwise bit-identical to the scalar path: every expression below
    transcribes the scalar code with the same left-to-right operand order, so
    each IEEE-754 op sees the same operands in the same association. The only
    rewrites are `int(x)` -> `np.trunc(x)` (equal for the non-negative context
    lengths here) and `min`/`max` -> `np.minimum`/`np.maximum`.
    """
    m_arr = np.asarray(m, dtype=np.float64)
    n_arr = np.asarray(n, dtype=np.float64)
    peak = s.instance_peak_flops * s.compute_eff
    bw = s.instance_hbm_bw * s.mem_eff
    wb = weight_bytes(cfg)
    n_act = cfg.active_param_count()

    def _eff_ctx(ctx: np.ndarray) -> np.ndarray:
        return np.minimum(ctx, cfg.sliding_window) if cfg.sliding_window else ctx

    # ---- prefill (mirrors flops_prefill) ----
    f_pf = 2.0 * n_act * m_arr
    if not cfg.is_attention_free:
        d_attn = cfg.num_heads * cfg.resolved_head_dim
        layers = cfg.num_layers if cfg.family != "audio" else cfg.num_layers + cfg.encoder_layers
        f_pf = f_pf + 2.0 * layers * m_arr * _eff_ctx(m_arr) * d_attn
    if cfg.family in ("ssm", "hybrid"):
        ssm = cfg.ssm
        f_pf = f_pf + 6.0 * cfg.num_layers * m_arr * cfg.d_inner * ssm.state_dim
    b_pf = wb / batch + 2.0 * m_arr * cfg.d_model * BYTES_PER_ACT * cfg.num_layers
    t_pf_compute = f_pf / peak
    t_pf_mem = b_pf / bw
    if s.sat_ctx is None:
        degr_pf = np.ones_like(m_arr)
    else:
        degr_pf = 1.0 + m_arr / s.sat_ctx
    t_pf = np.maximum(t_pf_compute, t_pf_mem) * degr_pf
    util_pf = np.minimum(1.0, t_pf_compute / np.maximum(t_pf, 1e-12))

    # ---- decode at mid-context (mirrors flops_decode_token / kv_bytes_per_token_ctx) ----
    ctx_mid = m_arr + n_arr / 2.0
    ctx_i = np.trunc(ctx_mid)          # == float(int(ctx_mid)) elementwise
    f_tok = np.full_like(m_arr, 2.0 * n_act)
    if not cfg.is_attention_free:
        d_attn = cfg.num_heads * cfg.resolved_head_dim
        n_attn_layers = cfg.num_layers
        if cfg.family == "hybrid":
            n_attn_layers = max(1, cfg.num_layers // max(1, cfg.hybrid_attn_every))
        f_tok = f_tok + 4.0 * n_attn_layers * _eff_ctx(ctx_i) * d_attn
    if cfg.family in ("ssm", "hybrid"):
        f_tok = f_tok + 6.0 * cfg.num_layers * cfg.d_inner * cfg.ssm.state_dim
    if cfg.is_attention_free:
        ssm = cfg.ssm
        kv_tok = np.full_like(
            m_arr, cfg.num_layers * cfg.ssm_heads * ssm.head_dim * ssm.state_dim * 4.0)
    else:
        hd = cfg.resolved_head_dim
        n_attn_layers = cfg.num_layers
        if cfg.family == "hybrid":
            n_attn_layers = max(1, cfg.num_layers // max(1, cfg.hybrid_attn_every))
            ssm_bytes = cfg.num_layers * cfg.ssm_heads * cfg.ssm.head_dim * cfg.ssm.state_dim * 4.0
            kv_tok = 2.0 * n_attn_layers * cfg.num_kv_heads * hd * _eff_ctx(ctx_i) * BYTES_PER_ACT + ssm_bytes
        else:
            kv_tok = 2.0 * n_attn_layers * cfg.num_kv_heads * hd * _eff_ctx(ctx_i) * BYTES_PER_ACT
    b_tok = wb / batch + kv_tok
    t_tok_compute = f_tok / peak
    t_tok_mem = b_tok / bw
    if s.sat_ctx is None:
        degr_tok = np.ones_like(m_arr)
    else:
        degr_tok = 1.0 + ctx_mid / s.sat_ctx   # float mid-context, as in the scalar path
    t_tok = np.maximum(t_tok_compute, t_tok_mem) * degr_tok
    has_decode = n_arr > 0
    t_dec = np.where(has_decode, n_arr * t_tok, 0.0)
    util_dec = np.where(
        has_decode, np.minimum(1.0, t_tok_compute / np.maximum(t_tok, 1e-12)), 0.0)

    return BatchPhases(t_prefill=t_pf, t_decode=t_dec,
                       t_overhead=np.full_like(m_arr, s.overhead_s),
                       util_prefill=util_pf, util_decode=util_dec)


def runtime(cfg: ModelConfig, m: int, n: int, s: SystemProfile,
            batch: int = 1) -> float:
    """R(m, n, s) in seconds (Eq. 1's runtime term)."""
    return query_phases(cfg, m, n, s, batch).total


def throughput(cfg: ModelConfig, m: int, n: int, s: SystemProfile,
               batch: int = 1) -> float:
    """tokens/s processed+generated for one query."""
    return (m + n) / runtime(cfg, m, n, s, batch)

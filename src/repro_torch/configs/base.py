"""Base configuration dataclasses for the repro framework.

Every assigned architecture is expressed as a ``ModelConfig``; input shapes as
``InputShape``. Configs are plain frozen dataclasses so they can be hashed and
used as jit static args.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    # capacity factor for fixed-shape expert dispatch (TPU-friendly, no dynamic shapes)
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    # router: "softmax" (top-k of the softmax, renormalised; the capacity
    # path) or "sigmoid" (Nemotron-H / DeepSeek-V3: top-k of sigmoid scores
    # plus a per-expert correction bias that only selects; the dropless
    # grouped path)
    router: str = "softmax"
    score_bias: bool = False      # the correction bias (selection only)
    norm_topk_prob: bool = True   # sigmoid: the chosen scores normalised
    routed_scale: float = 1.0     # sigmoid: weights times this
    shared_expert_dim: int = 0    # one shared expert of this width (0: none)


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128          # N: SSM state size per head
    head_dim: int = 64            # P: channels per SSM head
    expand: int = 2               # d_inner = expand * d_model
    chunk_size: int = 128         # SSD chunk length
    conv_width: int = 4           # depthwise causal conv width
    n_groups: int = 1             # B/C groups; head h reads group h // (H / G)
    num_heads: int = 0            # >0: d_inner = num_heads * head_dim


BLOCK_KINDS = "ME*"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    # positional encoding: rope | mrope | learned | sinusoidal
    pos_emb: str = "rope"
    rope_theta: float = 10000.0
    # attention options
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # None = full attention
    attn_logit_softcap: Optional[float] = None
    # activation: swiglu | gelu | geglu
    activation: str = "swiglu"
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    tie_embeddings: bool = False
    # family-specific blocks
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2-style): one *shared* attention block applied every k layers
    hybrid_attn_every: int = 0    # 0 = no interleaved attention
    # hybrid (Nemotron-H-style): one block per character, each with weights
    # of its own: M Mamba2, E MoE FFN, * attention (no MLP); "" = the
    # family's own layer walk. Each block is h + mixer(norm(h)).
    block_pattern: str = ""
    # encoder-decoder (whisper-style)
    encoder_layers: int = 0       # >0 => enc-dec
    encoder_seq_len: int = 0      # fixed encoder input length (audio frames)
    # multimodal stub frontend
    frontend: Optional[str] = None  # "audio" | "vision" | None
    num_vision_tokens: int = 0      # VLM: patch embeddings prepended to the prompt
    # citation for the config (paper/model card)
    source: str = ""
    max_seq_len: int = 131072

    def __post_init__(self):
        # configurations read from JSON give the nested groups as mappings
        if isinstance(self.moe, dict):
            object.__setattr__(self, "moe", MoEConfig(**self.moe))
        if isinstance(self.ssm, dict):
            object.__setattr__(self, "ssm", SSMConfig(**self.ssm))
        if self.block_pattern:
            if len(self.block_pattern) != self.num_layers or \
                    set(self.block_pattern) - set(BLOCK_KINDS):
                raise ValueError(
                    f"block_pattern {self.block_pattern!r}: one of "
                    f"{BLOCK_KINDS!r} per layer ({self.num_layers})")
            if self.family != "hybrid":
                raise ValueError("block_pattern needs family 'hybrid'")

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        if self.num_heads == 0:
            return 0
        return self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        if not self.ssm:
            return 0
        if self.ssm.num_heads:
            return self.ssm.num_heads * self.ssm.head_dim
        return self.ssm.expand * self.d_model

    def blocks(self, kind: str) -> int:
        """How many blocks of ``block_pattern`` are of ``kind``."""
        return self.block_pattern.count(kind)

    def _pattern_params(self, active: bool) -> int:
        """Parameters of a ``block_pattern`` model (``active``: the routed
        experts a token reads, not all of them)."""
        d, hd = self.d_model, self.resolved_head_dim
        di, s = self.d_inner, self.ssm
        n_mat = 3 if self.activation in ("swiglu", "geglu") else 2
        mamba = (d * (2 * di + 2 * s.n_groups * s.state_dim + self.ssm_heads)
                 + (s.conv_width + 1) * (di + 2 * s.n_groups * s.state_dim)
                 + 3 * self.ssm_heads + di + di * d)
        attn = (d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd
                + self.num_heads * hd * d)
        total = 0
        if self.moe is not None:
            m = self.moe
            n = m.num_experts_per_tok if active else m.num_experts
            moe = (n * n_mat * d * self.d_ff + d * m.num_experts
                   + (m.num_experts if m.score_bias else 0)
                   + n_mat * d * m.shared_expert_dim)
            total += self.blocks("E") * moe
        total += self.blocks("M") * mamba + self.blocks("*") * attn
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(emb + d + total + self.num_layers * d)

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    def param_count(self) -> int:
        """Approximate parameter count (used by the perf/energy model); exact
        for a ``block_pattern`` model."""
        if self.block_pattern:
            return self._pattern_params(active=False)
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "audio"):
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            attn = q + kv + o
            if self.family == "moe" and self.moe is not None:
                ffn = self.moe.num_experts * 3 * d * self.d_ff + d * self.moe.num_experts
            else:
                n_mat = 3 if self.activation in ("swiglu", "geglu") else 2
                ffn = n_mat * d * self.d_ff
            per_layer = attn + ffn + 2 * d
        elif self.family == "ssm":
            di, N = self.d_inner, self.ssm.state_dim
            nh = self.ssm_heads
            per_layer = d * (2 * di + 2 * N + nh) + di * d + di * self.ssm.conv_width + 2 * d
        elif self.family == "hybrid":
            di, N = self.d_inner, self.ssm.state_dim
            nh = self.ssm_heads
            mamba = d * (2 * di + 2 * N + nh) + di * d + di * self.ssm.conv_width + 2 * d
            per_layer = mamba
        total = emb + L * per_layer
        if self.family == "hybrid" and self.hybrid_attn_every:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            n_mat = 3 if self.activation in ("swiglu", "geglu") else 2
            total += q + kv + o + n_mat * d * self.d_ff  # one SHARED block
        if self.encoder_layers:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            n_mat = 3 if self.activation in ("swiglu", "geglu") else 2
            enc_layer = q + kv + o + n_mat * d * self.d_ff + 2 * d
            cross = q + kv + o  # decoder cross-attn per layer already counted? add:
            total += self.encoder_layers * enc_layer + self.num_layers * cross
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.block_pattern:
            return self._pattern_params(active=True)
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        full_ffn = self.moe.num_experts * 3 * d * self.d_ff
        active_ffn = self.moe.num_experts_per_tok * 3 * d * self.d_ff
        return int(self.param_count() - L * (full_ffn - active_ffn))

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts, small vocab."""
        d = min(self.d_model, 256)
        n_heads = min(self.num_heads, 4)
        n_kv = max(1, min(self.num_kv_heads, n_heads))
        # keep the GQA ratio representative
        if self.num_kv_heads < self.num_heads:
            n_kv = max(1, n_heads // max(1, self.num_heads // self.num_kv_heads))
        moe = None
        if self.moe is not None:
            ne = min(4, self.moe.num_experts)
            nk = min(2, self.moe.num_experts_per_tok)
            # dropless capacity (C = T) so smoke tests are deterministic across
            # different batch compositions
            moe = dataclasses.replace(self.moe, num_experts=ne, num_experts_per_tok=nk,
                                      capacity_factor=float(ne) / nk)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, state_dim=min(32, self.ssm.state_dim),
                                      head_dim=32, chunk_size=32)
        return dataclasses.replace(
            self, num_layers=min(2, self.num_layers), d_model=d, num_heads=n_heads,
            num_kv_heads=n_kv, d_ff=min(512, self.d_ff), vocab_size=min(512, self.vocab_size),
            head_dim=64 if self.family != "ssm" else None,
            moe=moe, ssm=ssm,
            encoder_layers=min(2, self.encoder_layers) if self.encoder_layers else 0,
            encoder_seq_len=min(64, self.encoder_seq_len) if self.encoder_seq_len else 0,
            num_vision_tokens=min(16, self.num_vision_tokens) if self.num_vision_tokens else 0,
            hybrid_attn_every=min(2, self.hybrid_attn_every) if self.hybrid_attn_every else 0,
            block_pattern=self.block_pattern[:2],
            max_seq_len=2048,
        )


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}

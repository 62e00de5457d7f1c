"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + SHARED attention block
interleaved every 6 layers.  [arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    pos_emb="rope",
    activation="gelu",
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=128),
    hybrid_attn_every=6,
    sliding_window=8192,   # shared attn blocks use a sliding window -> long_500k viable
    source="arXiv:2411.15242",
    max_seq_len=1_048_576,
)

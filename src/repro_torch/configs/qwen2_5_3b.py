"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936, QKV bias.  [hf:Qwen/Qwen2.5-0.5B family]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    pos_emb="rope",
    rope_theta=1_000_000.0,
    qkv_bias=True,
    activation="swiglu",
    source="hf:Qwen/Qwen2.5-0.5B",
)

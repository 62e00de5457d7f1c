"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE, dynamic resolution.  [arXiv:2409.12191]

Vision encoder (ViT) is STUBBED per the carve-out: input_specs provides
precomputed patch embeddings of shape (B, num_vision_tokens, d_model) which the
language model consumes interleaved before text tokens, with M-RoPE position ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    pos_emb="mrope",
    rope_theta=1_000_000.0,
    qkv_bias=True,
    activation="swiglu",
    frontend="vision",
    num_vision_tokens=256,
    source="arXiv:2409.12191",
)

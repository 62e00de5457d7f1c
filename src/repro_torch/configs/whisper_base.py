"""whisper-base [audio]: enc-dec transformer, conv frontend stubbed.

6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.  [arXiv:2212.04356]
Whisper-base actually has 6 encoder + 6 decoder layers; 1500 audio frames
(30 s of mel features after the conv stride-2 frontend, which is STUBBED:
input_specs provides the (B, 1500, 512) frame embeddings directly).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    pos_emb="learned",
    qkv_bias=True,
    activation="gelu",
    norm="layernorm",
    encoder_layers=6,
    encoder_seq_len=1500,
    frontend="audio",
    source="arXiv:2212.04356",
    max_seq_len=448,
)

"""mamba2-130m [ssm]: 24L d_model=768 attention-free, vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    pos_emb="none",
    activation="silu",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=128),
    tie_embeddings=True,
    source="arXiv:2405.21060",
    max_seq_len=1_048_576,
)

"""mistral-7b — one of the paper's three benchmark models.  [arXiv:2310.06825]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, sliding window 4096.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    pos_emb="rope",
    activation="swiglu",
    sliding_window=4096,
    source="arXiv:2310.06825 (paper Section 4.1.3)",
)

"""llama2-7b — one of the paper's three benchmark models.  [arXiv:2307.09288]
32L d_model=4096 32H MHA d_ff=11008 vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=32000,
    pos_emb="rope",
    activation="swiglu",
    source="arXiv:2307.09288 (paper Section 4.1.2)",
)

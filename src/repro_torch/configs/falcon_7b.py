"""falcon-7b — one of the paper's three benchmark models.  [Falcon series]
32L d_model=4544 71H (MQA kv=1) d_ff=18176 (4*d) vocab=65024, gelu.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-7b",
    family="dense",
    num_layers=32,
    d_model=4544,
    num_heads=71,
    num_kv_heads=1,
    d_ff=18176,
    vocab_size=65024,
    pos_emb="rope",
    activation="gelu",
    source="Falcon series (paper Section 4.1.1)",
)

"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152, llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M family]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    pos_emb="rope",
    activation="swiglu",
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

"""nemotron-3-nano-30b-a3b [hybrid]: 52 blocks in Nemotron-H's pattern (23
Mamba2, 23 MoE, 6 attention), d_model=2688, vocab=131072. Mamba2: 64 heads
of 64, state 128, 8 B/C groups, conv 4, chunk 128. Attention: GQA 32/2
heads of 128, no positional encoding. MoE: 128 relu² experts of 1856,
top-6 of sigmoid scores, normalised and scaled by 2.5, plus one shared
relu² expert of 3712.
[hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16, config.json]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="nemotron-3-nano-30b-a3b",
    family="hybrid",
    num_layers=52,
    d_model=2688,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=1856,
    vocab_size=131072,
    pos_emb="none",
    activation="relu2",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=128,
                  conv_width=4, n_groups=8, num_heads=64),
    moe=MoEConfig(num_experts=128, num_experts_per_tok=6, router="sigmoid",
                  score_bias=True, norm_topk_prob=True, routed_scale=2.5,
                  shared_expert_dim=3712),
    block_pattern="MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME",
    source="hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16",
    max_seq_len=262144,
)

"""The Nemotron-H reference (``reference/nemotron_h.py``: grouped Mamba2,
sigmoid-routed relu² experts and a shared one, NoPE attention) against
the served package's forward at a tiny size, on the same weights (drawn
by the reference, handed to both)."""
import pytest
import torch

import _tiny
from serve_bench.reference import nemotron_h


def _port(model):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name="tiny", **model)


NEMOTRON = {"family": "hybrid", "num_layers": 6, "d_model": 64,
            "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 64,
            "vocab_size": 256, "pos_emb": "none", "activation": "relu2",
            "norm": "rmsnorm", "tie_embeddings": False,
            "block_pattern": "MEM*EM",
            "ssm": {"state_dim": 16, "head_dim": 16, "expand": 2,
                    "chunk_size": 32, "conv_width": 4, "n_groups": 2,
                    "num_heads": 4},
            "moe": {"num_experts": 8, "num_experts_per_tok": 3,
                    "router": "sigmoid", "score_bias": True,
                    "norm_topk_prob": True, "routed_scale": 2.5,
                    "shared_expert_dim": 64}}


@pytest.mark.parametrize("S", [9, 70])
def test_nemotron_reference_equals_forward(S):
    """The Nemotron-H reference (grouped Mamba2, sigmoid-routed experts
    and a shared one, NoPE attention) against the package's forward."""
    from repro_torch.models import model as M
    g = torch.Generator().manual_seed(7)
    w = nemotron_h.make_weights(NEMOTRON, g, torch.float32, "cpu")
    toks = torch.randint(0, 256, (2, S), generator=g)
    want, _ = M.forward_train(w, _port(NEMOTRON), {"tokens": toks})
    got = nemotron_h.forward(w, NEMOTRON, [toks[0], toks[1]], [0, S // 2])
    assert torch.allclose(got[0], want[0], atol=2e-5, rtol=0)
    assert torch.allclose(got[1], want[1, S // 2:], atol=2e-5, rtol=0)


def test_nemotron_served_prefill_and_decode():
    """bf16 prefill then decode through the package's cache against the
    float32 reference's one pass, as the cell's check reads it."""
    from repro_torch.serving.engine import InferenceEngine
    g = torch.Generator().manual_seed(8)
    w = nemotron_h.make_weights(NEMOTRON, g, torch.bfloat16, "cpu")
    eng = InferenceEngine(_port(NEMOTRON), w, max_len=64,
                          dtype=torch.bfloat16, device="cpu")
    toks = torch.randint(0, 256, (1, 12), generator=g)
    res = eng.generate({"tokens": toks}, 6)
    seq = torch.cat([toks[0], torch.as_tensor(res.tokens[0][:-1])])
    lg = nemotron_h.forward(w, NEMOTRON, [seq], [11])[0]
    served = torch.as_tensor(res.tokens[0], dtype=torch.long)
    gap = lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]
    assert float(gap.max()) < _tiny.LIMIT

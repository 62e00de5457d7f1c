"""Synthetic data: seeded, learnable token streams (counterpart of
``repro/training/data.py``).

The numpy draws are the reference's, in its order, so the tokens, audio
frames and vision embeddings are the same numbers as JAX's for the same
seed. ``arithmetic_stream`` is fully learnable (t_{i+1} = (a*t_i + c) mod
V), so training shows a falling loss without a dataset; ``uniform_stream``
is for throughput. Tokens are int64 tensors on ``device``; frames and
vision embeddings float32.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def arithmetic_stream(cfg: ModelConfig, batch_size: int, seq_len: int,
                      steps: int, seed: int = 0, a: int = 5, c: int = 7,
                      device="cpu") -> Iterator[Dict[str, torch.Tensor]]:
    """Affine-recurrence token stream: the next token is a function of the
    previous one, so a 1-layer model can reach ~0 loss."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    for _ in range(steps):
        t0 = rng.integers(0, V, size=(batch_size, 1))
        seq = [t0]
        for _ in range(seq_len - 1):
            seq.append((a * seq[-1] + c) % V)
        tokens = torch.from_numpy(np.concatenate(seq, axis=1).astype(np.int64))
        yield _attach_modalities(cfg, {"tokens": tokens.to(device)}, rng,
                                 device)


def uniform_stream(cfg: ModelConfig, batch_size: int, seq_len: int,
                   steps: int, seed: int = 0, device="cpu"
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        tokens = rng.integers(0, cfg.vocab_size, size=(batch_size, seq_len))
        yield _attach_modalities(
            cfg, {"tokens": torch.from_numpy(tokens.astype(np.int64)).to(device)},
            rng, device)


def _attach_modalities(cfg: ModelConfig, batch: Dict, rng, device) -> Dict:
    B = batch["tokens"].shape[0]
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    if cfg.family == "audio":
        batch["frames"] = f32(rng.normal(size=(B, cfg.encoder_seq_len,
                                               cfg.d_model)))
    if cfg.family == "vlm":
        batch["vision"] = f32(rng.normal(size=(B, cfg.num_vision_tokens,
                                               cfg.d_model)))
    return batch

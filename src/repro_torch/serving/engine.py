"""Inference engine: prefill and decode steps over the model of any ported
family — dense, SSM, hybrid (counterpart of ``repro/serving/engine.py``).

The engine owns the params of one architecture on one device. It runs on
``cuda`` unless the caller passes ``device="cpu"``; with no card and no
explicit device it raises — it never falls back to the host. Generation is
greedy (argmax) by default; sampling takes a ``torch.Generator``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import kv_blocks_needed
from repro_torch.models import model as M


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the plain path on the host")
    return dev


@dataclass
class GenerationResult:
    tokens: np.ndarray            # (B, n_out) generated tokens
    prompt_len: int
    steps: int


class InferenceEngine:
    """Single-model engine with a fixed max context."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 512,
                 backend: str = "auto", dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        got = params["embed"]["emb"].device
        if got.type != self.device.type:
            raise ValueError(f"params live on {got}, engine device is "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.backend = backend
        self.dtype = dtype

    # ------------------------------------------------------------------ api
    def new_cache(self, batch_size: int):
        return M.init_cache(self.cfg, batch_size, self.max_len, self.dtype,
                            self.device)

    def new_paged_cache(self, lanes: int, num_blocks: int, block_size: int):
        """Paged cache sized so one lane can hold up to ``max_len`` context."""
        mb = kv_blocks_needed(self.max_len, block_size)
        return M.init_paged_cache(self.cfg, lanes, num_blocks, block_size,
                                  self.dtype, self.device,
                                  max_blocks_per_lane=mb)

    def prefill_chunk(self, tokens: torch.Tensor, cache, lane: int,
                      n_valid: int):
        """Chunked prefill of one lane (see ``model.prefill_paged_chunk``)."""
        return M.prefill_paged_chunk(self.params, self.cfg, tokens, cache,
                                     lane=lane, n_valid=n_valid,
                                     backend=self.backend)

    def decode_paged(self, tokens: torch.Tensor, cache, live: torch.Tensor):
        return M.decode_step_paged(self.params, self.cfg, tokens, cache,
                                   live=live, backend=self.backend)

    def prefill(self, batch: Dict[str, torch.Tensor], cache=None):
        B = batch["tokens"].shape[0]
        if cache is None:
            cache = self.new_cache(B)
        return M.prefill(self.params, self.cfg, batch, cache,
                         backend=self.backend)

    def decode(self, tokens: torch.Tensor, cache):
        return M.decode_step(self.params, self.cfg, tokens, cache,
                             backend=self.backend)

    def generate(self, batch: Dict[str, torch.Tensor], max_new_tokens: int = 32,
                 *, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 eos_id: Optional[int] = None) -> GenerationResult:
        """Greedy (or sampled) generation. All requests share prompt length.

        With temperature > 0 and no generator, a generator seeded with 0 on
        the engine's device is used, so sampling is reproducible by default.
        Sampled tokens cannot match the reference's (JAX PRNG bits).
        """
        if temperature > 0.0 and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        tokens = torch.as_tensor(batch["tokens"], dtype=torch.int32,
                                 device=self.device)
        S = tokens.shape[1]
        logits, cache = self.prefill({"tokens": tokens})
        out = []
        tok = self._select(logits, temperature, generator)
        out.append(tok)
        for _ in range(max_new_tokens - 1):
            logits, cache = self.decode(tok[:, None], cache)
            tok = self._select(logits, temperature, generator)
            out.append(tok)
            # deliberate per-token sync: early EOS exit saves whole decode
            # steps, which dwarfs the transfer cost at batch scale
            if eos_id is not None and bool(torch.all(tok == eos_id)):
                break
        toks = torch.stack(out, dim=1).cpu().numpy()
        return GenerationResult(tokens=toks, prompt_len=S, steps=toks.shape[1])

    @staticmethod
    def _select(logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)

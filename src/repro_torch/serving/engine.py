"""Inference engine: prefill and decode steps over the model of any
family — dense, MoE, VLM, SSM, hybrid, audio (counterpart of
``repro/serving/engine.py``). The VLM and audio families are served by
``generate`` alone, with ``vision`` or ``frames`` beside ``tokens`` in the
batch, as in the reference (the batchers and the router pass tokens only).

The engine owns the params of one architecture on one device. It runs on
``cuda`` unless the caller passes ``device="cpu"``; with no card and no
explicit device it raises — it never falls back to the host. Generation is
greedy (argmax) by default; sampling takes a ``torch.Generator``.

``decode``, ``decode_paged`` and ``prefill_chunk`` are the steps the
reference jits. With ``graphs=True`` (the default) they run through a
``StepGraphs`` runner: on the card each is captured once per key (step,
input shapes, cache, tuning) as a CUDA graph and replayed after; on the
CPU the runner stages the same inputs around an eager call.
``graphs=False`` calls the model's steps eagerly, the counterpart of
running the reference under ``jax.disable_jit()``. The whole-prompt
``prefill`` is eager, its shape changing with every prompt, unless the
batch pads one lane's prompt and says how much of it is real
(``n_valid``, a ``block_pattern`` model): then it is a step like the
others, captured once per padded length and cache.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import kv_blocks_needed
from repro_torch.models import model as M
from repro_torch.serving.step_graph import StepGraphs


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
                 backend: str = "auto", dtype=torch.float32, device=None,
                 kv_quant: bool = False, graphs: bool = True):
        self.device = resolve_device(device)
        got = params["embed"]["emb"].device
        if got.type != self.device.type:
            raise ValueError(f"params live on {got}, engine device is "
                             f"{self.device}")
        if "dec_pos" in params and max_len > params["dec_pos"]["emb"].shape[0]:
            raise ValueError(f"max_len {max_len} exceeds the decoder's "
                             f"{params['dec_pos']['emb'].shape[0]} learned "
                             f"positions")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.backend = backend
        self.dtype = dtype
        self.kv_quant = kv_quant      # int8 K/V with per-row scales
        self.graphs = StepGraphs(self.device) if graphs else None
        self._lane: Optional[Dict[str, torch.Tensor]] = None

    # ------------------------------------------------------------------ api
    def new_cache(self, batch_size: int):
        return M.init_cache(self.cfg, batch_size, self.max_len, self.dtype,
                            self.device,
                            enc_len=self.cfg.encoder_seq_len or None,
                            kv_quant=self.kv_quant)

    def new_paged_cache(self, lanes: int, num_blocks: int, block_size: int):
        """Paged cache sized so one lane can hold up to ``max_len`` context."""
        mb = kv_blocks_needed(self.max_len, block_size)
        return M.init_paged_cache(self.cfg, lanes, num_blocks, block_size,
                                  self.dtype, self.device,
                                  max_blocks_per_lane=mb,
                                  kv_quant=self.kv_quant)

    def _run(self, name: str, step, inputs, cache):
        if self.graphs is None:
            return step(cache, **inputs)
        return self.graphs.run(name, step, inputs, cache)

    def prefill_chunk(self, tokens: torch.Tensor, cache, lane, n_valid):
        """Chunked prefill of one lane (see ``model.prefill_paged_chunk``).
        ``lane``/``n_valid`` are ints or 0-d int32 device tensors, copied
        into the step's buffers: one capture per chunk shape, not per lane
        or valid count."""
        return self._run("prefill_chunk", self._prefill_chunk,
                         {"tokens": tokens, "lane": lane, "n_valid": n_valid},
                         cache)

    def _prefill_chunk(self, cache, tokens, lane, n_valid):
        return M.prefill_paged_chunk(self.params, self.cfg, tokens, cache,
                                     lane=lane, n_valid=n_valid,
                                     backend=self.backend)

    def decode_paged(self, tokens: torch.Tensor, cache, lanes: torch.Tensor):
        """One decode step of the (n,) int64 ``lanes``, -1 for padding
        (``model.decode_step_paged``): logits (n, V), one capture per n."""
        return self._run("decode_paged", self._decode_paged,
                         {"tokens": tokens, "lanes": lanes}, cache)

    def _decode_paged(self, cache, tokens, lanes):
        return M.decode_step_paged(self.params, self.cfg, tokens, cache,
                                   lanes=lanes, backend=self.backend)

    def lane_cache(self):
        """One single-lane cache for the batchers to prefill into and
        splice from: a captured prefill writes the same buffers each time."""
        if self._lane is None:
            self._lane = self.new_cache(1)
        return self._lane

    def prefill(self, batch: Dict[str, torch.Tensor], cache=None):
        """``batch["n_valid"]`` (an int or 0-d int32 device tensor) with
        ``tokens`` (1, S): the prompt is the first n_valid tokens, padded
        to S (``model.prefill``), and the step runs captured."""
        B = batch["tokens"].shape[0]
        if cache is None:
            cache = self.new_cache(B)
        if "n_valid" in batch:
            return self._run("prefill", self._prefill_padded,
                             {"tokens": batch["tokens"],
                              "n_valid": batch["n_valid"]}, cache)
        return M.prefill(self.params, self.cfg, batch, cache,
                         backend=self.backend)

    def _prefill_padded(self, cache, tokens, n_valid):
        n_valid = torch.as_tensor(n_valid, dtype=torch.int32,
                                  device=self.device)
        return M.prefill(self.params, self.cfg, {"tokens": tokens}, cache,
                         backend=self.backend, n_valid=n_valid)

    def decode(self, tokens: torch.Tensor, cache):
        return self._run("decode", self._decode, {"tokens": tokens}, cache)

    def _decode(self, cache, tokens):
        return M.decode_step(self.params, self.cfg, tokens, cache,
                             backend=self.backend)

    def generate(self, batch: Dict[str, torch.Tensor], max_new_tokens: int = 32,
                 *, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 eos_id: Optional[int] = None) -> GenerationResult:
        """Greedy (or sampled) generation. All requests share prompt length;
        ``vision`` or ``frames`` in the batch go to prefill with the tokens.

        With temperature > 0 and no generator, a generator seeded with 0 on
        the engine's device is used, so sampling is reproducible by default.
        Sampled tokens cannot match the reference's (JAX PRNG bits).
        """
        if temperature > 0.0 and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        tokens = torch.as_tensor(batch["tokens"], dtype=torch.int32,
                                 device=self.device)
        S = tokens.shape[1]
        # vision / frames embeddings, in the engine's dtype
        inputs = {k: torch.as_tensor(v, device=self.device).to(self.dtype)
                  for k, v in batch.items() if k != "tokens"}
        logits, cache = self.prefill({"tokens": tokens, **inputs})
        out = []
        tok = self._select(logits, temperature, generator)
        out.append(tok)
        for _ in range(max_new_tokens - 1):
            logits, cache = self.decode(tok[:, None], cache)
            tok = self._select(logits, temperature, generator)
            out.append(tok)
            # deliberate per-token sync: early EOS exit saves whole decode
            # steps, which dwarfs the transfer cost at batch scale
            # repro-lint: allow[torch-host-sync]
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

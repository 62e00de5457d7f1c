"""Training: the loss, the train step and the loop (counterpart of
``repro/training/train.py``).

The step is eager, as the port's engine is: autograd over
``model.forward_train`` gives the gradients (through K1 and K1-bwd on the
card), then ``optimizer.apply_updates`` makes new params and state. Params
go in and come out as plain tensors, like the reference's pytrees; the
step marks its own copies as requiring grad.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.training import optimizer as OPT

LOSS_IMPLS = ("softmax", "logsumexp")


def _nll(pred: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Per-position negative log likelihood, by ``REPRO_LOSS_IMPL``:
      softmax   — the full (B, S, V) float32 log_softmax (the default)
      logsumexp — logsumexp(logits) - logits[target]: (B, S) temporaries
    """
    impl = os.environ.get("REPRO_LOSS_IMPL", "softmax")
    if impl not in LOSS_IMPLS:
        raise ValueError(f"REPRO_LOSS_IMPL={impl!r} not in {LOSS_IMPLS}")
    tgt = tgt.long()[..., None]
    if impl == "softmax":
        logp = torch.log_softmax(pred.float(), dim=-1)
        return -torch.gather(logp, -1, tgt)[..., 0]
    predf = pred.float()
    lse = torch.logsumexp(predf, dim=-1)                        # (B, S)
    return lse - torch.gather(predf, -1, tgt)[..., 0]


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            backend: str = "auto", remat: bool = False
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy, plus the MoE aux loss.

    batch["tokens"] (B, S): positions 1..S-1 are predicted from 0..S-2.
    batch["loss_mask"] optional (B, S): 1 where the *target* counts.
    VLM: the loss applies to text positions only (vision tokens are inputs).
    """
    logits, aux = M.forward_train(params, cfg, batch, backend=backend,
                                  remat=remat)
    tokens = batch["tokens"]
    n_vis = logits.shape[1] - tokens.shape[1]      # 0 except VLM
    logits = logits[:, n_vis:]                     # text-aligned
    nll = _nll(logits[:, :-1], tokens[:, 1:])
    mask = batch.get("loss_mask")
    mask = torch.ones_like(nll) if mask is None else mask[:, 1:].float()
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + aux, {"ce": loss, "aux": aux}


def loss_and_grads(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   *, backend: str = "auto", remat: bool = False):
    """(loss, parts, grads): ``lm_loss`` at ``params`` and its gradient, a
    tree of the params' structure (zeros for a leaf the loss does not reach,
    as ``jax.grad`` gives). ``params`` itself is not touched: the gradient
    is taken on detached copies that require grad."""
    live = OPT.tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = OPT.tree_leaves(live)
    with torch.enable_grad():
        loss, parts = lm_loss(live, cfg, batch, backend=backend, remat=remat)
        flat = torch.autograd.grad(loss, leaves, allow_unused=True)
    flat = [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, flat)]
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            OPT.tree_unflatten(params, flat))


def make_train_step(cfg: ModelConfig, opt: OPT.AdamWConfig, *,
                    backend: str = "auto", remat: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). On the card every family trains through kernels that have a
    backward (K1 with K1-bwd, K5 with K5-bwd); the decode-only kernels
    (K2–K4) raise under grad rather than return outputs without gradients,
    and a training step never calls them."""

    def train_step(params, opt_state, batch):
        loss, parts, grads = loss_and_grads(params, cfg, batch,
                                            backend=backend, remat=remat)
        params, opt_state, om = OPT.apply_updates(opt, params, grads,
                                                  opt_state)
        return params, opt_state, {"loss": loss, **parts, **om}

    return train_step


def train_loop(cfg: ModelConfig, params, batches, opt: OPT.AdamWConfig, *,
               backend: str = "auto", remat: bool = False,
               log_every: int = 10, log=print):
    """Steps over ``batches``; logs (and keeps in the history) the loss of
    every ``log_every``-th step, the only host syncs of the loop."""
    step_fn = make_train_step(cfg, opt, backend=backend, remat=remat)
    state = OPT.init_state(params)
    history = []
    for i, batch in enumerate(batches):
        params, state, m = step_fn(params, state, batch)
        if i % log_every == 0:
            loss = float(m["loss"])
            history.append((i, loss))
            log(f"step {i:5d}  loss {loss:.4f}  lr {float(m['lr']):.2e}  "
                f"gnorm {float(m['grad_norm']):.2f}")
    return params, state, history

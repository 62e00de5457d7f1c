"""Whether what the timed path served is correct.

Once the window has closed, a sample of the finished requests, drawn from
the seed and holding the longest finished request of each pool, is
compared with the plain float32 reference: the reference runs once over
each prompt with its served tokens, and at every served token reads the
gap by which that token's logit lies below the reference's best there.
The widest gap over the sample is held to the configuration's limit
(``max_logit_gap``), and, where the configuration sets
``max_mean_gap``, so is the mean gap over every served token of the
sample. Greedy decoding serves the argmax, so a sound program's gaps are
rounding-sized near-ties, zero at most tokens; a wrong cache, step, lane
or kernel serves tokens far below the best. The widest gap catches one
token served wrong; the mean, a precision lost at every step, whose
widest near-tie can lie within a few times bf16's (mistral-7b: PERF.md).

Besides: the router's pool choice for every routed request, recomputed
plainly (the efficiency pool exactly when m <= t_in), and the served
token count of every sampled request (its budget: no stop token).

``control``: the reference itself in int8 (every linear layer on int8
operands) read in the program's place: at each position of the same
prompts and tokens, the gap of the token that int8 puts first.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from serve_bench.traffic import Req


def sample(reqs: List[Req], seed: int, n_pick: int) -> List[Req]:
    done = [r for r in reqs if r.req is not None and r.req.done]
    picks: List[Req] = []
    for pool in sorted({r.pool for r in done}):
        mine = [r for r in done if r.pool == pool]
        picks.append(max(mine, key=lambda r: (len(r.req.out_tokens), -r.idx)))
    rest = [r for r in done if r not in picks]
    rng = np.random.default_rng((int(seed) + 0x5EED) % 2 ** 64)
    take = min(len(rest), max(0, n_pick - len(picks)))
    for j in rng.choice(len(rest), size=take, replace=False):
        picks.append(rest[int(j)])
    return picks


def _inputs(picks: List[Req], device) -> Tuple[List[torch.Tensor], List[int]]:
    seqs, starts = [], []
    for r in picks:
        out = np.asarray(r.req.out_tokens, dtype=np.int64)
        seq = np.concatenate([r.prompt.astype(np.int64), out[:-1]])
        seqs.append(torch.from_numpy(seq).to(device))
        starts.append(r.m - 1)
    return seqs, starts


def gaps(ref, weights: Dict, model: Dict, picks: List[Req], device,
         control: bool = False) -> Dict:
    """The widest served-token gap of the sample (and, with ``control``,
    the int8 control's widest gap on the same positions)."""
    seqs, starts = _inputs(picks, device)
    want = ref.forward(weights, model, seqs, starts)
    served, widest, total = [], 0.0, 0.0
    for r, lg in zip(picks, want):
        tok = torch.as_tensor(r.req.out_tokens, dtype=torch.long,
                              device=lg.device)
        g = lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]
        widest = max(widest, float(g.max()))
        total += float(g.double().sum())
        served.append(len(tok))
    n = int(sum(served))
    out = {"logit_gap": widest, "mean_gap": total / n if n else 0.0,
           "tokens": n, "requests": len(picks)}
    if control:
        low = ref.forward(weights, model, seqs, starts, quant="int8")
        cg, ct = 0.0, 0.0
        for lg, lq in zip(want, low):
            tok = lq.argmax(-1)
            g = lg.max(-1).values - lg.gather(1, tok[:, None])[:, 0]
            cg = max(cg, float(g.max()))
            ct += float(g.double().sum())
        out["control_gap"] = cg
        out["control_mean_gap"] = ct / n if n else 0.0
    return out


def routing_errors(reqs: List[Req], eff: str, perf: str, t_in: int) -> int:
    return sum(1 for r in reqs if r.pool is not None
               and r.pool != (eff if r.m <= t_in else perf))


def short_outputs(picks: List[Req]) -> int:
    return sum(1 for r in picks if len(r.req.out_tokens) != r.n)

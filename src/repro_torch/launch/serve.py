"""Serving entry point: hybrid-fleet router + the torch engine.

``python -m repro_torch.launch.serve --arch smollm-360m --requests 20``
(any family the router serves by tokens: ``--arch phi3.5-moe-42b-a6.6b``
or ``--arch grok-1-314b`` serve the MoE models, ``--arch mamba2-130m`` or
``--arch zamba2-1.2b`` the SSM and hybrid ones, reduced as in
``repro.launch.serve``; the VLM and audio families are served through
``InferenceEngine.generate``)

Routes an Alpaca-like request stream across an (efficiency, performance)
pool pair with the paper's scheduler, executes every request on the engine,
and prints the fleet energy/runtime report. Same flags as
``repro.launch.serve`` plus ``--device``: the card by default, ``cpu`` to
run the plain path on the host. Weights are random, from ``--seed``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.systems import paper_fleet, tpu_fleet
from repro_torch.core.workload import sample_workload
from repro_torch.models import model as M
from repro_torch.serving.engine import InferenceEngine, resolve_device
from repro_torch.serving.router import FleetRouter


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--policy", default="threshold",
                    choices=("threshold", "cost_optimal", "capacity_aware"))
    ap.add_argument("--t-in", type=int, default=32)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--fleet", default="tpu", choices=("tpu", "paper"))
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=device)
    engine = InferenceEngine(cfg, params, max_len=512, device=device)
    eff, perf = tpu_fleet() if args.fleet == "tpu" else paper_fleet()
    router = FleetRouter(cfg, {eff.name: eff, perf.name: perf},
                         {eff.name: engine, perf.name: engine},
                         policy=args.policy, t_in=args.t_in, lam=args.lam,
                         counts={eff.name: 4, perf.name: 1})
    rng = np.random.default_rng(args.seed)
    for q in sample_workload(args.requests, seed=args.seed):
        m = min(q.m, 400)
        prompt = rng.integers(0, cfg.vocab_size, size=m)
        res = router.submit(prompt, min(args.max_new_tokens, q.n))
        print(f"req{res.rid:4d} m={m:5d} n={min(args.max_new_tokens, q.n):4d} "
              f"-> {res.pool:16s} E={res.energy_j:8.2f}J R={res.runtime_s:6.3f}s "
              f"tokens={res.output[:8] if res.output is not None else None}")
    print("\nfleet report:")
    for pool, st in router.fleet_report().items():
        print(f"  {pool:16s} queries={st['queries']:4d} "
              f"energy={st['energy_j']:10.1f}J runtime={st['runtime_s']:8.2f}s")


if __name__ == "__main__":
    main()

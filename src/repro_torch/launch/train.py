"""Training entry point: ``python -m repro_torch.launch.train --arch <id>``.

The same flags as ``repro.launch.train`` plus ``--device``: the card by
default, ``cpu`` to train on the host's plain path. Reduced configs unless
``--full-config``; random float32 weights from ``--seed``. Prints the loss,
learning rate and gradient norm every ``steps // 20`` steps, then the
steps' wall time and tokens per second; ``--checkpoint`` writes the params
and AdamW state in the format ``repro.training.checkpoint`` reads.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.serving.engine import resolve_device
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import data as D
from repro_torch.training import optimizer as OPT
from repro_torch.training.train import train_loop


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (not reduced) architecture config")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--data", choices=("arithmetic", "uniform"),
                    default="arithmetic")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a card)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, log=print) -> dict:
    """Train as the flags say; returns the config, the trained params and
    AdamW state, the logged (step, loss) history, the wall seconds of the
    steps and their tokens per second."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    log(f"[train] arch={cfg.name} family={cfg.family} params~"
        f"{cfg.param_count() / 1e6:.1f}M reduced={not args.full_config} "
        f"device={device}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = M.init_params(cfg, gen, torch.float32, device,
                           max_positions=max(args.seq_len + 1, 256))
    opt = OPT.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps)
    stream = (D.arithmetic_stream if args.data == "arithmetic" else
              D.uniform_stream)(cfg, args.batch_size, args.seq_len,
                                args.steps, seed=args.seed, device=device)
    t0 = time.perf_counter()
    params, state, hist = train_loop(cfg, params, stream, opt,
                                     remat=args.remat,
                                     log_every=max(args.steps // 20, 1),
                                     log=log)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = args.steps * args.batch_size * args.seq_len
    log(f"[train] {args.steps} steps in {dt:.1f}s "
        f"({toks / dt:.0f} tok/s); loss {hist[0][1]:.3f} -> "
        f"{hist[-1][1]:.3f}")
    if args.checkpoint:
        CKPT.save(args.checkpoint, params, state,
                  {"arch": cfg.name, "steps": args.steps,
                   "final_loss": hist[-1][1]})
        log(f"[train] checkpoint -> {args.checkpoint}")
    return {"cfg": cfg, "params": params, "state": state, "history": hist,
            "seconds": dt, "tok_s": toks / dt}


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()

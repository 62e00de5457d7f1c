#!/usr/bin/env python3
"""Time K1's float32 forward and K1-bwd of two checkouts of this repository
on one card, in turns (old, new, new, old), at the training shapes.

    python3 scripts/k1_train_ab.py --old build/parent --new .

Each turn is a fresh process that imports the checkout's ``repro_torch``
(so each builds its own kernels into its own ``build/``) and prints one
JSON line; the last line is the table of all four. Shapes, float32, causal,
S 512: smollm-360m's (B 8, 15 query heads on 5 KV heads, D 64) and
zamba2-1.2b's (B 2, 32 heads, no grouping, D 64, window 8192). K1 is timed
as training calls it (with its lse where the checkout's K1 writes one) by
CUDA-graph replay of 20 calls, 10 times; K1-bwd as the mean of 20 eager
calls between CUDA events; SDPA's forward and backward beside them, on K/V
expanded to the query heads (yardsticks the port never calls). Needs a
card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = {"smollm-360m": (8, 15, 5, 64, None),
          "zamba2-1.2b": (2, 32, 32, 64, 8192)}
S = 512


def graph_ms(torch, fn, calls=20, replays=10):
    """Device ms of one call: ``calls`` calls captured in a CUDA graph and
    replayed ``replays`` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def eager_ms(torch, fn, reps=20):
    """Mean device ms of ``reps`` eager calls between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def one_tree(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("k1_train_ab: no CUDA device")
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    from repro_torch.kernels import flash_attention as FA
    with_lse = hasattr(FA, "_flash_attention_fwd")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"tree": str(tree), "with_lse": with_lse}
    for arch, (B, hq, hkv, d, window) in SHAPES.items():
        kw = dict(causal=True, window=window)
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda")
                       for s in ((B, hq, S, d), (B, hkv, S, d),
                                 (B, hkv, S, d), (B, hq, S, d)))
        if with_lse:
            fwd = lambda: FA._flash_attention_fwd(q, k, v, **kw)  # noqa: E731
            o, lse = fwd()
            bwd = lambda: FA.flash_attention_bwd(  # noqa: E731
                q, k, v, o, do, lse, **kw)
        else:
            fwd = lambda: FA.flash_attention(q, k, v, **kw)  # noqa: E731
            o = fwd()
            bwd = lambda: FA.flash_attention_bwd(  # noqa: E731
                q, k, v, o, do, **kw)
        err = (o - FA.flash_attention_ref(q, k, v, **kw)).abs().max().item()
        leaves = [t.clone().requires_grad_(True) for t in
                  (q, k.repeat_interleave(hq // hkv, 1),
                   v.repeat_interleave(hq // hkv, 1))]
        with torch.enable_grad():
            sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True)
        out[arch] = dict(
            k1_ms=graph_ms(torch, fwd), k1_bwd_ms=eager_ms(torch, bwd),
            sdpa_ms=graph_ms(torch, lambda: F.scaled_dot_product_attention(
                q, leaves[1].detach(), leaves[2].detach(), is_causal=True)),
            sdpa_bwd_ms=eager_ms(torch, lambda: torch.autograd.grad(
                sdpa, leaves, do, retain_graph=True)),
            k1_err=err)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, help="the older checkout")
    ap.add_argument("--new", type=Path, help="the newer checkout")
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree is not None:
        print(json.dumps(one_tree(args.tree.resolve())), flush=True)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    runs = []
    for label, tree in (("old", args.old), ("new", args.new),
                        ("new", args.new), ("old", args.old)):
        p = subprocess.run([sys.executable, __file__, "--tree", str(tree)],
                           capture_output=True, text=True)
        if p.returncode != 0:
            sys.exit(f"k1_train_ab: the {label} turn failed:\n{p.stderr}")
        r = json.loads(p.stdout.strip().splitlines()[-1])
        r["turn"] = label
        runs.append(r)
        print(json.dumps(r), flush=True)
    for arch in SHAPES:
        for key in ("k1_ms", "k1_bwd_ms", "sdpa_ms", "sdpa_bwd_ms"):
            print(f"{arch:12s} {key:12s} " + " ".join(
                f"{r['turn']}={r[arch][key]:.4f}" for r in runs), flush=True)
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the training kernels (K1's and K5's float32 forwards, K1-bwd and
K5-bwd) of two checkouts of this repository on one card, in turns (old,
new, new, old), at the training shapes.

    python3 scripts/train_kernels_ab.py --old build/parent --new .

Each turn is a fresh process that imports the checkout's ``repro_torch``
(so each builds its own kernels into its own ``build/``) and prints one
JSON line; the last line is the table of all four. Shapes, float32, S 512.
K1: smollm-360m's (B 8, 15 query heads on 5 KV heads, D 64, causal) and
zamba2-1.2b's shared block's (B 2, 32 heads, no grouping, D 64, window
8192). K5: mamba2-130m's (B 8, H 24, P 64, N 128, chunk 128) and
zamba2-1.2b's (B 2, H 64, P 64, N 64, chunk 128), and K5 in bf16 at one
lane of the same (B 1), the serving path's prefill. The forwards are timed
as training calls them (K1 with its lse where the checkout's K1 writes
one) by CUDA-graph replay of 20 calls, 10 times, K5 also by pass; the
backwards as the mean of 20 eager calls between CUDA events, K5-bwd also
by kernel (a torch.profiler trace); SDPA's forward and backward beside K1's,
on K/V expanded to the query heads (yardsticks the port never calls). Each
kernel's worst error against its plain version is printed beside its time.
Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# the smoke's timers: CUDA-graph replay, eager calls between CUDA events,
# device time by kernel from a torch.profiler trace
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import _eager_ms as eager_ms  # noqa: E402
from chip_smoke import _kernel_split as kernel_split  # noqa: E402
from chip_smoke import time_ms as graph_ms  # noqa: E402

SHAPES = {"smollm-360m": (8, 15, 5, 64, None),
          "zamba2-1.2b": (2, 32, 32, 64, 8192)}
# (B, H, P, N, chunk) of K5 at the SSM training shapes
SSD_SHAPES = {"mamba2-130m": (8, 24, 64, 128, 128),
              "zamba2-1.2b": (2, 64, 64, 64, 128)}
S = 512


def ssd_rows(torch, gen) -> dict:
    """K5's float32 forward (graph replay, and by pass) and K5-bwd (eager,
    and by kernel) at the SSM training shapes, each with its worst error
    against its plain version; K5's bf16 forward at one lane (graph
    replay)."""
    from repro_torch.kernels import ssm_scan as SS
    out = {}
    for arch, (B, H, P, N, L) in SSD_SHAPES.items():
        x = torch.randn((B, H, S, P), generator=gen, device="cuda")
        dt = torch.rand((B, H, S), generator=gen, device="cuda") * 0.2 + 0.001
        A = -(torch.rand((H,), generator=gen, device="cuda") * 3.5 + 0.5)
        Bm, Cm = (torch.randn((B, S, N), generator=gen, device="cuda")
                  for _ in range(2))
        dy = torch.randn((B, H, S, P), generator=gen, device="cuda")
        inp = (x, dt, A, Bm, Cm)
        ws = SS.workspace(x, N, L)
        y, fs = SS.ssd_scan(*inp, chunk=L, ws=ws)
        want_y, want_fs = SS.ssd_scan_ref(*inp, chunk=L)
        got = SS.ssd_scan_bwd(*inp, dy, chunk=L, ws=ws)
        want = SS.ssd_scan_bwd_ref(*inp, dy, chunk=L)
        passes = {name: graph_ms(torch, lambda bit=bit: SS.launch_passes(
            *inp, chunk=L, passes=bit, ws=ws)) for name, bit in
            SS.PASSES.items()}
        SS.launch_passes(*inp, chunk=L, ws=ws)    # the scan rewrote ws
        # the serving path's bf16 K5: one layer's 512-token prefill, B 1
        serve = (x[:1].bfloat16(), dt[:1], A,
                 Bm[:1].bfloat16(), Cm[:1].bfloat16())
        out[arch] = dict(
            k5_bf16_serve_ms=graph_ms(torch, lambda: SS.ssd_scan(
                *serve, chunk=L)),
            k5_ms=graph_ms(torch, lambda: SS.ssd_scan(*inp, chunk=L)),
            k5_bwd_ms=eager_ms(torch, lambda: SS.ssd_scan_bwd(
                *inp, dy, chunk=L, ws=ws)),
            k5_err=max((y - want_y).abs().max().item(),
                       (fs - want_fs).abs().max().item()),
            k5_bwd_err=max((g - w).abs().max().item()
                           / max(1.0, w.abs().max().item())
                           for g, w in zip(got, want)),
            k5_passes=passes,
            k5_bwd_kernels=kernel_split(torch, lambda: SS.ssd_scan_bwd(
                *inp, dy, chunk=L, ws=ws), r"ssd_bwd_(\w+?)_kernel"))
    return out


def one_tree(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("train_kernels_ab: no CUDA device")
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
    for arch, row in ssd_rows(torch, gen).items():
        out.setdefault(arch, {}).update(row)
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
            sys.exit(f"train_kernels_ab: the {label} turn failed:\n{p.stderr}")
        r = json.loads(p.stdout.strip().splitlines()[-1])
        r["turn"] = label
        runs.append(r)
        print(json.dumps(r), flush=True)
    for arch in {**SHAPES, **SSD_SHAPES}:
        for key in ("k1_ms", "k1_bwd_ms", "sdpa_ms", "sdpa_bwd_ms", "k5_ms",
                    "k5_bwd_ms", "k5_bf16_serve_ms"):
            if key in runs[0][arch]:
                print(f"{arch:12s} {key:12s} " + " ".join(
                    f"{r['turn']}={r[arch][key]:.4f}" for r in runs),
                    flush=True)
    print(json.dumps({"card": card, "runs": runs}))


if __name__ == "__main__":
    main()

"""The rate sweep that fixes a mix's rate (run by hand when a mix is
made, not a cell):

    python3 serve_bench/sweep.py --workload <name> --rates 4,8,12 \
        --seconds 15 [--set serving.slots=128 ...]

One process: the cell's weights once, then for each rate a fresh program
(router, batchers, KV pools, captures), the ramp and a window at that
rate with the cell's mix otherwise. One line a rate: requests due and
first-served in the window, TTFT and token-gap percentiles, output tokens
a second, the backlog (queued and in-flight requests) at the window's
end, the most lanes busy, the KV blocks a paged pool held at its peak
against those it has, and the allocator's peak. The knee is the highest
rate whose backlog does not grow. ``--set`` overrides a key of the
configuration (a dotted path, a JSON value) for the whole sweep.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=101)
    ap.add_argument("--steady", type=int, default=0,
                    help="1: Poisson arrivals in place of the mix's process")
    ap.add_argument("--set", action="append", default=[],
                    help="<dotted.key>=<json>: override a configuration key")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch
    from serve_bench import harness as H
    from serve_bench import traffic as T
    from serve_bench.bench import find_cell

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = find_cell(bench, args.workload, ROOT)
    cfg, mix = json.loads(json.dumps(cell.config)), cell.traffic
    for kv in args.set:
        key, val = kv.split("=", 1)
        *path, last = key.split(".")
        d = cfg
        for k in path:
            d = d[k]
        d[last] = json.loads(val)
    print(json.dumps({"serving": cfg["serving"]}), flush=True)
    if args.steady:
        mix = dict(mix, arrivals={"process": "poisson",
                                  "rate_qps": mix["arrivals"]["rate_qps"]})
    model = cfg["model"]
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    weights = cell.reference.make_weights(model, gen, H.DTYPES[cfg["dtype"]],
                                          device)
    for rate in [float(r) for r in args.rates.split(",")]:
        torch.cuda.reset_peak_memory_stats(device)
        prog = H.build(cfg, weights, device)
        H.warm(prog, cfg, model["vocab_size"])
        reqs = T.make_requests(mix, args.seed, model["vocab_size"],
                               mix["ramp_s"] + args.seconds, rate)
        H.sync(device)
        sv, _ = H.serve(prog, reqs, mix["ramp_s"], args.seconds,
                        device=device)
        win = H.window_reqs(sv)
        tt = np.asarray(H.ttfts(sv)) * 1e3
        gaps = np.asarray(sv.gaps) * 1e3
        out_tok = sum(sum(1 for s in r.stamps if sv.ramp <= s < sv.end)
                      for r in sv.reqs)
        queued = sum(len(cb.queue) for cb in prog.router.batchers.values())
        active = sum(sum(1 for a in cb.active if a is not None)
                     for cb in prog.router.batchers.values())
        served = sum(1 for r in win if r.first_t is not None
                     and r.first_t < sv.end)
        late = H.lateness(sv)
        print(json.dumps({
            "rate": rate, "due": len(win), "first_served": served,
            "ttft_p50_ms": float(np.percentile(tt, 50)),
            "ttft_p95_ms": float(np.percentile(tt, 95)),
            "itl_p50_ms": float(np.percentile(gaps, 50)),
            "itl_p95_ms": float(np.percentile(gaps, 95)),
            "out_tok_s": out_tok / args.seconds,
            "queued_end": queued, "active_end": active,
            "ticks": sv.ticks, "late_max_ms": late["max_ms"],
            "most_active": sv.most_active,
            "blocks_peak_of": {n: [cb.stats()["peak_used"],
                                   cb.stats()["total_blocks"]]
                               for n, cb in prog.router.batchers.items()
                               if hasattr(cb, "stats")},
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}),
            flush=True)
        del prog, sv
        H.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())

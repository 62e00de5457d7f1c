"""Run one cell of the benchmark once:

    python3 serve_bench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``. It serves
the cell's traffic through the port on one card for ``--seconds`` after
set-up, checks what was served against the plain reference, and prints
one JSON line last on standard output: the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics and a breakdown (``--trace 1``).
The numbers compared for ``correct`` come last on standard error and
under ``checks``, last in the line.

``--control 1`` also reads the int8 control's gap on the same sample
and judges it as the program is judged, under ``control_correct``
(which has to come out false; the benchmark's runs never pass it).

Exit codes: 0 a result; 2 bad arguments; 3 no card (or fewer than the
cell asks for); 4 JAX or the JAX package loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def _env() -> None:
    """Caches inside the checkout, at fixed paths; nothing that would load
    JAX through a library."""
    build = ROOT / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def banned_modules():
    return sorted({k.split(".")[0] for k in sys.modules} & set(BANNED))


def card_info(device):
    import torch
    name = torch.cuda.get_device_name(device)
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    limit = None
    try:
        gpu = uuid if uuid.startswith("GPU-") else "GPU-" + uuid
        out = subprocess.run(
            ["nvidia-smi", f"--id={gpu}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        limit = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return name, uuid, limit


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, control: bool = False, hook=None):
    """One run of ``cell`` on ``device``. Returns the result dict (None
    when a banned module was loaded). ``hook(program)`` runs after the
    program is built (the fault tests break it there)."""
    import torch
    from serve_bench import check as CK
    from serve_bench import harness as H
    from serve_bench import traffic as T
    from serve_bench.energy import EnergyMeter

    cfg, mix = cell.config, cell.traffic
    model = cfg["model"]
    cuda = device.type == "cuda"
    name, uuid, limit = card_info(device) if cuda else ("cpu", "", None)
    say(f"cell {cell.name}: {cfg['name']} x {cell.traffic_name}, seed {seed}"
        f", {seconds} s, trace {int(trace)}; card {name}, power limit "
        f"{limit} W")
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)
    weights = cell.reference.make_weights(model, gen, H.DTYPES[cfg["dtype"]],
                                          device)
    prog = H.build(cfg, weights, device)
    if hook is not None:
        hook(prog)
    H.warm(prog, cfg, model["vocab_size"])
    if trace:
        H.warm_profiler(device)
    reqs = T.make_requests(mix, seed, model["vocab_size"],
                           mix["ramp_s"] + seconds)
    meter = EnergyMeter(uuid) if cuda and not trace else None
    H.sync(device)
    sv, tracer = H.serve(prog, reqs, mix["ramp_s"], seconds, device=device,
                         meter=meter, trace=trace,
                         slice_s=mix["trace_slice_s"])
    setup_s = sv.t0 + sv.ramp - t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    win = H.window_reqs(sv)
    failed = sum(1 for r in win if r.failed is not None)
    late = H.lateness(sv)
    by_pool = {}
    for r in win:
        by_pool[r.pool] = by_pool.get(r.pool, 0) + 1
    say(f"window: {len(win)} requests due ({by_pool}), {failed} refused, "
        f"{sv.ticks} ticks in all, {len(sv.gaps)} token gaps; generator "
        f"late p50 {late['p50_ms']:.3f} ms, max {late['max_ms']:.3f} ms; "
        f"set-up {setup_s:.3f} s (ramp {sv.ramp} s); peak "
        f"{peak} bytes")

    pct = (50, 90, 95, 99, 100)

    def marks(values):
        v = sorted(values)
        return [round(v[min(len(v) - 1, len(v) * p // 100)] * 1e3, 1)
                for p in pct] if v else []
    say(f"ttft ms p{pct}: {marks(H.ttfts(sv))}; token gap ms: "
        f"{marks(sv.gaps)}; most lanes busy {sv.most_active}, most queued "
        f"{sv.most_queued}")
    for pool, cb in prog.router.batchers.items():
        say(f"cache {pool}: " + H.cache_use(
            cb, cfg["serving"]["max_len"], sv.most_rows.get(pool, 0),
            sv.most_active.get(pool, 0)))
    metrics = {}
    device_rec = {"platform": "gpu" if cuda else "cpu", "kind": name,
                  "count": 1, "memory_peak_bytes": int(peak)}
    extra = {}
    if not trace:
        tt = H.ttfts(sv)
        values = {"setup_s": setup_s,
                  "ttft_p95_ms": H.p95(tt) * 1e3,
                  "ttft_mean_ms": sum(tt) / len(tt) * 1e3 if tt else None,
                  "itl_p95_ms": H.p95(sv.gaps) * 1e3 if sv.gaps else None}
        if meter is not None and sv.tokens_in_e:
            values["joules_per_token"] = meter.joules / sv.tokens_in_e
            note = f"; {meter.note}" if meter.note else ""
            say(f"energy: {meter.joules:.3f} J over "
                f"{sv.e_t1 - sv.e_t0:.3f} s ({meter.source}{note}), "
                f"{sv.tokens_in_e} prompt and output tokens")
        say("end-to-end quantities: " + ", ".join(
            f"{k} {v}" for k, v in values.items()))
        for mt in cell.end_to_end:
            # "<quantity>.<suffix>" is the quantity in the cells it lists
            v = values.get(mt["name"].split(".")[0])
            if v is not None:
                metrics[mt["name"]] = {"value": v, "unit": mt["unit"]}
    else:
        prof = H.read_profile(sv.prof) if sv.prof is not None else \
            H.Profile([], [], [])
        tr = H.Trace(cfg, sv, tracer.spans, tracer.calls, prof,
                     sv.launches, limit)
        for mt in cell.per_layer:
            v = cell.readers[mt["name"]](tr)
            if v is not None:
                metrics[mt["name"]] = {"value": v, "unit": mt["unit"]}
        busy = H.union([(a, b) for a, b, _ in prof.device])
        device_rec["busy_s"] = sum(b - a for a, b in busy) * 1e-6
        device_rec["window_s"] = tr.slice_s
        extra["breakdown"] = H.breakdown(prof)
        say(f"trace: slice {tr.slice_s:.3f} s (the profiler took "
            f"{sv.prof_start_s:.3f} s to start), {len(prof.kernels)} kernels"
            f", launches {sv.launches}")
        tracer.prog = None
        del tr, prof
    sv.prof = None

    picks = CK.sample(sv.reqs, seed, cfg["correct"]["sample_requests"])
    routing = CK.routing_errors(sv.reqs, prog.eff, prog.perf, prog.t_in)
    short = CK.short_outputs(picks)
    del prog, tracer
    H.free()
    t_ref = H.clock()
    g = CK.gaps(cell.reference, weights, model, picks, device, control)
    say(f"reference: {g['requests']} requests, {g['tokens']} served tokens, "
        f"{H.clock() - t_ref:.3f} s; mean gap {g['mean_gap']}")
    limit_gap = cfg["correct"]["max_logit_gap"]
    limit_mean = cfg["correct"].get("max_mean_gap")
    checks = {"logit_gap": {"value": g["logit_gap"], "limit": limit_gap}}
    if limit_mean is not None:
        checks["mean_logit_gap"] = {"value": g["mean_gap"],
                                    "limit": limit_mean}
    checks.update({"routing_errors": {"value": routing, "limit": 0},
                   "short_outputs": {"value": short, "limit": 0},
                   "sampled_requests": {"value": g["requests"], "limit": 1}})
    if control:
        checks["control_gap"] = {"value": g["control_gap"],
                                 "limit": limit_gap}
        if limit_mean is not None:
            checks["control_mean_gap"] = {"value": g["control_mean_gap"],
                                          "limit": limit_mean}

    def verdict(gap, mean):
        return bool(gap <= limit_gap
                    and (limit_mean is None or mean <= limit_mean)
                    and routing == 0 and short == 0
                    and g["requests"] >= 1 and failed == 0)
    correct = verdict(g["logit_gap"], g["mean_gap"])
    bad = banned_modules()
    if bad:
        say(f"loaded in this process: {bad}; no result")
        return None
    for k, c in checks.items():
        say(f"check {k}: {c['value']} (limit {c['limit']})")
    out = {"correct": correct, "attempted": len(win), "failed": failed,
           "metrics": metrics, "device": device_rec, **extra,
           "generator_late_ms": late}
    if control:
        # the control judged as the program is: it has to come out false
        out["control_correct"] = verdict(g["control_gap"],
                                         g["control_mean_gap"])
        say(f"control: correct {out['control_correct']}")
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from serve_bench.bench import find_cell

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = find_cell(bench, args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = run(cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=device, t_start=T_START,
              control=bool(args.control))
    if res is None:
        return 4
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

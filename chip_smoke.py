#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

  1. device  — card name, count, and nvidia-smi's name and power limit;
  2. build   — the Hopper kernels of src/repro_torch/csrc, built with nvcc
               (build seconds and -Xptxas -v output);
  3. kernels — K1 flash prefill, K2 dense decode and K3 paged decode held
               against their plain versions at mistral-7b's attention shapes
               (tolerances bf16 2e-2, f32 2e-5, rows with a valid key only),
               then timed at the serving path's shapes beside the plain
               version, one PyTorch library call where one computes the same
               function, and the card's bound;
  4. parity  — full-width mistral-7b cut to 2 layers, float32, same seeded
               weights: the kernel path against the plain path over prefill
               plus 8 decode steps, through the dense engine and the paged
               batcher (logits within 1e-3, greedy tokens identical);
  5. serve   — full mistral-7b (32 layers, bf16, random weights from a seed)
               behind FleetRouter(capacity_aware) over paper_fleet(): 8
               requests through paged batchers and 2 through the engine-only
               path; every kernel's launch count in this phase must be > 0.

The line before the last is one JSON object with each kernel's numbers; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the repository beside this file, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
# mistral-7b attention: 32 query heads, 8 KV heads, head dim 128
HQ, HKV, D = 32, 8, 128
M_CAP, N_CAP = 512, 32        # serve phase: prompt and output caps
MAX_LEN = M_CAP + N_CAP       # engine context on the serving path


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------- phase 1
def phase_device(torch):
    say("== phase 1: device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"device: {name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    say(f"nvidia-smi: {card}")
    return name, count, card


# --------------------------------------------------------------------- phase 2
def phase_build():
    say("== phase 2: build")
    from repro_torch.kernels import _build
    info = _build.build_info()
    say(f"library: {info.path} built={info.built} "
        f"build_seconds={info.seconds:.2f}")
    if info.log:
        say(info.log.rstrip())


# --------------------------------------------------------------------- phase 3
def _rand(torch, gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _err_on_valid(torch, got, want, rows_valid, tol):
    """max |got - want| over rows with a valid key; fails beyond tol."""
    g = got.float()[rows_valid]
    w = want.float()[rows_valid]
    err = (g - w).abs().max().item() if g.numel() else 0.0
    if not torch.allclose(g, w, atol=tol, rtol=tol):
        return err, False
    return err, True


def _flash_valid_rows(torch, B, Sq, q_offset, window, sk_valid):
    """(B, Hq, Sq) bool: query rows with at least one valid key (causal)."""
    qpos = torch.arange(Sq, device="cuda") + q_offset
    nearest = torch.clamp(qpos, max=sk_valid - 1)    # closest key at or left
    ok = nearest >= 0
    if window is not None:
        ok &= (qpos - nearest) < window
    return ok[None, None, :].expand(B, HQ, Sq)


def check_flash(torch, gen):
    from repro_torch.kernels import flash_attention as FA
    worst = 0.0
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        cases += [dict(dtype=dt, Sq=37, Sk=37), dict(dtype=dt, Sq=512, Sk=512),
                  dict(dtype=dt, Sq=512, Sk=512, window=100)]
    cases += [dict(dtype=torch.float32, Sq=37, Sk=37, softcap=30.0),
              dict(dtype=torch.float32, Sq=37, Sk=101, q_offset=64),
              dict(dtype=torch.bfloat16, Sq=200, Sk=200, d=64),
              dict(dtype=torch.float32, Sq=200, Sk=200, d=64, window=17)]
    for c in cases:
        dt, Sq, Sk, d = c["dtype"], c["Sq"], c["Sk"], c.get("d", D)
        q = _rand(torch, gen, (1, HQ, Sq, d), dt)
        k = _rand(torch, gen, (1, HKV, Sk, d), dt)
        v = _rand(torch, gen, (1, HKV, Sk, d), dt)
        kw = dict(causal=True, window=c.get("window"),
                  softcap=c.get("softcap"), q_offset=c.get("q_offset", 0))
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        rows = _flash_valid_rows(torch, 1, Sq, kw["q_offset"], kw["window"], Sk)
        tol = TOL[str(dt).split(".")[1]]
        err, ok = _err_on_valid(torch, got, want, rows, tol)
        say(f"  K1 flash {str(dt)[6:]:8s} Sq={Sq:4d} Sk={Sk:4d} D={d:3d} "
            f"window={kw['window']} softcap={kw['softcap']} "
            f"q_offset={kw['q_offset']}: max_abs_err={err:.3e} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K1 flash_attention disagrees with its plain version: {c}")
        worst = max(worst, err)
    return worst


def _decode_inputs(torch, gen, dt, B, Smax, d, kv_len):
    q = _rand(torch, gen, (B, HQ, 1, d), dt)
    kc = _rand(torch, gen, (B, HKV, Smax, d), dt)
    vc = _rand(torch, gen, (B, HKV, Smax, d), dt)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return q, kc, vc, kvl


def check_decode(torch, gen):
    from repro_torch.kernels import decode_attention as DA
    worst = 0.0
    kv_len = [1, 37, 300, MAX_LEN]          # ragged; 300 > the window below
    cases = [dict(dtype=torch.float32), dict(dtype=torch.bfloat16),
             dict(dtype=torch.float32, window=64),
             dict(dtype=torch.bfloat16, window=64),
             dict(dtype=torch.float32, softcap=20.0),
             dict(dtype=torch.bfloat16, d=64)]
    for c in cases:
        dt, d = c["dtype"], c.get("d", D)
        q, kc, vc, kvl = _decode_inputs(torch, gen, dt, 4, MAX_LEN, d, kv_len)
        kw = dict(window=c.get("window"), softcap=c.get("softcap"))
        got = DA.decode_attention(q, kc, vc, kvl, **kw)
        want = DA.decode_attention_ref(q, kc, vc, kvl, **kw)
        torch.cuda.synchronize()
        rows = (kvl > 0)[:, None, None].expand(4, HQ, 1)
        err, ok = _err_on_valid(torch, got, want, rows, TOL[str(dt)[6:]])
        say(f"  K2 decode {str(dt)[6:]:8s} B=4 Smax={MAX_LEN} D={d:3d} "
            f"kv_len={kv_len} window={kw['window']} softcap={kw['softcap']}: "
            f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K2 decode_attention disagrees with its plain version: {c}")
        worst = max(worst, err)
    return worst


def _paged_inputs(torch, gen, dt, bs, d, kv_len, num_blocks, max_blocks):
    """Pools with random contents and tables whose live entries are distinct
    random blocks (never the null block 0) and whose dead entries are 0."""
    B = len(kv_len)
    q = _rand(torch, gen, (B, HQ, 1, d), dt)
    kp = _rand(torch, gen, (num_blocks, HKV, bs, d), dt)
    vp = _rand(torch, gen, (num_blocks, HKV, bs, d), dt)
    perm = torch.randperm(num_blocks - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((B, max_blocks), dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(kv_len):
        nb = -(-n // bs)
        tables[b, :nb] = perm[used:used + nb].to(torch.int32)
        used += nb
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, kvl


def check_paged(torch, gen):
    from repro_torch.kernels import decode_attention as DA
    worst = 0.0
    kv_len = [1, 37, 300, MAX_LEN]
    cases = []
    for bs in (16, 128):
        cases += [dict(dtype=torch.float32, bs=bs),
                  dict(dtype=torch.bfloat16, bs=bs),
                  dict(dtype=torch.float32, bs=bs, window=64)]
    cases += [dict(dtype=torch.float32, bs=16, softcap=20.0),
              dict(dtype=torch.bfloat16, bs=16, d=64)]
    for c in cases:
        dt, bs, d = c["dtype"], c["bs"], c.get("d", D)
        mb = -(-MAX_LEN // bs)
        q, kp, vp, tables, kvl = _paged_inputs(torch, gen, dt, bs, d, kv_len,
                                               4 * mb + 8, mb)
        kw = dict(window=c.get("window"), softcap=c.get("softcap"))
        got = DA.paged_decode_attention(q, kp, vp, tables, kvl, **kw)
        want = DA.paged_decode_attention_ref(q, kp, vp, tables, kvl, **kw)
        torch.cuda.synchronize()
        rows = (kvl > 0)[:, None, None].expand(4, HQ, 1)
        err, ok = _err_on_valid(torch, got, want, rows, TOL[str(dt)[6:]])
        say(f"  K3 paged  {str(dt)[6:]:8s} B=4 bs={bs:3d} D={d:3d} "
            f"kv_len={kv_len} window={kw['window']} softcap={kw['softcap']}: "
            f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K3 paged_decode_attention disagrees with its plain "
                 f"version: {c}")
        worst = max(worst, err)
    return worst


def time_ms(torch, fn, calls=20, replays=10):
    """Device time of one call: ``calls`` calls captured into a CUDA graph,
    replayed ``replays`` times between CUDA events (so host launch overhead
    is not counted). L2 is warm: inputs are re-read every call."""
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


def _bound(flops, nbytes):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_kernels(torch, gen):
    """Each kernel at the serving path's shapes, bf16: kernel, plain version,
    library call where one exists, and the card's bound for this input."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    dt, isz = torch.bfloat16, 2
    out = {}

    # K1: one 512-token prompt prefill (engine path), causal, window 4096
    S = M_CAP
    q = _rand(torch, gen, (1, HQ, S, D), dt)
    k = _rand(torch, gen, (1, HKV, S, D), dt)
    v = _rand(torch, gen, (1, HKV, S, D), dt)
    kw = dict(causal=True, window=4096)
    k_rep = k.repeat_interleave(HQ // HKV, dim=1)
    v_rep = v.repeat_interleave(HQ // HKV, dim=1)
    pairs = S * (S + 1) // 2                       # causal (q, k) pairs
    flops = 4 * HQ * D * pairs
    nbytes = (2 * HQ * S * D + 2 * HKV * S * D) * isz
    b_ms, b_by = _bound(flops, nbytes)
    out["flash_attention"] = dict(
        ms=time_ms(torch, lambda: FA.flash_attention(q, k, v, **kw)),
        plain_ms=time_ms(torch, lambda: FA.flash_attention_ref(q, k, v, **kw)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k_rep, v_rep, is_causal=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"B=1 Hq={HQ} Hkv={HKV} Sq=Sk={S} D={D} bf16 causal window=4096")

    # K2: engine-path decode, one lane, a 512-token prompt 16 steps in
    kvl_n = M_CAP + 16
    qd, kc, vc, kvl = _decode_inputs(torch, gen, dt, 1, MAX_LEN, D, [kvl_n])
    k_live = kc[:, :, :kvl_n].repeat_interleave(HQ // HKV, dim=1)
    v_live = vc[:, :, :kvl_n].repeat_interleave(HQ // HKV, dim=1)
    flops = 4 * HQ * D * kvl_n
    nbytes = (2 * HQ * D + 2 * HKV * kvl_n * D) * isz + 4
    b_ms, b_by = _bound(flops, nbytes)
    out["decode_attention"] = dict(
        ms=time_ms(torch, lambda: DA.decode_attention(qd, kc, vc, kvl,
                                                      window=4096)),
        plain_ms=time_ms(torch, lambda: DA.decode_attention_ref(
            qd, kc, vc, kvl, window=4096)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qd, k_live, v_live)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"B=1 Hq={HQ} Hkv={HKV} Smax={MAX_LEN} kv_len={kvl_n} D={D} bf16")

    # K3: paged-batcher decode, 4 lanes of a 1024-block pool, block 16
    kv_len = [40, 130, 300, 528]
    mb = -(-MAX_LEN // 16)
    qp, kp, vp, tables, kvlp = _paged_inputs(torch, gen, dt, 16, D, kv_len,
                                             1024, mb)
    n_kv = sum(kv_len)
    flops = 4 * HQ * D * n_kv
    nbytes = (2 * 4 * HQ * D + 2 * HKV * n_kv * D) * isz + 4 * 4 \
        + sum(-(-n // 16) for n in kv_len) * 4
    b_ms, b_by = _bound(flops, nbytes)
    out["paged_decode_attention"] = dict(
        ms=time_ms(torch, lambda: DA.paged_decode_attention(
            qp, kp, vp, tables, kvlp, window=4096)),
        plain_ms=time_ms(torch, lambda: DA.paged_decode_attention_ref(
            qp, kp, vp, tables, kvlp, window=4096)),
        library_ms=None,
        bound_ms=b_ms, bound_by=b_by,
        shape=f"B=4 Hq={HQ} Hkv={HKV} pool=1024x16 kv_len={kv_len} D={D} bf16")
    for name, r in out.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        say(f"  time {name:24s} {r['shape']}: ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")
    return out


def phase_kernels(torch):
    say("== phase 3: kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {"flash_attention": check_flash(torch, gen),
            "decode_attention": check_decode(torch, gen),
            "paged_decode_attention": check_paged(torch, gen)}
    times = time_kernels(torch, gen)
    return errs, times


# --------------------------------------------------------------------- phase 4
def phase_parity(torch):
    """Kernel path vs plain path on one model and one set of weights."""
    say("== phase 4: model parity, mistral-7b full width, 2 layers, float32")
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.batching import PagedContinuousBatcher, Request
    from repro_torch.serving.engine import InferenceEngine

    cfg = dataclasses.replace(get_config("mistral-7b"), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg, gen, torch.float32, "cuda")
    eng = {b: InferenceEngine(cfg, params, max_len=160, backend=b,
                              device="cuda") for b in ("auto", "ref")}
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, size=(2, 100)).astype(np.int32)
    worst = 0.0

    def compare(what, a, b):
        nonlocal worst
        err = (a.float() - b.float()).abs().max().item()
        worst = max(worst, err)
        ta, tb = a.argmax(-1), b.argmax(-1)
        ok = err <= 1e-3 and torch.equal(ta, tb)
        say(f"  {what}: max_abs_logit_err={err:.3e} greedy "
            f"{'equal' if torch.equal(ta, tb) else 'DIFFER'}")
        if not ok:
            fail(f"model parity: {what}")
        return ta

    # dense engine: prefill (K1) + 8 decode steps (K2), same tokens fed to both
    toks = torch.from_numpy(prompts).cuda()
    caches = {}
    logits = {}
    for b, e in eng.items():
        logits[b], caches[b] = e.prefill({"tokens": toks})
    tok = compare("dense prefill", logits["auto"], logits["ref"])
    for step in range(8):
        for b, e in eng.items():
            logits[b], caches[b] = e.decode(tok[:, None].to(torch.int32),
                                            caches[b])
        tok = compare(f"dense decode {step}", logits["auto"], logits["ref"])

    # paged: chunked prefill (plain chunk attention in both) + 8 decode
    # steps (K3 against its plain version), two lanes of one pool
    bs, chunk = 16, 32
    for b in eng:
        caches[b] = eng[b].new_paged_cache(2, 32, bs)
        for lane in range(2):
            blocks = torch.arange(1 + lane * 10, 1 + (lane + 1) * 10,
                                  dtype=torch.int32, device="cuda")
            caches[b]["block_tables"][lane, :10] = blocks
    last = {b: [None, None] for b in eng}
    for lane in range(2):
        for s in range(0, prompts.shape[1], chunk):
            c = min(chunk, prompts.shape[1] - s)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :c] = prompts[lane, s:s + c]
            for b, e in eng.items():
                lg, caches[b] = e.prefill_chunk(torch.from_numpy(buf).cuda(),
                                                caches[b], lane, c)
                last[b][lane] = lg
    tok = compare("paged prefill", torch.cat(last["auto"]),
                  torch.cat(last["ref"]))
    live = torch.ones(2, dtype=torch.bool, device="cuda")
    for step in range(8):
        for b, e in eng.items():
            logits[b], caches[b] = e.decode_paged(
                tok[:, None].to(torch.int32), caches[b], live)
        tok = compare(f"paged decode {step}", logits["auto"], logits["ref"])

    # the paged batcher end to end: kernel path tokens == plain path tokens
    outs = {}
    for b, e in eng.items():
        cb = PagedContinuousBatcher(e, slots=2, num_blocks=48, block_size=bs)
        reqs = [Request(i, p, max_new_tokens=8) for i, p in
                enumerate([prompts[0], prompts[1], prompts[0][:70]])]
        for r in reqs:
            cb.submit(r)
        cb.run()
        outs[b] = [r.out_tokens for r in reqs]
        say(f"  paged batcher backend={b}: tokens={outs[b]} "
            f"stats={cb.stats()}")
    if outs["auto"] != outs["ref"]:
        fail("paged batcher: kernel path tokens differ from the plain path")
    say(f"  parity ok: worst logit err {worst:.3e} (limit 1e-3)")
    del params, eng, caches
    torch.cuda.empty_cache()
    return worst


# --------------------------------------------------------------------- phase 5
def phase_serve(torch, card):
    say("== phase 5: serve mistral-7b (32 layers, bf16) through FleetRouter")
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.systems import paper_fleet
    from repro_torch.core.workload import sample_workload
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.router import FleetRouter

    cfg = get_config("mistral-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg, gen, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    say(f"  weights: {M.param_count(params) / 1e9:.3f}B params bf16, "
        f"init {time.perf_counter() - t0:.2f} s")
    engine = InferenceEngine(cfg, params, max_len=MAX_LEN,
                             dtype=torch.bfloat16, device="cuda")
    eff, perf = paper_fleet()
    pools = {eff.name: eff, perf.name: perf}
    engines = {eff.name: engine, perf.name: engine}
    counts = {eff.name: 4, perf.name: 1}
    rng = np.random.default_rng(SEED)
    work = [(min(q.m, M_CAP), min(q.n, N_CAP))
            for q in sample_workload(8, seed=SEED)]
    prompts = [rng.integers(0, cfg.vocab_size, size=m) for m, _ in work]
    # the engine-only path serves the first two prompts again
    work += work[:2]
    prompts += prompts[:2]

    kernels = (FA.flash_attention, DA.decode_attention,
               DA.paged_decode_attention)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    paged = FleetRouter(cfg, pools, engines, policy="capacity_aware",
                        counts=counts)
    paged.attach_batchers(slots=4, paged=True, num_blocks=1024, block_size=16)
    routed = [paged.submit(p, n) for p, (_, n) in zip(prompts[:8], work[:8])]
    paged.drain()
    direct = FleetRouter(cfg, pools, engines, policy="capacity_aware",
                         counts=counts)
    routed += [direct.submit(p, n) for p, (_, n) in zip(prompts[8:], work[8:])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {fn.__name__: fn.launches for fn in kernels}

    for rr, (m, n) in zip(routed, work):
        toks = rr.request.out_tokens if rr.request is not None \
            else list(rr.output)
        path = "paged" if rr.request is not None else "engine"
        say(f"  req{rr.rid:3d} [{path:6s}] m={m:4d} n={n:3d} -> {rr.pool:10s} "
            f"E={rr.energy_j:9.3f}J R={rr.runtime_s:7.4f}s "
            f"tokens[:8]={[int(t) for t in toks[:8]]}")
        if len(toks) != n or not all(0 <= int(t) < cfg.vocab_size
                                     for t in toks):
            fail(f"request {rr.rid}: {len(toks)} tokens for a budget of {n}, "
                 f"or a token outside the vocabulary")
        if rr.request is not None and not rr.request.done:
            fail(f"request {rr.rid} not done after drain()")
    for name, router in (("paged", paged), ("engine", direct)):
        for pool, st in router.fleet_report().items():
            say(f"  fleet_report[{name}] {pool:10s} queries={st['queries']} "
                f"tokens={st['tokens']} energy_j={st['energy_j']:.3f} "
                f"runtime_s={st['runtime_s']:.4f}")
    for pool, cb in paged.batchers.items():
        say(f"  batcher {pool}: {cb.stats()}")
    served = sum(st["queries"] for r in (paged, direct)
                 for st in r.fleet_report().values())
    if served != 10:
        fail(f"fleet reports count {served} queries, expected 10")
    say(f"  launches in this phase: {launches}")
    if not all(v > 0 for v in launches.values()):
        fail(f"a kernel of the serving path never launched: {launches}")
    say(f"  serve wall_s={wall:.3f} "
        f"max_memory_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.3f}"
        f" card={card}")
    return launches


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    t0 = time.perf_counter()
    name, count, card = phase_device(torch)
    import repro_torch  # noqa: F401  (sets the TF32 switches)
    phase_build()
    errs, times = phase_kernels(torch)
    phase_parity(torch)
    launches = phase_serve(torch, card)

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:98"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:328"),
               "paged_decode_attention": (
                   "src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:261")}
    rows = []
    for kname, (src, replaces) in sources.items():
        t = times[kname]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kname],
                     "max_abs_err": errs[kname], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    say(f"total_s={time.perf_counter() - t0:.2f} card={card}")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": count}}))


if __name__ == "__main__":
    main()

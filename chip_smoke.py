#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

  1. device  — card name, count, and nvidia-smi's name and power limit;
  2. build   — the Hopper kernels of src/repro_torch/csrc, built with nvcc
               (build seconds and -Xptxas -v output);
  3. kernels — K1 flash prefill, K2 dense decode and K3 paged decode held
               against their plain versions at mistral-7b's attention shapes,
               and K1 and K2 at zamba2-1.2b's shared block's (32 heads, no
               grouping, D = 64, window 8192) (tolerances bf16 2e-2, f32
               2e-5, rows with a valid key only); K5, the SSD chunked scan,
               against its chunked plain version and the sequential oracle
               at mamba2-130m's and zamba2-1.2b's shapes (chunk 128, S = 512
               and a ragged 300) and at their reduced shapes (P = N = 32,
               chunk 32), f32 2e-5, bf16 5e-2, y and the final state; then
               each timed at each serving path's shapes beside the plain
               version, one PyTorch library call where one computes the same
               function, and the card's bound;
  4. parity  — full-width mistral-7b cut to 2 layers, float32, same seeded
               weights: the kernel path against the plain path over prefill
               plus 8 decode steps, through the dense engine and the paged
               batcher (logits within 1e-3, greedy tokens identical);
  4b. parity — the same for full-width mamba2-130m (24 layers) and
               zamba2-1.2b cut to 7 layers (one segment with its shared
               attention block, and a tail), through the engine and the
               dense ContinuousBatcher;
  5. serve   — full mistral-7b (32 layers, bf16, random weights from a seed)
               behind FleetRouter(capacity_aware) over paper_fleet(): 8
               requests through paged batchers and 2 through the engine-only
               path; every kernel's launch count in this phase must be > 0;
  6. serve   — full mamba2-130m and full zamba2-1.2b (bf16, random weights
               from a seed) the same way through dense batchers: K5 must
               launch for both, K1 and K2 for zamba2.

The line before the last is one JSON object with each kernel's numbers, one
row per kernel and serving path: ``name@arch`` is the kernel on that model's
path (plain ``name`` is mistral-7b's for K1-K3 and mamba2-130m's for K5),
with that path's launches and its own shapes' times and errors; the
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
SSD_TOL = {"float32": 2e-5, "bfloat16": 5e-2}   # tests/test_kernels.py
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
# mistral-7b attention: 32 query heads, 8 KV heads, head dim 128
HQ, HKV, D = 32, 8, 128
# zamba2-1.2b's shared attention block: 32 heads, no grouping, head dim 64
ZAMBA = "zamba2-1.2b"
ZHQ, ZD, ZWINDOW = 32, 64, 8192
M_CAP, N_CAP = 512, 32        # serve phase: prompt and output caps
MAX_LEN = M_CAP + N_CAP       # engine context on the serving path
# (H, P, N, chunk) of the SSD scan: the full configs serve through phase 6,
# the reduced ones through ``repro_torch.launch.serve``
SSD_SHAPES = {"mamba2-130m": (24, 64, 128, 128), ZAMBA: (64, 64, 64, 128),
              "reduced": (16, 32, 32, 32)}


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


def _flash_valid_rows(torch, B, hq, Sq, q_offset, window, sk_valid):
    """(B, Hq, Sq) bool: query rows with at least one valid key (causal)."""
    qpos = torch.arange(Sq, device="cuda") + q_offset
    nearest = torch.clamp(qpos, max=sk_valid - 1)    # closest key at or left
    ok = nearest >= 0
    if window is not None:
        ok &= (qpos - nearest) < window
    return ok[None, None, :].expand(B, hq, Sq)


def check_flash(torch, gen):
    """K1 at mistral-7b's heads, and at zamba2-1.2b's (its own row)."""
    from repro_torch.kernels import flash_attention as FA
    worst = {"flash_attention": 0.0, f"flash_attention@{ZAMBA}": 0.0}
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        cases += [dict(dtype=dt, Sq=37, Sk=37), dict(dtype=dt, Sq=512, Sk=512),
                  dict(dtype=dt, Sq=512, Sk=512, window=100)]
    cases += [dict(dtype=torch.float32, Sq=37, Sk=37, softcap=30.0),
              dict(dtype=torch.float32, Sq=37, Sk=101, q_offset=64),
              dict(dtype=torch.bfloat16, Sq=200, Sk=200, d=64),
              dict(dtype=torch.float32, Sq=200, Sk=200, d=64, window=17)]
    z = dict(hq=ZHQ, hkv=ZHQ, d=ZD, window=ZWINDOW, arch=ZAMBA)
    for dt in (torch.float32, torch.bfloat16):
        cases += [dict(dtype=dt, Sq=512, Sk=512, **z),
                  dict(dtype=dt, Sq=200, Sk=200, **z)]
    for c in cases:
        dt, Sq, Sk, d = c["dtype"], c["Sq"], c["Sk"], c.get("d", D)
        hq, hkv = c.get("hq", HQ), c.get("hkv", HKV)
        q = _rand(torch, gen, (1, hq, Sq, d), dt)
        k = _rand(torch, gen, (1, hkv, Sk, d), dt)
        v = _rand(torch, gen, (1, hkv, Sk, d), dt)
        kw = dict(causal=True, window=c.get("window"),
                  softcap=c.get("softcap"), q_offset=c.get("q_offset", 0))
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        rows = _flash_valid_rows(torch, 1, hq, Sq, kw["q_offset"],
                                 kw["window"], Sk)
        tol = TOL[str(dt).split(".")[1]]
        err, ok = _err_on_valid(torch, got, want, rows, tol)
        say(f"  K1 flash {str(dt)[6:]:8s} Hq={hq} Hkv={hkv} Sq={Sq:4d} "
            f"Sk={Sk:4d} D={d:3d} window={kw['window']} "
            f"softcap={kw['softcap']} q_offset={kw['q_offset']}: "
            f"max_abs_err={err:.3e} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K1 flash_attention disagrees with its plain version: {c}")
        key = "flash_attention" + (f"@{c['arch']}" if "arch" in c else "")
        worst[key] = max(worst[key], err)
    return worst


def _decode_inputs(torch, gen, dt, B, Smax, d, kv_len, hq=HQ, hkv=HKV):
    q = _rand(torch, gen, (B, hq, 1, d), dt)
    kc = _rand(torch, gen, (B, hkv, Smax, d), dt)
    vc = _rand(torch, gen, (B, hkv, Smax, d), dt)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    return q, kc, vc, kvl


def check_decode(torch, gen):
    """K2 at mistral-7b's heads, and at zamba2-1.2b's (its own row)."""
    from repro_torch.kernels import decode_attention as DA
    worst = {"decode_attention": 0.0, f"decode_attention@{ZAMBA}": 0.0}
    kv_len = [1, 37, 300, MAX_LEN]          # ragged; 300 > the window below
    cases = [dict(dtype=torch.float32), dict(dtype=torch.bfloat16),
             dict(dtype=torch.float32, window=64),
             dict(dtype=torch.bfloat16, window=64),
             dict(dtype=torch.float32, softcap=20.0),
             dict(dtype=torch.bfloat16, d=64)]
    cases += [dict(dtype=dt, hq=ZHQ, hkv=ZHQ, d=ZD, window=ZWINDOW,
                   arch=ZAMBA) for dt in (torch.float32, torch.bfloat16)]
    for c in cases:
        dt, d = c["dtype"], c.get("d", D)
        hq, hkv = c.get("hq", HQ), c.get("hkv", HKV)
        q, kc, vc, kvl = _decode_inputs(torch, gen, dt, 4, MAX_LEN, d, kv_len,
                                        hq, hkv)
        kw = dict(window=c.get("window"), softcap=c.get("softcap"))
        got = DA.decode_attention(q, kc, vc, kvl, **kw)
        want = DA.decode_attention_ref(q, kc, vc, kvl, **kw)
        torch.cuda.synchronize()
        rows = (kvl > 0)[:, None, None].expand(4, hq, 1)
        err, ok = _err_on_valid(torch, got, want, rows, TOL[str(dt)[6:]])
        say(f"  K2 decode {str(dt)[6:]:8s} B=4 Hq={hq} Hkv={hkv} "
            f"Smax={MAX_LEN} D={d:3d} kv_len={kv_len} window={kw['window']} "
            f"softcap={kw['softcap']}: max_abs_err={err:.3e} "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K2 decode_attention disagrees with its plain version: {c}")
        key = "decode_attention" + (f"@{c['arch']}" if "arch" in c else "")
        worst[key] = max(worst[key], err)
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


def _ssd_inputs(torch, gen, dt_type, B, H, S, P, N):
    x = _rand(torch, gen, (B, H, S, P), dt_type)
    dt = torch.rand((B, H, S), generator=gen, device="cuda") * 0.2 + 0.001
    A = -(torch.rand((H,), generator=gen, device="cuda") * 3.5 + 0.5)
    Bm = _rand(torch, gen, (B, S, N), dt_type)
    Cm = _rand(torch, gen, (B, S, N), dt_type)
    return x, dt, A, Bm, Cm


def check_ssd(torch, gen):
    """K5 against the chunked plain version and the sequential oracle: y and
    the final state, S a multiple of the chunk and ragged. Returns the worst
    error against the chunked version per kernels-line row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as SS
    worst = {"ssd_scan": 0.0, f"ssd_scan@{ZAMBA}": 0.0}
    for arch, (H, P, N, L) in SSD_SHAPES.items():
        for dt_type in (torch.float32, torch.bfloat16):
            for S in ((512, 300) if L == 128 else (64, 45)):
                inp = _ssd_inputs(torch, gen, dt_type, 2, H, S, P, N)
                y, fs = SS.ssd_scan(*inp, chunk=L)
                torch.cuda.synchronize()
                tol = SSD_TOL[str(dt_type)[6:]]
                errs, ok = [], True
                for want_y, want_fs in (SS.ssd_scan_ref(*inp, chunk=L),
                                        ref.ssd_scan(*inp)):
                    for g, w in ((y.float(), want_y.float()), (fs, want_fs)):
                        errs.append((g - w).abs().max().item())
                        ok = ok and torch.allclose(g, w, atol=tol, rtol=tol)
                say(f"  K5 ssd    {str(dt_type)[6:]:8s} {arch:12s} B=2 H={H} "
                    f"P={P} N={N} S={S} chunk={L}: max_abs_err y/state "
                    f"chunked={errs[0]:.3e}/{errs[1]:.3e} "
                    f"sequential={errs[2]:.3e}/{errs[3]:.3e} "
                    f"{'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail(f"K5 ssd_scan disagrees with its plain versions: "
                         f"{arch} {dt_type} S={S}")
                key = "ssd_scan" if arch == "mamba2-130m" else \
                    f"ssd_scan@{arch}"
                if key in worst:
                    worst[key] = max(worst[key], errs[0], errs[1])
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

    # K1 at zamba2-1.2b's shared block: 32 heads, no grouping, D = 64
    q = _rand(torch, gen, (1, ZHQ, S, ZD), dt)
    k = _rand(torch, gen, (1, ZHQ, S, ZD), dt)
    v = _rand(torch, gen, (1, ZHQ, S, ZD), dt)
    kw = dict(causal=True, window=ZWINDOW)
    b_ms, b_by = _bound(4 * ZHQ * ZD * pairs, 4 * ZHQ * S * ZD * isz)
    out[f"flash_attention@{ZAMBA}"] = dict(
        ms=time_ms(torch, lambda: FA.flash_attention(q, k, v, **kw)),
        plain_ms=time_ms(torch, lambda: FA.flash_attention_ref(q, k, v, **kw)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"B=1 Hq=Hkv={ZHQ} Sq=Sk={S} D={ZD} bf16 causal "
              f"window={ZWINDOW}")

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

    # K2 at zamba2-1.2b's shared block
    qz, kz, vz, kvlz = _decode_inputs(torch, gen, dt, 1, MAX_LEN, ZD, [kvl_n],
                                      ZHQ, ZHQ)
    kz_live, vz_live = kz[:, :, :kvl_n], vz[:, :, :kvl_n]
    b_ms, b_by = _bound(4 * ZHQ * ZD * kvl_n,
                        (2 * ZHQ * ZD + 2 * ZHQ * kvl_n * ZD) * isz + 4)
    out[f"decode_attention@{ZAMBA}"] = dict(
        ms=time_ms(torch, lambda: DA.decode_attention(qz, kz, vz, kvlz,
                                                      window=ZWINDOW)),
        plain_ms=time_ms(torch, lambda: DA.decode_attention_ref(
            qz, kz, vz, kvlz, window=ZWINDOW)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qz, kz_live, vz_live)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"B=1 Hq=Hkv={ZHQ} Smax={MAX_LEN} kv_len={kvl_n} D={ZD} bf16")

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

    # K5: one 512-token prompt prefill of one Mamba layer (engine path);
    # no single PyTorch call computes the SSD scan, so library_ms is null
    from repro_torch.kernels import ssm_scan as SS
    S = M_CAP
    for arch in ("mamba2-130m", ZAMBA):
        H, P, N, L = SSD_SHAPES[arch]
        inp = _ssd_inputs(torch, gen, dt, 1, H, S, P, N)
        nc = -(-S // L)
        pairs = nc * L * (L + 1) // 2            # causal (i, j) per chunk
        flops = 2 * H * (pairs * (N + P) + nc * 2 * L * P * N)
        nbytes = (2 * H * S * P + 2 * S * N) * isz + (H * S + H) * 4 \
            + H * P * N * 4
        b_ms, b_by = _bound(flops, nbytes)
        key = "ssd_scan" if arch == "mamba2-130m" else f"ssd_scan@{arch}"
        out[key] = dict(
            ms=time_ms(torch, lambda: SS.ssd_scan(*inp, chunk=L)),
            plain_ms=time_ms(torch, lambda: SS.ssd_scan_ref(*inp, chunk=L)),
            library_ms=None, bound_ms=b_ms, bound_by=b_by,
            shape=f"{arch} B=1 H={H} S={S} P={P} N={N} chunk={L} bf16")
    for name, r in out.items():
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        say(f"  time {name:34s} {r['shape']}: ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={lib} "
            f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")
    return out


def phase_kernels(torch):
    say("== phase 3: kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs = {**check_flash(torch, gen), **check_decode(torch, gen),
            "paged_decode_attention": check_paged(torch, gen),
            **check_ssd(torch, gen)}
    times = time_kernels(torch, gen)
    return errs, times


# --------------------------------------------------------------- phases 4, 4b
def _parity_engines(torch, cfg, max_len):
    """Two engines on one set of seeded float32 weights: the kernel path
    ("auto") and the plain path ("ref")."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg, gen, torch.float32, "cuda")
    return {b: InferenceEngine(cfg, params, max_len=max_len, backend=b,
                               device="cuda") for b in ("auto", "ref")}


def _compare(torch, what, a, b):
    """max |a - b| of the two paths' logits; fails past 1e-3 or when their
    greedy tokens differ. Returns (error, greedy tokens)."""
    err = (a.float() - b.float()).abs().max().item()
    ta, tb = a.argmax(-1), b.argmax(-1)
    say(f"  {what}: max_abs_logit_err={err:.3e} greedy "
        f"{'equal' if torch.equal(ta, tb) else 'DIFFER'}")
    if err > 1e-3 or not torch.equal(ta, tb):
        fail(f"model parity: {what}")
    return err, ta


def _engine_parity(torch, label, eng, prompts):
    """Prefill plus 8 decode steps on both paths, the same tokens fed to
    both. Returns the worst logit error and the caches."""
    toks = torch.from_numpy(prompts).cuda()
    caches, logits = {}, {}
    for b, e in eng.items():
        logits[b], caches[b] = e.prefill({"tokens": toks})
    worst, tok = _compare(torch, f"{label} prefill", logits["auto"],
                          logits["ref"])
    for step in range(8):
        for b, e in eng.items():
            logits[b], caches[b] = e.decode(tok[:, None].to(torch.int32),
                                            caches[b])
        err, tok = _compare(torch, f"{label} decode {step}", logits["auto"],
                            logits["ref"])
        worst = max(worst, err)
    return worst, caches


def _batcher_parity(label, eng, make_batcher, prompts):
    """A batcher end to end on both paths: the same tokens."""
    from repro_torch.serving.batching import Request
    outs = {}
    for b, e in eng.items():
        cb = make_batcher(e)
        reqs = [Request(i, p, max_new_tokens=8) for i, p in
                enumerate([prompts[0], prompts[1], prompts[0][:70]])]
        for r in reqs:
            cb.submit(r)
        cb.run()
        outs[b] = [r.out_tokens for r in reqs]
        stats = f" stats={cb.stats()}" if hasattr(cb, "stats") else ""
        say(f"  {label} backend={b}: tokens={outs[b]}{stats}")
    if outs["auto"] != outs["ref"]:
        fail(f"{label}: kernel path tokens differ from the plain path")


def phase_parity(torch):
    """Kernel path vs plain path on one model and one set of weights."""
    say("== phase 4: model parity, mistral-7b full width, 2 layers, float32")
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving.batching import PagedContinuousBatcher

    cfg = dataclasses.replace(get_config("mistral-7b"), num_layers=2)
    eng = _parity_engines(torch, cfg, 160)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, size=(2, 100)).astype(np.int32)

    # dense engine: prefill (K1) + 8 decode steps (K2)
    worst, caches = _engine_parity(torch, "dense", eng, prompts)

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
    err, tok = _compare(torch, "paged prefill", torch.cat(last["auto"]),
                        torch.cat(last["ref"]))
    worst = max(worst, err)
    live = torch.ones(2, dtype=torch.bool, device="cuda")
    logits = {}
    for step in range(8):
        for b, e in eng.items():
            logits[b], caches[b] = e.decode_paged(
                tok[:, None].to(torch.int32), caches[b], live)
        err, tok = _compare(torch, f"paged decode {step}", logits["auto"],
                            logits["ref"])
        worst = max(worst, err)

    _batcher_parity("paged batcher", eng, lambda e: PagedContinuousBatcher(
        e, slots=2, num_blocks=48, block_size=bs), prompts)
    say(f"  parity ok: worst logit err {worst:.3e} (limit 1e-3)")
    del eng, caches
    torch.cuda.empty_cache()
    return worst


def phase_parity_ssm(torch):
    """Kernel path vs plain path for the SSM and hybrid families, through
    the engine and the dense batcher."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving.batching import ContinuousBatcher

    worst = 0.0
    for arch, layers in (("mamba2-130m", None), ("zamba2-1.2b", 7)):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        say(f"== phase 4b: model parity, {arch} full width, "
            f"{cfg.num_layers} layers, float32")
        eng = _parity_engines(torch, cfg, 224)
        rng = np.random.default_rng(SEED)
        # 200 tokens: one full chunk of 128 and a ragged one
        prompts = rng.integers(0, cfg.vocab_size,
                               size=(2, 200)).astype(np.int32)
        err, _ = _engine_parity(torch, arch, eng, prompts)
        worst = max(worst, err)
        _batcher_parity(f"{arch} dense batcher", eng,
                        lambda e: ContinuousBatcher(e, slots=2), prompts)
        del eng
        torch.cuda.empty_cache()
    say(f"  parity ok: worst logit err {worst:.3e} (limit 1e-3)")
    return worst


# --------------------------------------------------------------- phases 5, 6
def _serve_mix(torch, cfg, engine, kernels, *, paged):
    """The fixed mix: 8 requests from sample_workload(8, seed) (m and n
    capped) behind FleetRouter(capacity_aware) over paper_fleet() with
    batchers (paged or dense, 4 slots), then the first 2 again through the
    engine-only path. Checks every output; returns each kernel's launches in
    the mix, counted from 0, and the wall seconds."""
    import numpy as np
    from repro_torch.core.systems import paper_fleet
    from repro_torch.core.workload import sample_workload
    from repro_torch.serving.router import FleetRouter

    eff, perf = paper_fleet()
    pools = {eff.name: eff, perf.name: perf}
    engines = {eff.name: engine, perf.name: engine}
    counts = {eff.name: 4, perf.name: 1}
    rng = np.random.default_rng(SEED)
    work = [(min(q.m, M_CAP), min(q.n, N_CAP))
            for q in sample_workload(8, seed=SEED)]
    prompts = [rng.integers(0, cfg.vocab_size, size=m) for m, _ in work]
    work += work[:2]
    prompts += prompts[:2]

    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    batched = FleetRouter(cfg, pools, engines, policy="capacity_aware",
                          counts=counts)
    if paged:
        batched.attach_batchers(slots=4, paged=True, num_blocks=1024,
                                block_size=16)
    else:
        batched.attach_batchers(slots=4, paged=False)
    routed = [batched.submit(p, n) for p, (_, n) in zip(prompts[:8], work[:8])]
    batched.drain()
    direct = FleetRouter(cfg, pools, engines, policy="capacity_aware",
                         counts=counts)
    routed += [direct.submit(p, n) for p, (_, n) in zip(prompts[8:], work[8:])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {fn.__name__: fn.launches for fn in kernels}

    kind = "paged" if paged else "dense"
    for rr, (m, n) in zip(routed, work):
        toks = rr.request.out_tokens if rr.request is not None \
            else list(rr.output)
        path = kind if rr.request is not None else "engine"
        say(f"  req{rr.rid:3d} [{path:6s}] m={m:4d} n={n:3d} -> {rr.pool:10s} "
            f"E={rr.energy_j:9.3f}J R={rr.runtime_s:7.4f}s "
            f"tokens[:8]={[int(t) for t in toks[:8]]}")
        if len(toks) != n or not all(0 <= int(t) < cfg.vocab_size
                                     for t in toks):
            fail(f"{cfg.name} request {rr.rid}: {len(toks)} tokens for a "
                 f"budget of {n}, or a token outside the vocabulary")
        if rr.request is not None and not rr.request.done:
            fail(f"{cfg.name} request {rr.rid} not done after drain()")
    for name, router in ((kind, batched), ("engine", direct)):
        for pool, st in router.fleet_report().items():
            say(f"  fleet_report[{name}] {pool:10s} queries={st['queries']} "
                f"tokens={st['tokens']} energy_j={st['energy_j']:.3f} "
                f"runtime_s={st['runtime_s']:.4f}")
    if paged:
        for pool, cb in batched.batchers.items():
            say(f"  batcher {pool}: {cb.stats()}")
    served = sum(st["queries"] for r in (batched, direct)
                 for st in r.fleet_report().values())
    if served != 10:
        fail(f"{cfg.name}: fleet reports count {served} queries, expected 10")
    say(f"  launches in this run: {launches}")
    return launches, wall


def _serve(torch, card, arch, kernels, needed, *, paged):
    """Full-size ``arch`` (bf16 random weights from the seed) through the
    fixed mix; fails if a kernel in ``needed`` never launched."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import InferenceEngine

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg, gen, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    say(f"  weights: {M.param_count(params) / 1e9:.3f}B params bf16, "
        f"{cfg.num_layers} layers, init {time.perf_counter() - t0:.2f} s")
    engine = InferenceEngine(cfg, params, max_len=MAX_LEN,
                             dtype=torch.bfloat16, device="cuda")
    launches, wall = _serve_mix(torch, cfg, engine, kernels, paged=paged)
    if not all(launches[k] > 0 for k in needed):
        fail(f"{arch}: a kernel of the serving path never launched "
             f"(needs {needed}): {launches}")
    say(f"  {arch} serve wall_s={wall:.3f} max_memory_allocated_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} card={card}")
    del params, engine
    torch.cuda.empty_cache()
    return launches


def phase_serve(torch, card):
    say("== phase 5: serve mistral-7b (32 layers, bf16) through FleetRouter")
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    kernels = (FA.flash_attention, DA.decode_attention,
               DA.paged_decode_attention)
    return _serve(torch, card, "mistral-7b", kernels,
                  [fn.__name__ for fn in kernels], paged=True)


def phase_serve_ssm(torch, card):
    """Full mamba2-130m and zamba2-1.2b through dense batchers (their lanes
    are not pageable), each from counts set to 0. Returns the launches of
    each model's kernels under their kernels-line names."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssm_scan as SS
    kernels = (FA.flash_attention, DA.decode_attention,
               DA.paged_decode_attention, SS.ssd_scan)
    out = {}
    for arch, needed, key in (
            ("mamba2-130m", ("ssd_scan",), "{}"),
            (ZAMBA, ("ssd_scan", "flash_attention", "decode_attention"),
             "{}@" + ZAMBA)):
        say(f"== phase 6: serve {arch} (full, bf16) through FleetRouter")
        launches = _serve(torch, card, arch, kernels, needed, paged=False)
        out.update({key.format(k): launches[k] for k in needed})
    return out


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
    phase_parity_ssm(torch)
    launches = phase_serve(torch, card)
    launches.update(phase_serve_ssm(torch, card))

    sources = {"flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:98"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:328"),
               "paged_decode_attention": (
                   "src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:261"),
               "ssd_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                            "src/repro/kernels/ssm_scan.py:73")}
    rows = []
    for kname in ("flash_attention", "decode_attention",
                  "paged_decode_attention", "ssd_scan", f"ssd_scan@{ZAMBA}",
                  f"flash_attention@{ZAMBA}", f"decode_attention@{ZAMBA}"):
        src, replaces = sources[kname.split("@")[0]]
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

"""The autotuner's timer: one kernel cell timed through ``kernels.ops``, with
its analytic work counts (counterpart of ``time_kernel`` in the reference
package's ``benchmarks/microbench.py``, which is a script directory the
port does not import).

Timing hygiene: two warm-up calls are excluded; every timed repetition
waits for the card (``torch.cuda.synchronize()``) inside its own timed
region, so one call's device time is never billed to a later one; the time
is the best of k (shared-host noise only adds), and
``noise_frac = (median - best) / best`` is kept beside it.

Backends: ``"cuda"`` times the Hopper kernels on the card (inputs on
``cuda``, ``ops`` under ``backend="auto"``); ``"ref"`` times the plain
version on the CPU. A ``"cuda"`` timing without a card raises.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pricing import KernelSample
from repro_torch.kernels import ops

BACKENDS = ("ref", "cuda")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device: torch.device, iters: int = 5) -> Tuple[float, float]:
    """(best seconds, noise_frac) per call, two warm-up calls excluded."""
    for _ in range(2):
        fn()
        _sync(device)
    reps = []
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        reps.append(time.perf_counter() - t0)
    best = min(reps)
    med = statistics.median(reps)
    return best, (med - best) / best if best > 0 else 0.0


def time_kernel(kernel: str, shape: Mapping[str, int], *,
                params: Optional[Mapping[str, object]] = None,
                backend: str = "cuda", iters: int = 5, seed: int = 0,
                heads: int = 4, kv_heads: int = 2, head_dim: int = 64,
                state_dim: int = 64, ssm_head_dim: int = 64,
                page_block: int = 16) -> KernelSample:
    """Time ONE kernel cell through ``kernels.ops`` dispatch.

    ``kernel`` is one of "flash_attention" (shape {"s", ["b"]}),
    "decode_attention" / "paged_decode_quant" (shape {"b", "c"}) or
    "ssm_scan" (shape {"s", ["b"]}). ``params`` are the tile or impl kwargs
    to pin (None = the dispatch defaults). Inputs are float32, drawn with
    numpy from ``seed``. The work counts are the reference timer's.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    dev = torch.device("cuda" if backend == "cuda" else "cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: the 'cuda' backend "
                           "times the Hopper kernels on the card")
    ob = "auto" if backend == "cuda" else "ref"
    rng = np.random.default_rng(seed)
    p: Dict[str, object] = dict(params) if params else {}
    isz = 4  # float32
    Hq, Hkv, Dh = heads, kv_heads, head_dim
    # the plain path materializes the (Sq, Sk) scores that the kernels keep
    # on chip: count those bytes when that is what is timed
    materializes_scores = backend == "ref"

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    if kernel == "flash_attention":
        B, S = int(shape.get("b", 1)), int(shape["s"])
        q = t(rng.normal(size=(B, Hq, S, Dh)))
        k = t(rng.normal(size=(B, Hkv, S, Dh)))
        v = t(rng.normal(size=(B, Hkv, S, Dh)))
        secs, nf = _time(lambda: ops.flash_attention(q, k, v, causal=True,
                                                     backend=ob, **p),
                         dev, iters)
        if materializes_scores:
            # the plain path computes the FULL S x S products and masks after
            flops = 4.0 * B * Hq * S * S * Dh
        else:
            flops = 2.0 * B * Hq * S * S * Dh          # QK^T + PV, causal-halved
        byts = isz * (2.0 * B * Hq * S * Dh + 2.0 * B * Hkv * S * Dh)
        if materializes_scores:
            byts += isz * 3.0 * B * Hq * S * S         # scores: write, softmax, read
        return KernelSample("flash_attention", flops, byts, float(S), secs, nf)

    if kernel == "decode_attention":
        B, ctx = int(shape["b"]), int(shape["c"])
        q = t(rng.normal(size=(B, Hq, 1, Dh)))
        kc = t(rng.normal(size=(B, Hkv, ctx, Dh)))
        vc = t(rng.normal(size=(B, Hkv, ctx, Dh)))
        kv_len = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        secs, nf = _time(lambda: ops.decode_attention(q, kc, vc, kv_len,
                                                      backend=ob, **p),
                         dev, iters)
        flops = 4.0 * B * Hq * ctx * Dh                # QK^T + PV at length ctx
        byts = isz * (2.0 * B * Hkv * ctx * Dh + 2.0 * B * Hq * Dh)
        if materializes_scores:
            byts += isz * 3.0 * B * Hq * ctx
        return KernelSample("decode_attention", flops, byts, float(ctx), secs,
                            nf)

    if kernel == "paged_decode_quant":
        B, ctx = int(shape["b"]), int(shape["c"])
        if ctx % page_block:
            raise ValueError(f"ctx {ctx} not a multiple of page_block "
                             f"{page_block}")
        mb = ctx // page_block
        nb = 1 + B * mb                                # block 0 = null block
        q = t(rng.normal(size=(B, Hq, 1, Dh)))
        kp = t(rng.integers(-127, 128, size=(nb, Hkv, page_block, Dh)),
               torch.int8)
        vp = t(rng.integers(-127, 128, size=(nb, Hkv, page_block, Dh)),
               torch.int8)
        ks = t(rng.uniform(0.005, 0.02, size=(nb, Hkv, page_block, 1)))
        vs = t(rng.uniform(0.005, 0.02, size=(nb, Hkv, page_block, 1)))
        tables = t(np.arange(1, 1 + B * mb).reshape(B, mb), torch.int32)
        kv_len = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        secs, nf = _time(lambda: ops.paged_decode_attention_quant(
            q, kp, vp, ks, vs, tables, kv_len, backend=ob, **p), dev, iters)
        # attention products + the per-element dequantize multiplies
        flops = 4.0 * B * Hq * ctx * Dh + 4.0 * B * Hkv * ctx * Dh
        byts = (1.0 * 2.0 * B * Hkv * ctx * Dh        # int8 K/V pool reads
                + isz * 2.0 * B * Hkv * ctx           # scale columns
                + isz * 2.0 * B * Hq * Dh)            # q + out
        if p.get("impl", "gather") == "gather":
            # gather-dequantize materializes copies of BOTH caches in q's
            # dtype (write + re-read by the dense kernel)
            byts += isz * 4.0 * B * Hkv * ctx * Dh
        if materializes_scores:
            byts += isz * 3.0 * B * Hq * ctx
        return KernelSample("paged_decode_quant", flops, byts, float(ctx),
                            secs, nf)

    if kernel == "ssm_scan":
        B, S = int(shape.get("b", 1)), int(shape["s"])
        H, P, N = heads, ssm_head_dim, state_dim
        chunk = int(p.get("chunk", 128))               # sets the executed FLOPs
        x = t(rng.normal(size=(B, H, S, P)))
        dt = t(rng.uniform(0.001, 0.2, size=(B, H, S)))
        A = t(-rng.uniform(0.5, 4.0, size=(H,)))
        Bm = t(rng.normal(size=(B, S, N)))
        Cm = t(rng.normal(size=(B, S, N)))
        secs, nf = _time(lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                              backend=ob), dev, iters)
        # chunked dual form: CB^T + att@x per chunk, C@state + state update
        flops = 2.0 * B * H * S * (chunk * N + chunk * P + 2.0 * N * P)
        byts = isz * (2.0 * B * H * S * P + 2.0 * B * S * N + B * H * S)
        return KernelSample("ssm_scan", flops, byts, 0.0, secs, nf)

    raise KeyError(f"unknown kernel {kernel!r}")

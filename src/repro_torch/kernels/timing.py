"""The autotuner's timer and the calibration's samples: kernel cells timed
through ``kernels.ops``, with their analytic work counts (counterparts of
``time_kernel`` and ``kernel_phase_samples`` in the reference package's
``benchmarks/microbench.py``, a script directory the port does not import).

Timing hygiene: two warm-up calls are excluded; every timed repetition
waits for the card (``torch.cuda.synchronize()``) inside its own timed
region, so one call's device time is never billed to a later one; the time
is the best of k (shared-host noise only adds), and
``noise_frac = (median - best) / best`` is kept beside it.

Backends: ``"cuda"`` times the Hopper kernels on the card (inputs on
``cuda``, ``ops`` under ``backend="auto"``); ``"ref"`` times the plain
version on the CPU. A ``"cuda"`` timing without a card raises. On the card
a call is the cell captured once as a CUDA graph and replayed, as the
reference's timer times each cell ``jax.jit``-compiled and as the port's
serve steps run (``serving/step_graph.py``): one launch and one
synchronise a call, however many kernels and torch ops the cell runs (the
int8 gather read is a dozen), so a sample costs what the card does and
not what the host launches. The wrappers' launch counts grow at each
replay by what the capture counted.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.pricing import KernelSample
from repro_torch.kernels import ops

BACKENDS = ("ref", "cuda")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _graphed(fn, device: torch.device):
    """``fn`` warmed up twice on a side stream, then captured as a CUDA
    graph; returns its replay, which adds to each launch count what the
    capture counted (the capture itself launched nothing), as
    ``serving.step_graph`` counts a replayed serve step."""
    from repro_torch.serving.step_graph import COUNTERS
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    main.wait_stream(side)
    held = [k.launches for k in COUNTERS]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    grown = [k.launches - n for k, n in zip(COUNTERS, held)]
    for k, n in zip(COUNTERS, held):
        k.launches = n

    def replay():
        graph.replay()
        for k, n in zip(COUNTERS, grown):
            k.launches += n
    return replay


def _time(fn, device: torch.device, iters: int = 5) -> Tuple[float, float]:
    """(best seconds, noise_frac) per call, two warm-up calls excluded; on
    the card a call is ``fn``'s CUDA graph replay."""
    if device.type == "cuda":
        fn = _graphed(fn, device)
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
                page_block: int = 16,
                dtype: torch.dtype = torch.float32) -> KernelSample:
    """Time ONE kernel cell through ``kernels.ops`` dispatch.

    ``kernel`` is one of "flash_attention" (shape {"s", ["b"]}),
    "decode_attention" / "paged_decode_quant" (shape {"b", "c"}),
    "kv_migrate" (shape {"blocks"}) or "ssm_scan" (shape {"s", ["b"]}).
    ``params`` are the tile or impl kwargs to pin (None = the dispatch
    defaults). Inputs are drawn with numpy from ``seed``, in ``dtype``. The
    work counts are the reference timer's, in ``dtype``'s element size.
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
    isz = torch.empty((), dtype=dtype).element_size()
    fsz = 4  # float32: scale columns, dt, A and the plain path's scores
    Hq, Hkv, Dh = heads, kv_heads, head_dim
    # the plain path materializes the (Sq, Sk) scores that the kernels keep
    # on chip: count those bytes when that is what is timed
    materializes_scores = backend == "ref"

    def t(a, to=dtype):
        return torch.as_tensor(np.asarray(a), dtype=to, device=dev)

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
            byts += fsz * 3.0 * B * Hq * S * S         # scores: write, softmax, read
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
            byts += fsz * 3.0 * B * Hq * ctx
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
        ks = t(rng.uniform(0.005, 0.02, size=(nb, Hkv, page_block, 1)),
               torch.float32)
        vs = t(rng.uniform(0.005, 0.02, size=(nb, Hkv, page_block, 1)),
               torch.float32)
        tables = t(np.arange(1, 1 + B * mb).reshape(B, mb), torch.int32)
        kv_len = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        secs, nf = _time(lambda: ops.paged_decode_attention_quant(
            q, kp, vp, ks, vs, tables, kv_len, backend=ob, **p), dev, iters)
        # attention products + the per-element dequantize multiplies
        flops = 4.0 * B * Hq * ctx * Dh + 4.0 * B * Hkv * ctx * Dh
        byts = (1.0 * 2.0 * B * Hkv * ctx * Dh        # int8 K/V pool reads
                + fsz * 2.0 * B * Hkv * ctx           # scale columns
                + isz * 2.0 * B * Hq * Dh)            # q + out
        if p.get("impl", "gather") == "gather":
            # gather-dequantize materializes copies of BOTH caches in q's
            # dtype (write + re-read by the dense kernel)
            byts += isz * 4.0 * B * Hkv * ctx * Dh
        if materializes_scores:
            byts += fsz * 3.0 * B * Hq * ctx
        return KernelSample("paged_decode_quant", flops, byts, float(ctx),
                            secs, nf)

    if kernel == "kv_migrate":
        # device-side KV-block migration (serving.batching.migrate_kv_blocks'
        # ops): gather ``blocks`` K/V blocks from a source pool, scatter them
        # into a zeroed destination. Pure data movement: flops 0, so the
        # sample constrains mem_eff, which CostModel.migration_seconds reads
        # through the oracle's calibration
        nblk = int(shape.get("blocks", shape.get("b", 8)))
        nb = 1 + nblk                                  # block 0 = null block
        sk = t(rng.normal(size=(nb, Hkv, page_block, Dh)))
        sv = t(rng.normal(size=(nb, Hkv, page_block, Dh)))
        dk = torch.zeros_like(sk)
        dv = torch.zeros_like(sv)
        ids = torch.arange(1, 1 + nblk, dtype=torch.long, device=dev)

        def mv():
            dk.index_copy_(0, ids, sk.index_select(0, ids))
            dv.index_copy_(0, ids, sv.index_select(0, ids))

        secs, nf = _time(mv, dev, iters)
        # K+V payload, read once from the source pool and written once into
        # the destination pool
        byts = isz * 2.0 * 2.0 * nblk * Hkv * page_block * Dh
        return KernelSample("kv_migrate", 0.0, byts, 0.0, secs, nf)

    if kernel == "ssm_scan":
        B, S = int(shape.get("b", 1)), int(shape["s"])
        H, P, N = heads, ssm_head_dim, state_dim
        chunk = int(p.get("chunk", 128))               # sets the executed FLOPs
        x = t(rng.normal(size=(B, H, S, P)))
        dt = t(rng.uniform(0.001, 0.2, size=(B, H, S)), torch.float32)
        A = t(-rng.uniform(0.5, 4.0, size=(H,)), torch.float32)
        Bm = t(rng.normal(size=(B, S, N)))
        Cm = t(rng.normal(size=(B, S, N)))
        secs, nf = _time(lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk,
                                              backend=ob), dev, iters)
        # chunked dual form: CB^T + att@x per chunk, C@state + state update
        flops = 2.0 * B * H * S * (chunk * N + chunk * P + 2.0 * N * P)
        byts = isz * (2.0 * B * H * S * P + 2.0 * B * S * N) + fsz * B * H * S
        return KernelSample("ssm_scan", flops, byts, 0.0, secs, nf)

    raise KeyError(f"unknown kernel {kernel!r}")


def kernel_phase_samples(*, prefill_lens: Sequence[int] = (128, 256, 512, 1024),
                         decode_ctxs: Sequence[int] = (128, 256, 512, 1024,
                                                       2048, 4096),
                         ssm_lens: Sequence[int] = (256, 512, 1024),
                         paged_ctxs: Sequence[int] = (),
                         migrate_blocks: Sequence[int] = (),
                         batch: int = 1, heads: int = 4, kv_heads: int = 2,
                         head_dim: int = 64, state_dim: int = 64,
                         ssm_head_dim: int = 64, iters: int = 5,
                         backend: str = "cuda", seed: int = 0, tuned=None,
                         dtype: torch.dtype = torch.float32
                         ) -> List[KernelSample]:
    """Time the kernels behind the serving stack and return samples the
    roofline calibration can fit (``core.pricing.fit_calibration``).

    Kernels go through ``kernels.ops``: the Hopper kernels on the card
    (``backend="cuda"``, which raises without one) or the plain versions on
    the CPU (``"ref"``), so the same call calibrates whichever hardware it
    runs on. The cells come in the reference's order: prefill, decode,
    paged int8 decode, KV migration, SSD scan. FLOPs and bytes are each
    kernel's analytic work for the timed shape; ``ctx`` is the context
    length that drives ``SystemProfile.sat_ctx`` (0 for the SSD scan and
    the migration).

    ``tuned`` (an ``autotune.AutotuneCache``) re-measures every cell with
    its bucket's winner under ``backend`` pinned explicitly; None keeps the
    dispatch defaults.
    """
    from repro_torch.kernels import autotune as AT

    def tuned_params(kernel: str, **dims) -> Optional[Dict[str, object]]:
        if tuned is None:
            return None
        return tuned.resolve(kernel, backend, AT.shape_bucket(kernel, **dims))

    kw = dict(backend=backend, iters=iters, seed=seed, heads=heads,
              kv_heads=kv_heads, head_dim=head_dim, state_dim=state_dim,
              ssm_head_dim=ssm_head_dim, dtype=dtype)
    out: List[KernelSample] = []
    for S in prefill_lens:
        out.append(time_kernel("flash_attention", {"b": batch, "s": S},
                               params=tuned_params("flash_attention", s=S),
                               **kw))
    for ctx in decode_ctxs:
        out.append(time_kernel("decode_attention", {"b": batch, "c": ctx},
                               params=tuned_params("decode_attention",
                                                   b=batch, c=ctx), **kw))
    for ctx in paged_ctxs:
        out.append(time_kernel("paged_decode_quant", {"b": batch, "c": ctx},
                               params=tuned_params("paged_decode_quant",
                                                   b=batch, c=ctx), **kw))
    for nblk in migrate_blocks:
        out.append(time_kernel("kv_migrate", {"blocks": nblk}, **kw))
    for S in ssm_lens:
        out.append(time_kernel("ssm_scan", {"b": batch, "s": S},
                               params=tuned_params("ssm_scan", s=S), **kw))
    return out

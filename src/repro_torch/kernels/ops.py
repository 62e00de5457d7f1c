"""Kernel entry points with device dispatch — the counterpart of
``repro/kernels/ops.py``. Models call these and never a kernel directly.

``backend="auto"`` (the default): a CPU tensor runs the plain version (in
``ref``, or beside its kernel's wrapper); a CUDA tensor launches the
Hopper kernel, or raises if the kernel does not take its inputs. Under
grad mode with an input that requires grad, ``flash_attention`` goes
through K1's autograd Function (backward: K1-bwd) and ``ssd_scan``
through K5's (backward: K5-bwd); the decode kernels K2, K3 and K4 and
the chunk kernel K6 raise on a CUDA tensor there: they have no backward
kernel, and their output would carry no gradient. There is no fallback
from the kernel to the plain version and no environment override.
``backend="ref"`` asks for the plain version on any device: the on-card
comparison of the kernel path with the plain path uses it.

Parameters (tile sizes, the SSD ``chunk``, the int8 read path ``impl``)
resolve explicit -> tuned -> default: an explicit kwarg wins, then the
winner of the installed autotune cache (``kernels.autotune.install``) for
this kernel, backend and shape bucket, then the kernel's default. The
lookup's backend is ``"cuda"`` for a CUDA tensor under ``backend="auto"``
and ``"ref"`` otherwise; it reads shapes only, so it adds no host sync. With
no cache installed nothing is passed down, and every entry point returns
bit for bit what it returned before the cache existed.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autotune as _at
from repro_torch.kernels import chunk_attention as _ca
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_experts as _me
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import ssm_scan as _ss

BACKENDS = ("auto", "ref")
QUANT_IMPLS = ("gather", "fused")


def _use_kernel(x: torch.Tensor, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    return backend == "auto" and x.device.type == "cuda"


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _refuse_grad(name: str, *tensors) -> None:
    """A kernel with no backward kernel never runs where autograd would need
    one: its output would carry no gradient, silently."""
    if _wants_grad(*tensors):
        raise RuntimeError(
            f"{name}: this kernel has no backward on the card; call it "
            f"under torch.no_grad(), or run on the CPU (plain path)")


def _tuned(kernel: str, use_kernel: bool, **dims: int):
    return _at.lookup(kernel, "cuda" if use_kernel else "ref",
                      _at.shape_bucket(kernel, **dims))


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    block_q: Optional[int] = None,
                    block_kv: Optional[int] = None,
                    backend: str = "auto") -> torch.Tensor:
    use = _use_kernel(q, backend)
    tuned = _tuned("flash_attention", use, s=q.shape[2])
    bq = block_q if block_q is not None else tuned.get("block_q")
    kw = {} if bq is None else {"block_q": int(bq)}
    if not use:
        return _ref.mha_attention_chunked(q, k, v, causal=causal, window=window,
                                          softcap=softcap, q_offset=q_offset,
                                          **kw)
    bk = block_kv if block_kv is not None else tuned.get("block_kv")
    if bk is not None:
        kw["block_k"] = int(bk)
    if _wants_grad(q, k, v):
        # K1 under its autograd Function, so the backward runs K1-bwd
        return _fa.flash_attention_grad(q, k, v, causal=causal, window=window,
                                        softcap=softcap, q_offset=q_offset,
                                        **kw)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset, **kw)


def decode_attention(q, k_cache, v_cache, kv_len, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     block_kv: Optional[int] = None,
                     backend: str = "auto") -> torch.Tensor:
    if not _use_kernel(q, backend):
        # no tile on the plain path: an explicit block_kv is accepted and
        # ignored, as in the reference package
        return _ref.decode_attention(q, k_cache, v_cache, kv_len=kv_len,
                                     window=window, softcap=softcap)
    _refuse_grad("decode_attention", q, k_cache, v_cache)
    tuned = _tuned("decode_attention", True, b=q.shape[0],
                   c=k_cache.shape[2])
    bk = block_kv if block_kv is not None else tuned.get("block_kv")
    kw = {} if bk is None else {"block_k": int(bk)}
    return _da.decode_attention(q, k_cache, v_cache, kv_len, window=window,
                                softcap=softcap, **kw)


def paged_decode_attention(q, k_pool, v_pool, block_tables, kv_len, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           backend: str = "auto") -> torch.Tensor:
    """Decode attention through a paged KV cache (shared block pool plus
    per-lane block tables). See ``ref.paged_decode_attention``."""
    if not _use_kernel(q, backend):
        return _ref.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                           kv_len=kv_len, window=window,
                                           softcap=softcap)
    _refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    return _da.paged_decode_attention(q, k_pool, v_pool, block_tables, kv_len,
                                      window=window, softcap=softcap)


def paged_chunk_attention(q, k_pool, v_pool, table, kv_len, q_offset, *,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          backend: str = "auto") -> torch.Tensor:
    """One lane's prefill chunk over its paged KV cache (K6 on the card),
    ``q_offset`` and ``kv_len`` device tensors. See
    ``chunk_attention.paged_chunk_attention``."""
    if not _use_kernel(q, backend):
        return _ca.paged_chunk_attention_ref(q, k_pool, v_pool, table,
                                             kv_len, q_offset, window=window,
                                             softcap=softcap)
    _refuse_grad("paged_chunk_attention", q, k_pool, v_pool)
    return _ca.paged_chunk_attention(q, k_pool, v_pool, table, kv_len,
                                     q_offset, window=window, softcap=softcap)


def paged_decode_attention_quant(q, k_pool, v_pool, k_scale_pool,
                                 v_scale_pool, block_tables, kv_len, *,
                                 window: Optional[int] = None,
                                 softcap: Optional[float] = None,
                                 impl: Optional[str] = None,
                                 backend: str = "auto") -> torch.Tensor:
    """Decode attention over an int8 paged KV cache, by one of two read
    paths:

      * ``impl="gather"`` (the default): gather the lane's blocks,
        dequantize to q.dtype, then ``decode_attention`` (K2 on the card).
      * ``impl="fused"``: the int8 read fused into the attention — K4 on a
        CUDA tensor (or raise), the scale-folded plain version otherwise —
        so no dequantized copy of the cache is made.

    ``impl=None`` resolves explicit -> tuned -> "gather".
    """
    use = _use_kernel(q, backend)
    if impl is None:
        tuned = _tuned("paged_decode_quant", use, b=q.shape[0],
                       c=block_tables.shape[1] * k_pool.shape[2])
        impl = str(tuned.get("impl", "gather"))
    if impl not in QUANT_IMPLS:
        raise ValueError(f"unknown quantized decode impl {impl!r}; "
                         f"expected one of {QUANT_IMPLS}")
    if impl == "gather":
        tables = block_tables.long()             # one index cast for four
        k = _ref.dequantize_kv(_ref.gather_paged_kv(k_pool, tables),
                               _ref.gather_paged_kv(k_scale_pool, tables),
                               q.dtype)
        v = _ref.dequantize_kv(_ref.gather_paged_kv(v_pool, tables),
                               _ref.gather_paged_kv(v_scale_pool, tables),
                               q.dtype)
        return decode_attention(q, k, v, kv_len, window=window,
                                softcap=softcap, backend=backend)
    if not use:
        return _ref.paged_decode_attention_quant_fused(
            q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables,
            kv_len=kv_len, window=window, softcap=softcap)
    _refuse_grad("paged_decode_attention_quant", q, k_scale_pool,
                 v_scale_pool)
    return _da.paged_decode_attention_int8(
        q, k_pool, v_pool, k_scale_pool, v_scale_pool, block_tables, kv_len,
        window=window, softcap=softcap)


def ssd_scan(x, dt, A, Bmat, Cmat, *, chunk: Optional[int] = None,
             backend: str = "auto"):
    """Mamba2 SSD chunked scan. ``chunk=None`` resolves tuned -> 128, the
    kernel's default. The plain path is the chunked matmul form, as the
    reference's ``ref`` backend."""
    use = _use_kernel(x, backend)
    if chunk is None:
        chunk = _tuned("ssm_scan", use, s=x.shape[2]).get("chunk", 128)
    chunk = int(chunk)
    if not use:
        return _ref.ssd_scan_chunked(x, dt, A, Bmat, Cmat, chunk=chunk)
    if _wants_grad(x, dt, A, Bmat, Cmat):
        # K5 under its autograd Function, so the backward runs K5-bwd
        return _ss.ssd_scan_grad(x, dt, A, Bmat, Cmat, chunk=chunk)
    return _ss.ssd_scan(x, dt, A, Bmat, Cmat, chunk=chunk)


def ssd_decode_step(state, x, dt, A, Bvec, Cvec):
    # single-token state update: plain torch everywhere, as in the reference
    # (elementwise work and tiny products, no kernel win at (B, H, P, N))
    return _ref.ssd_decode_step(state, x, dt, A, Bvec, Cvec)


def moe_experts(x, w_up, w_down, routes, *, backend: str = "auto"):
    """The routed experts of a dropless MoE layer over the rows of
    ``routes`` (``moe_experts.route_table``): K7 on the card, the plain
    expert-by-expert version otherwise. See ``moe_experts.moe_experts``."""
    if not _use_kernel(x, backend):
        return _me.moe_experts_ref(x, w_up, w_down, routes)
    _refuse_grad("moe_experts", x, w_up, w_down)
    return _me.moe_experts(x, w_up, w_down, routes)

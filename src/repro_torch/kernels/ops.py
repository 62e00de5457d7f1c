"""Kernel entry points with device dispatch — the counterpart of
``repro/kernels/ops.py``. Models call these and never a kernel directly.

``backend="auto"`` (the default): a CPU tensor runs the plain version in
``ref``; a CUDA tensor launches the Hopper kernel, or raises if the kernel
does not take its inputs. There is no fallback from the kernel to the plain
version and no environment override. ``backend="ref"`` asks for the plain
version on any device: the on-card comparison of the kernel path with the
plain path uses it.

Tile sizes: an explicit ``block_q``/``block_kv`` wins, else the kernel's
default. (The autotune cache waits for ROADMAP Queue 1 item 7.)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref

BACKENDS = ("auto", "ref")


def _use_kernel(x: torch.Tensor, backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    return backend == "auto" and x.device.type == "cuda"


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    block_q: Optional[int] = None,
                    block_kv: Optional[int] = None,
                    backend: str = "auto") -> torch.Tensor:
    if not _use_kernel(q, backend):
        kw = {} if block_q is None else {"block_q": int(block_q)}
        return _ref.mha_attention_chunked(q, k, v, causal=causal, window=window,
                                          softcap=softcap, q_offset=q_offset,
                                          **kw)
    kw = {}
    if block_q is not None:
        kw["block_q"] = int(block_q)
    if block_kv is not None:
        kw["block_k"] = int(block_kv)
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
    kw = {} if block_kv is None else {"block_k": int(block_kv)}
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
    return _da.paged_decode_attention(q, k_pool, v_pool, block_tables, kv_len,
                                      window=window, softcap=softcap)

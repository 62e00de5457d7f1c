"""K5: the Mamba2 SSD chunked scan — the Hopper kernel's wrapper and its
plain version.

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py::ssd_scan``
(body ``_ssd_kernel``). The CUDA source is ``csrc/ssm_scan.cu``; its header
note says how the TPU grid's sequential chunk axis became a loop inside one
block per (lane, head), how shared memory is split, and what bounds it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import DTYPE_CODES

# the full (64, 128 or 64, chunk 128) and reduced (32, 32, chunk 32)
# mamba2-130m and zamba2-1.2b
HEAD_DIMS = (32, 64)          # P
STATE_DIMS = (32, 64, 128)    # N
CHUNKS = (32, 128)            # L; 128 is the default, as on the TPU


def ssd_scan_ref(x, dt, A, Bmat, Cmat, *,
                 chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K5: the chunked matmul form, same algebra."""
    return _ref.ssd_scan_chunked(x, dt, A, Bmat, Cmat, chunk=chunk)


def _check(x, dt, A, Bmat, Cmat, chunk) -> None:
    name = "ssd_scan"
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, H, S, P), got {tuple(x.shape)}")
    B, H, S, P = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"{name}: kernel inputs must be CUDA tensors, "
                         f"got {x.device}")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported "
                         f"(float32 or bfloat16)")
    for t, what in ((Bmat, "Bmat"), (Cmat, "Cmat")):
        if t.dtype != x.dtype:
            raise ValueError(f"{name}: {what} dtype {t.dtype} differs from "
                             f"x's {x.dtype}")
    for t, what in ((dt, "dt"), (A, "A")):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be float32, got {t.dtype}")
    for t in (x, dt, A, Bmat, Cmat):
        if t.device != x.device:
            raise ValueError(f"{name}: all inputs must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    N = Bmat.shape[-1] if Bmat.dim() == 3 else -1
    if dt.shape != (B, H, S) or A.shape != (H,) \
            or Bmat.shape != (B, S, N) or Cmat.shape != (B, S, N):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bmat "
                         f"{tuple(Bmat.shape)}, Cmat {tuple(Cmat.shape)}")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"{name}: head dim {P} not in {HEAD_DIMS} or state "
                         f"dim {N} not in {STATE_DIMS}")
    if chunk not in CHUNKS:
        raise ValueError(f"{name}: chunk {chunk} not in {CHUNKS}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, *,
             chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, S, P); dt (B, H, S) float32; A (H,) float32, negative;
    Bmat, Cmat (B, S, N). Returns (y (B, H, S, P) in x.dtype, final state
    (B, H, P, N) float32).

    On a CUDA tensor this launches the Hopper kernel (or raises); a CPU
    tensor takes the plain version. Any S: the kernel masks the ragged tail.
    """
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bmat, Cmat, chunk=chunk)
    _check(x, dt, A, Bmat, Cmat, chunk)
    B, H, S, P = x.shape
    N = Bmat.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if B * H == 0:
        return y, state
    code = _build.library().repro_ssd_scan(
        DTYPE_CODES[x.dtype], N, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bmat.data_ptr(), Cmat.data_ptr(), y.data_ptr(), state.data_ptr(),
        B, H, S, P, chunk, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0

"""K5: the Mamba2 SSD chunked scan — the Hopper kernel's wrapper and its
plain version.

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py::ssd_scan``
(body ``_ssd_kernel``). The CUDA source is ``csrc/ssm_scan.cu``; its header
note says how the TPU grid's sequential chunk axis became three passes
(every chunk's local state, a scan of the states over the chunks, every
chunk's outputs), where the bf16 path (v2, ``mma.sync``) rounds, how the
float32 path (v3, FMA on register micro-tiles) walks its tiles, and what
bounds each.

K5-bwd, the gradient of K5's function, has no Pallas counterpart: the
reference's K5 has no custom_vjp, so JAX trains on its plain path. Here it
is ``csrc/ssm_scan_bwd.cu`` (v2: every chunk's dY·Cᵀ, a reverse scan of the
state gradients over the chunks, dX and dB per key slab, dC per row slab,
then d(dt) and dA, and the sums over heads; the slabs on the micro-tiles
of K5 v3), reached only through
``SSDScan``, a ``torch.autograd.Function`` whose forward is K5 and keeps
K5's workspace (the state entering each chunk): ``kernels.ops`` routes
there when grad mode is on and an input requires grad.
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
# the kernel's passes (bits of the launcher's mask): chunk states, the scan
# over chunks, the outputs
PASSES = {"chunk_states": 1, "scan": 2, "outputs": 4}
ALL_PASSES = 7

# Threads and dynamic shared memory of a block of K5 v3's float32 passes and
# of K5-bwd v2's micro-tile kernels, as csrc/ssm_scan.cu (f32::OutLayout),
# csrc/ssm_common.cuh (Outer) and csrc/ssm_scan_bwd.cu (Slab) lay them out;
# the tests hold every instantiation to two blocks an SM.
SM_SMEM_BYTES = 233472        # shared memory of an H100 SM (228 KB)
BLOCK_RESERVED_BYTES = 1024   # what the card keeps of it for each block


def slab_rows(chunk: int) -> int:
    """Rows of a slab and of a tile it walks: the chunk when it is short,
    else 64 (``slab_rows`` in csrc/ssm_common.cuh)."""
    return chunk if chunk < 64 else 64


def layouts(P: int, N: int, chunk: int) -> dict:
    """{kernel: (threads, dynamic shared memory bytes)} of one (P, N, chunk)
    instantiation. The chunk-state pass and K5-bwd's dY·Cᵀ share the outer
    sum: cum float64, dt and the row scale, then a·s (L, P) and b (L, N).
    The outputs pass: cum and dt, the slab's C (R, N), then the B tile
    (R, N + 4), the x tile (R, P) and att (R, R), or S_inᵀ (N, P) over them.
    K5-bwd's C1 and C2: cum, the slab's (R, P) and (R, N), then two
    swizzled walked tiles and the score tile, or the state and its
    transpose over them."""
    L, R = chunk, slab_rows(chunk)
    outer = (P // 8 * 16, 16 * L + 4 * L * (P + N))
    slab = (2 * R, 8 * L + 4 * (R * (P + N)
                                 + max(R * (P + N + R), 2 * P * N)))
    return {"ssd_chunk_state_f32": outer,
            "ssd_output_f32": (2 * R, 12 * L + 4 * (
                R * N + max(R * (N + 4 + P + R), N * P))),
            "ssd_bwd_dstate_kernel": outer,
            "ssd_bwd_keys_kernel": slab,
            "ssd_bwd_rows_kernel": slab}


def blocks_per_sm(smem_bytes: int) -> int:
    """Blocks of ``smem_bytes`` that an SM's shared memory holds."""
    return SM_SMEM_BYTES // (smem_bytes + BLOCK_RESERVED_BYTES)


def ssd_scan_ref(x, dt, A, Bmat, Cmat, *,
                 chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K5: the chunked matmul form, same algebra."""
    return _ref.ssd_scan_chunked(x, dt, A, Bmat, Cmat, chunk=chunk)


def _check(x, dt, A, Bmat, Cmat, chunk, name: str = "ssd_scan") -> None:
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
    N = Bmat.shape[-1] if Bmat.dim() in (3, 4) else -1
    G = Bmat.shape[2] if Bmat.dim() == 4 else 1
    bc = (B, S, N) if Bmat.dim() == 3 else (B, S, G, N)
    if dt.shape != (B, H, S) or A.shape != (H,) or G < 1 or H % G \
            or Bmat.shape != bc or Cmat.shape != bc:
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, Bmat "
                         f"{tuple(Bmat.shape)}, Cmat {tuple(Cmat.shape)}")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"{name}: head dim {P} not in {HEAD_DIMS} or state "
                         f"dim {N} not in {STATE_DIMS}")
    if chunk not in CHUNKS:
        raise ValueError(f"{name}: chunk {chunk} not in {CHUNKS}")
    if G > 1 and (x.dtype != torch.bfloat16 or name != "ssd_scan"):
        raise ValueError(f"{name}: grouped B and C (G = {G}) run on the "
                         f"bfloat16 forward kernel only")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, *,
             chunk: int = 128, ws=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, H, S, P); dt (B, H, S) float32; A (H,) float32, negative;
    Bmat, Cmat (B, S, N), or (B, S, G, N) with head h reading group
    h // (H / G) (bfloat16 only on the card). Returns (y (B, H, S, P) in x.dtype, final state
    (B, H, P, N) float32).

    On a CUDA tensor this launches the Hopper kernel (three device kernels,
    one count) or raises; a CPU tensor takes the plain version. Any S: the
    kernel masks the ragged tail. ``ws`` (CUDA only), a ``workspace()``,
    is left holding the state entering each chunk and each chunk's total
    decay, which K5-bwd reads. The output carries no gradient: under grad,
    ``ssd_scan_grad``.
    """
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, Bmat, Cmat, chunk=chunk)
    y, state, launched = launch_passes(x, dt, A, Bmat, Cmat, chunk=chunk,
                                       ws=ws)
    if launched:
        ssd_scan.launches += 1
    return y, state


def _workspace_shapes(x, N, chunk):
    B, H, S, P = x.shape
    nc = -(-S // chunk)
    return (B, H, nc, P, N), (B, H, nc)


def workspace(x: torch.Tensor, N: int, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's float32 workspace for x (B, H, S, P): every chunk's
    state (B, H, chunks, P, N) and its total decay (B, H, chunks)."""
    return tuple(torch.empty(shape, dtype=torch.float32, device=x.device)
                 for shape in _workspace_shapes(x, N, chunk))


def _check_workspace(ws, x, N, chunk, name) -> None:
    if ws is None or any(
            tuple(w.shape) != shape or w.dtype != torch.float32
            or w.device != x.device or not w.is_contiguous()
            for w, shape in zip(ws, _workspace_shapes(x, N, chunk))):
        raise ValueError(f"{name}: the workspace must be as workspace() "
                         f"makes it")


def launch_passes(x, dt, A, Bmat, Cmat, *, chunk: int = 128,
                  passes: int = ALL_PASSES, ws=None):
    """Launch the kernel's passes in the ``passes`` mask (bits of
    ``PASSES``) on CUDA tensors, with a new workspace or ``ws``. Returns
    (y, final state, launched). ``ssd_scan`` runs all three and counts the
    call; one pass alone, on a workspace a full call has filled, serves
    only to time that pass, and counts nothing."""
    _check(x, dt, A, Bmat, Cmat, chunk)
    B, H, S, P = x.shape
    N = Bmat.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    if not 0 < passes <= ALL_PASSES:
        raise ValueError(f"ssd_scan: passes {passes} not a mask of {PASSES}")
    if B * H == 0:
        return y, state, False
    if ws is None:
        ws = workspace(x, N, chunk)
    else:
        _check_workspace(ws, x, N, chunk, "ssd_scan")
    states, totals = ws
    code = _build.library().repro_ssd_scan(
        DTYPE_CODES[x.dtype], N, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bmat.data_ptr(), Cmat.data_ptr(), y.data_ptr(), state.data_ptr(),
        states.data_ptr(), totals.data_ptr(), B, H, S, P, chunk, passes,
        Bmat.shape[2] if Bmat.dim() == 4 else 1,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "ssd_scan")
    return y, state, True


ssd_scan.launches = 0


def ssd_scan_bwd_ref(x, dt, A, Bmat, Cmat, dy, dfinal=None, *,
                     chunk: int = 128):
    """The plain version of K5-bwd: ``torch.autograd.grad`` of
    ``ref.ssd_scan_chunked`` in float32, given the gradient ``dy`` of y and
    ``dfinal`` of the final state (None: the final state is unused), the
    gradients cast to each input's dtype. Returns (dx, ddt, dA, dB, dC)."""
    inputs = (x, dt, A, Bmat, Cmat)
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_(True) for t in inputs]
        y, final = ssd_scan_ref(*leaves, chunk=chunk)
        outs, grads = [y], [dy.float()]
        if dfinal is not None:
            outs.append(final)
            grads.append(dfinal.float())
        got = torch.autograd.grad(outs, leaves, grads)
    return tuple(g.to(t.dtype) for g, t in zip(got, inputs))


def ssd_scan_bwd(x, dt, A, Bmat, Cmat, dy, dfinal=None, *, chunk: int = 128,
                 ws=None):
    """(dx, ddt, dA, dB, dC) of K5's function at (x, dt, A, Bmat, Cmat),
    given ``dy`` (B, H, S, P) in x's dtype and ``dfinal`` (B, H, P, N)
    float32 or None (an unused final state).

    On a CUDA tensor this launches K5-bwd (six device kernels, one count)
    or raises; ``ws`` is the workspace a K5 call on the same inputs filled
    (``ssd_scan(..., ws=ws)``: the state entering each chunk and each
    chunk's total decay). A CPU tensor takes the plain version.
    """
    if x.device.type == "cpu":
        return ssd_scan_bwd_ref(x, dt, A, Bmat, Cmat, dy, dfinal,
                                chunk=chunk)
    name = "ssd_scan_bwd"
    _check(x, dt, A, Bmat, Cmat, chunk, name)
    B, H, S, P = x.shape
    N = Bmat.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device \
            or not dy.is_contiguous() or dy.data_ptr() % 16:
        raise ValueError(f"{name}: dy must be a contiguous, 16-byte aligned "
                         f"{x.dtype} tensor of x's shape {tuple(x.shape)}")
    if dfinal is not None and (
            dfinal.shape != (B, H, P, N) or dfinal.dtype != torch.float32
            or dfinal.device != x.device or not dfinal.is_contiguous()
            or dfinal.data_ptr() % 16):
        raise ValueError(f"{name}: dfinal must be a contiguous float32 "
                         f"tensor of shape {(B, H, P, N)}")
    _check_workspace(ws, x, N, chunk, name)
    dx, dB, dC = (torch.empty_like(t) for t in (x, Bmat, Cmat))
    ddt = torch.empty_like(dt)
    dA = torch.zeros_like(A)
    if B * H * S == 0:
        return dx.zero_(), ddt.zero_(), dA, dB.zero_(), dC.zero_()
    states, totals = ws
    f32 = dict(dtype=torch.float32, device=x.device)
    nc = -(-S // chunk)
    # float32 scratch: the state gradients of every chunk, the per-head
    # partials of dB and dC, four per-step terms of d(cum) and d(dt), and
    # the per-(lane, chunk) partials of dA, summed in a fixed order last
    dstates = torch.empty((B, H, nc, P, N), **f32)
    dB_part = torch.empty((B, H, S, N), **f32)
    dC_part = torch.empty((B, H, S, N), **f32)
    steps = torch.empty((4, B, H, S), **f32)
    dA_part = torch.empty((B, H, nc), **f32)
    code = _build.library().repro_ssd_scan_bwd(
        DTYPE_CODES[x.dtype], N, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
        Bmat.data_ptr(), Cmat.data_ptr(), dy.data_ptr(),
        None if dfinal is None else dfinal.data_ptr(), states.data_ptr(),
        totals.data_ptr(), dstates.data_ptr(), dB_part.data_ptr(),
        dC_part.data_ptr(), steps.data_ptr(), dA_part.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
        dC.data_ptr(), B, H, S, P, chunk,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, name)
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC


ssd_scan_bwd.launches = 0


class SSDScan(torch.autograd.Function):
    """K5 with its gradient: the forward launches K5 on a workspace it
    keeps (after K5's scan it holds the state entering each chunk, which the
    backward reads rather than recomputes); the backward launches K5-bwd.
    A final state that is not used costs no zero tensor. Under
    ``torch.utils.checkpoint`` the forward runs twice and the backward
    once."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, chunk):
        ctx.set_materialize_grads(False)
        ws = workspace(x, Bmat.shape[-1], chunk) if x.is_cuda else ()
        y, final = ssd_scan(x, dt, A, Bmat, Cmat, chunk=chunk,
                            ws=ws or None)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bmat, Cmat, *ws)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bmat, Cmat, *ws = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dfinal is not None:
            dfinal = dfinal.contiguous()
        grads = ssd_scan_bwd(x, dt, A, Bmat, Cmat, dy, dfinal,
                             chunk=ctx.chunk, ws=tuple(ws) or None)
        return (*grads, None)


def ssd_scan_grad(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bmat: torch.Tensor, Cmat: torch.Tensor, *,
                  chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 through ``SSDScan``, so that autograd reaches K5-bwd."""
    return SSDScan.apply(x, dt, A, Bmat, Cmat, chunk)

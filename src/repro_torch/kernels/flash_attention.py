"""K1: blockwise (flash) attention for prefill — the Hopper kernel's wrapper
and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (body ``_flash_kernel``). The CUDA source is
``csrc/flash_attention.cu``: bfloat16 runs v3 (wgmma tensor-core tiles fed
by TMA), float32 runs v2 (float32 FMA on the CUDA cores, since TF32 would
miss the float32 tolerance). Its header note says how the TPU grid's
sequential K axis became a loop inside one block, and what bounds it.

K1-bwd, the gradient of K1's function, has no Pallas counterpart: the
reference's K1 has no custom_vjp, so JAX trains on its plain path. Here it
is ``csrc/flash_attention_bwd.cu`` (three passes: row statistics, dK and dV
per KV head, dQ), reached only through ``FlashAttention``, a
``torch.autograd.Function`` whose forward is K1: ``kernels.ops`` routes
there when grad mode is on and an input requires grad.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

HEAD_DIMS = (64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (block_q, block_k) each dtype's kernel takes: v3 (bf16) has one or two
# 64-row consumer warpgroups and a wgmma N of block_k; v2 (f32) any 16-row
# multiple up to 128 and a multiple of 32 keys.
TILES = {torch.bfloat16: ((64, 128), (32, 64, 128)),
         torch.float32: ((16, 32, 64, 128), (32, 64, 96, 128))}
TILE_SIZES = (64, 128)             # block_q both kernels take
SMEM_BYTES = 232_448               # dynamic shared memory a block may use


def smem_bytes(rows: int, block_k: int, head_dim: int) -> int:
    """Shared memory of one v2 (float32) attention block
    (csrc/attention_common.cuh ``smem_floats``): q and acc rows, m and l,
    the K and V tiles."""
    r4 = (rows + 3) & ~3
    return 4 * (2 * rows * head_dim + 2 * r4 + head_dim * (block_k + 1)
                + block_k * head_dim)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None, q_offset: int = 0,
                        sk_valid: Optional[int] = None) -> torch.Tensor:
    """The plain version: the reference attention, keys past ``sk_valid``
    masked. Rows with no valid key give mean(V) here and 0 in the kernel."""
    kv_len = None
    if sk_valid is not None and sk_valid < k.shape[2]:
        kv_len = torch.full((q.shape[0],), sk_valid, dtype=torch.int32,
                            device=q.device)
    return _ref.mha_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, q_offset=q_offset,
                              kv_len=kv_len)


def check_inputs(name: str, *tensors: torch.Tensor) -> None:
    """What every attention kernel here takes: CUDA, float32 or bfloat16,
    one dtype, contiguous and 16-byte aligned (the kernels read 16-byte
    vectors), head dim 64 or 128."""
    dev, dtype = tensors[0].device, tensors[0].dtype
    if dev.type != "cuda":
        raise ValueError(f"{name}: kernel inputs must be CUDA tensors, got {dev}")
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32 or bfloat16)")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: all inputs must share device and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    if tensors[0].shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {tensors[0].shape[-1]} not in "
                         f"{HEAD_DIMS}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    sk_valid: Optional[int] = None, block_q: int = 64,
                    block_k: int = 64) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D). Returns (B, Hq, Sq, D).

    On a CUDA tensor this launches the Hopper kernel (or raises); a CPU
    tensor takes the plain version. ``q_offset`` and ``sk_valid`` are host
    ints: absolute position of query row 0, and the number of valid keys.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset,
                                   sk_valid=sk_valid)
    check_inputs("flash_attention", q, k, v)
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or Hq % Hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    tiles_q, tiles_k = TILES[q.dtype]
    if block_q not in tiles_q or block_k not in tiles_k:
        raise ValueError(f"flash_attention: {str(q.dtype)[6:]} takes block_q "
                         f"in {tiles_q} and block_k in {tiles_k}, got "
                         f"{block_q} x {block_k}")
    if q.dtype == torch.float32 \
            and smem_bytes(block_q, block_k, D) > SMEM_BYTES:
        raise ValueError(f"flash_attention: block_q {block_q} x block_k "
                         f"{block_k} at head dim {D} needs "
                         f"{smem_bytes(block_q, block_k, D)} bytes of shared "
                         f"memory, over {SMEM_BYTES}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got {softcap}")
    sk_valid = Sk if sk_valid is None else int(sk_valid)
    if not 0 <= sk_valid <= Sk:
        raise ValueError(f"flash_attention: sk_valid {sk_valid} outside [0, {Sk}]")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if sk_valid == 0:                  # no key at all: every row is 0
        return out.zero_()
    lib = _build.library()
    code = lib.repro_flash_attention(
        DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, Sq, Sk, int(causal), window or 0,
        float(softcap or 0.0), float(D ** -0.5), int(q_offset), sk_valid,
        block_q, block_k, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            dout: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None):
    """The plain version of K1-bwd: ``torch.autograd.grad`` of
    ``flash_attention_ref`` in float32, the gradients cast to the inputs'
    dtypes. Returns (dq, dk, dv). A row with no valid key gets mean(V)
    forward here, so its dO reaches dV; in the kernel it is 0 and has no
    gradient (training's masks leave every row a key)."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_(True)
                      for t in (q, k, v))
        out = flash_attention_ref(qf, kf, vf, causal=causal, window=window,
                                  softcap=softcap)
        dq, dk, dv = torch.autograd.grad(out, (qf, kf, vf), dout.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """dq, dk, dv of K1's function at (q, k, v), given its output ``out``
    and the output's gradient ``dout`` (both (B, Hq, Sq, D)).

    On a CUDA tensor this launches K1-bwd's three passes (one count) or
    raises; a CPU tensor takes the plain version. q_offset is 0 and every
    key is valid: training sets neither (``FlashAttention`` refuses them).
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                       window=window, softcap=softcap)
    check_inputs("flash_attention_bwd", q, k, v, out, dout)
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or Hq % Hkv \
            or out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_bwd: window must be >= 1, got "
                         f"{window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention_bwd: softcap must be > 0, got "
                         f"{softcap}")
    if q.numel() == 0 or k.numel() == 0:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # scratch of pass 0: each row's lse and rowsum(dO * O), float32
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    code = _build.library().repro_flash_attention_bwd(
        DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), lse.data_ptr(), delta.data_ptr(), B, Hq, Hkv, Sq, Sk,
        int(causal), window or 0, float(softcap or 0.0), float(D ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """K1 with its gradient: the forward launches K1 and keeps (q, k, v,
    out); the backward launches K1-bwd. Under
    ``torch.utils.checkpoint`` the forward runs twice and the backward
    once."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, block_q, block_k):
        out = flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, block_q=block_q,
                              block_k=block_k)
        ctx.save_for_backward(q, k, v, out)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None, q_offset: int = 0,
                         block_q: int = 64, block_k: int = 64
                         ) -> torch.Tensor:
    """K1 through ``FlashAttention``, so that autograd reaches K1-bwd. The
    backward takes q_offset 0 only: training never sets it."""
    if q_offset:
        raise ValueError(f"flash_attention: q_offset {q_offset} has no "
                         f"gradient kernel (K1-bwd takes q_offset 0)")
    return FlashAttention.apply(q, k, v, causal, window, softcap, block_q,
                                block_k)

"""K1: blockwise (flash) attention for prefill — the Hopper kernel's wrapper
and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention`` (body ``_flash_kernel``). The CUDA source is
``csrc/flash_attention.cu``: bfloat16 runs v3 (wgmma tensor-core tiles fed
by TMA), float32 runs v4 (float32 FMA on the CUDA cores, since TF32 would
miss the float32 tolerance: 8-row register micro-tiles fed by cp.async).
Its header note says how the TPU grid's sequential K axis became a loop
inside one block, and what bounds it. Either kernel can also write each
row's logsumexp (``_flash_attention_fwd``), which K1-bwd takes.

K1-bwd, the gradient of K1's function, has no Pallas counterpart: the
reference's K1 has no custom_vjp, so JAX trains on its plain path. Here it
is ``csrc/flash_attention_bwd.cu`` (delta = rowsum(dO ∘ O), dK and dV per
query head, dQ, the group's dK/dV shares summed), reached only through
``FlashAttention``, a ``torch.autograd.Function`` whose forward is K1 with
its lse: ``kernels.ops`` routes there when grad mode is on and an input
requires grad.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref

HEAD_DIMS = (64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (block_q, block_k) each dtype's kernel takes: v3 (bf16) has one or two
# 64-row consumer warpgroups and a wgmma N of block_k; v4 (f32) the same
# tiles, 2·block_q threads of 8 rows, within shared memory.
TILES = {torch.bfloat16: ((64, 128), (32, 64, 128)),
         torch.float32: ((64, 128), (32, 64, 128))}
TILE_SIZES = (64, 128)             # block_q both kernels take
SMEM_BYTES = 232_448               # dynamic shared memory a block may use


def smem_bytes(rows: int, block_k: int, head_dim: int) -> int:
    """Shared memory of one v4 (float32) attention block
    (csrc/flash_attention.cu ``v4::Layout``): the Q tile, the K tile with
    rows padded to D + 4, the V tile and P with rows padded to block_k + 4."""
    return 4 * (rows * head_dim + block_k * (head_dim + 4)
                + block_k * head_dim + rows * (block_k + 4))


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


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None, q_offset: int = 0,
                            sk_valid: Optional[int] = None) -> torch.Tensor:
    """The plain version of K1's lse: each row's logsumexp of the scaled,
    softcapped, masked logits in float32, (B, Hq, Sq); +inf for a row with
    no valid key (so exp(S − lse) is 0 there). ``v`` is unused; it keeps
    K1's arguments."""
    del v
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Sq, D) * (D ** -0.5)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    ok = _ref._attn_mask(Sq, Sk, causal=causal, window=window,
                         q_offset=q_offset, device=q.device)
    if sk_valid is not None:
        ok = ok & (torch.arange(Sk, device=q.device) < sk_valid)
    lse = torch.logsumexp(torch.where(ok, logits, -torch.inf), dim=-1)
    lse = lse.reshape(B, Hq, Sq)
    return torch.where(lse == -torch.inf, torch.inf, lse)


def _launch(q, k, v, causal, window, softcap, q_offset, sk_valid, block_q,
            block_k, want_lse):
    """Checks, then one K1 launch (one count). Returns (out, lse or None)."""
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
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) \
        if want_lse else None
    if out.numel() == 0:
        return out, lse
    if sk_valid == 0:                  # no key at all: every row is 0
        if lse is not None:
            lse.fill_(torch.inf)
        return out.zero_(), lse
    code = _build.library().repro_flash_attention(
        DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), B, Hq, Hkv,
        Sq, Sk, int(causal), window or 0, float(softcap or 0.0),
        float(D ** -0.5), int(q_offset), sk_valid, block_q, block_k,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    sk_valid: Optional[int] = None, block_q: int = 64,
                    block_k: int = 64) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D). Returns (B, Hq, Sq, D).

    On a CUDA tensor this launches the Hopper kernel (or raises); a CPU
    tensor takes the plain version. ``q_offset`` and ``sk_valid`` are host
    ints: absolute position of query row 0, and the number of valid keys.
    The kernel writes no lse here.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset,
                                   sk_valid=sk_valid)
    return _launch(q, k, v, causal, window, softcap, q_offset, sk_valid,
                   block_q, block_k, want_lse=False)[0]


flash_attention.launches = 0


def _flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None, q_offset: int = 0,
                         sk_valid: Optional[int] = None, block_q: int = 64,
                         block_k: int = 64):
    """K1 with each row's lse: (out, lse float32 (B, Hq, Sq)). One launch,
    counted on ``flash_attention``; a CPU tensor takes the plain versions.
    ``FlashAttention`` calls it and hands lse to K1-bwd."""
    if q.device.type == "cpu":
        kw = dict(causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset, sk_valid=sk_valid)
        return (flash_attention_ref(q, k, v, **kw),
                flash_attention_lse_ref(q, k, v, **kw))
    return _launch(q, k, v, causal, window, softcap, q_offset, sk_valid,
                   block_q, block_k, want_lse=True)


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
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """dq, dk, dv of K1's function at (q, k, v), given its output ``out``,
    the output's gradient ``dout`` (both (B, Hq, Sq, D)) and the forward's
    lse (float32 (B, Hq, Sq), from ``_flash_attention_fwd``).

    On a CUDA tensor this launches K1-bwd (delta, dK/dV, dQ and, with
    grouped heads, the group sum: one count) or raises; a CPU tensor takes
    the plain version. q_offset is 0 and every key is valid: training sets
    neither (``FlashAttention`` refuses them).
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
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be contiguous "
                         f"float32 {(B, Hq, Sq)} on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
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
    # scratch: rowsum(dO * O), and each query head's dK/dV share when a KV
    # head serves several
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    shares = [torch.empty((B, Hq, Sk, D), dtype=torch.float32,
                          device=q.device) for _ in range(2)] \
        if Hq > Hkv else [None, None]
    code = _build.library().repro_flash_attention_bwd(
        DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        *(None if t is None else t.data_ptr() for t in shares), B, Hq, Hkv,
        Sq, Sk, int(causal), window or 0, float(softcap or 0.0),
        float(D ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """K1 with its gradient: the forward launches K1 with its lse and keeps
    (q, k, v, out, lse); the backward launches K1-bwd on them. Under
    ``torch.utils.checkpoint`` the forward runs twice and the backward
    once."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, block_q, block_k):
        out, lse = _flash_attention_fwd(q, k, v, causal=causal,
                                        window=window, softcap=softcap,
                                        block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, **ctx.kw)
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

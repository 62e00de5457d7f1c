"""Plain PyTorch versions of the kernels on the serving path: attention and
the Mamba2 SSD scan.

Counterparts of ``repro/kernels/ref.py`` (same arguments, same layouts, same
masking rules). They compute in float32 and return the input dtype (the SSD
states stay float32). They are the execution path for tensors on the CPU
and the oracle every Hopper kernel in ``csrc/`` is held against on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

NEG_INF = -1e30

IntOrTensor = Union[int, torch.Tensor]


def _attn_mask(sq: int, sk: int, *, causal: bool, window: Optional[int],
               q_offset: IntOrTensor = 0, device=None) -> torch.Tensor:
    """(sq, sk) boolean mask. q position i attends to k position j iff
    j <= i+q_offset (causal) and i+q_offset - j < window (sliding window).
    ``q_offset`` may be a 0-d device tensor (paged chunked prefill), so the
    mask is built without a host sync."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    return mask


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None, q_offset: IntOrTensor = 0,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference grouped-query attention.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0.
    kv_len: optional (B,) valid KV lengths (entries >= kv_len are masked).
    A row with no valid key gets the plain mean of V (softmax over equal
    logits), as in the reference package; the kernels write 0 there.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qf = q.float() * (D ** -0.5)
    qg = qf.reshape(B, Hkv, group, Sq, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _attn_mask(Sq, Sk, causal=causal, window=window, q_offset=q_offset,
                      device=q.device)
    if kv_len is not None:
        valid = torch.arange(Sk, device=q.device)[None, :] < kv_len[:, None]
        mask = mask[None, :, :] & valid[:, None, :]            # (B, Sq, Sk)
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    else:
        logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def mha_attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None, q_offset: int = 0,
                          block_q: int = 1024) -> torch.Tensor:
    """Query-chunked ``mha_attention``: O(block_q * Sk) temporaries instead
    of O(Sq * Sk), numerically identical to the unchunked function."""
    Sq = q.shape[2]
    if Sq <= block_q:
        return mha_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, q_offset=q_offset)
    outs = [mha_attention(q[:, :, s:s + block_q], k, v, causal=causal,
                          window=window, softcap=softcap,
                          q_offset=q_offset + s)
            for s in range(0, Sq, block_q)]
    return torch.cat(outs, dim=2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, kv_len: torch.Tensor,
                     softcap: Optional[float] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token decode attention against a partially filled cache.

    q: (B, Hq, 1, D); caches: (B, Hkv, Smax, D); kv_len: (B,) valid positions
    (the new token's own K/V already written at kv_len-1).

    Sliding-window fast path: when the window is much smaller than the
    cache, only the last ``window`` rows of each lane are gathered before the
    dense attention, so work scales with the window.
    """
    B, Hq, _, D = q.shape
    Smax = k_cache.shape[2]
    if window is not None and Smax > 2 * window:
        w = window
        start = torch.clamp(kv_len - w, 0, Smax - w).long()           # (B,)
        idx = start[:, None] + torch.arange(w, device=q.device)[None]  # (B, w)
        gidx = idx[:, None, :, None].expand(B, k_cache.shape[1], w, D)
        k_win = torch.gather(k_cache, 2, gidx)
        v_win = torch.gather(v_cache, 2, gidx)
        return decode_attention(q, k_win, v_win, kv_len=kv_len - start,
                                softcap=softcap, window=None)
    Hkv = k_cache.shape[1]
    group = Hq // Hkv
    qg = (q.float() * (D ** -0.5)).reshape(B, Hkv, group, 1, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k_cache.float())
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    kpos = torch.arange(Smax, device=q.device)[None, :]
    valid = kpos < kv_len[:, None]
    if window is not None:
        valid &= kpos >= (kv_len[:, None] - window)
    logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v_cache.float())
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def gather_paged_kv(pool: torch.Tensor,
                    block_tables: torch.Tensor) -> torch.Tensor:
    """Contiguous per-lane view of a paged KV pool.

    pool: (num_blocks, Hkv, block_size, D); block_tables: (B, max_blocks)
    int32 (dead entries point at the null block 0; attention masks them by
    kv_len). Returns (B, Hkv, max_blocks * block_size, D).
    """
    g = pool[block_tables.long()]                # (B, mb, Hkv, bs, D)
    B, mb, Hkv, bs, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, mb * bs, D)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor, *,
                           kv_len: torch.Tensor,
                           softcap: Optional[float] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """Single-token decode attention read through block tables: gather the
    lane's blocks into a contiguous view, then dense masked decode.

    q: (B, Hq, 1, D); pools: (num_blocks, Hkv, block_size, D);
    block_tables: (B, max_blocks) int32; kv_len: (B,).
    """
    k = gather_paged_kv(k_pool, block_tables)
    v = gather_paged_kv(v_pool, block_tables)
    return decode_attention(q, k, v, kv_len=kv_len, softcap=softcap,
                            window=window)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference Mamba2 SSD recurrence (exact sequential scan).

    x (B, H, S, P); dt (B, H, S) softplus-activated step sizes (> 0);
    A (H,) negative decay rates; Bmat, Cmat (B, S, N), shared across heads
    (ngroups = 1); init_state (B, H, P, N) or None.
    Returns (y (B, H, S, P) in x.dtype, final_state (B, H, P, N) float32).

    Per head:  state_t = exp(dt_t * A) * state_{t-1} + dt_t * x_t B_t^T
               y_t = state_t C_t
    """
    Bsz, H, S, P = x.shape
    N = Bmat.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = Bmat.float(), Cmat.float()
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, :, t] * Af[None, :])                 # (B, H)
        upd = torch.einsum("bhp,bn->bhpn", xf[:, :, t] * dtf[:, :, t, None],
                           Bf[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    y = torch.stack(ys, dim=2) if ys else xf
    return y.to(x.dtype), state


def ssd_scan_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bmat: torch.Tensor, Cmat: torch.Tensor, *,
                     chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD: the same algebra as the Hopper kernel (per chunk a masked
    decay-weighted C B^T, att @ x, and the carried state), in batched
    matmuls. The sequential ``ssd_scan`` is the oracle for both. S is padded
    to the chunk with dt = 0: an identity step with zero output.

    The within-chunk cumsum of dt * A runs in float64, as in the kernel:
    the decays exp(cum_i - cum_j) take the difference of two sums that reach
    tens in magnitude, and in float32 that cancellation is the chunked
    form's main error (about 2e-5 on y at S = 512, N = 128, the whole f32
    budget). Everything else is float32."""
    B, H, S, P = x.shape
    N = Bmat.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        dt = F.pad(dt, (0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // chunk
    xf = x.float().reshape(B, H, nc, chunk, P)
    dtf = dt.float().reshape(B, H, nc, chunk)
    Af = A.float()
    Bf = Bmat.float().reshape(B, nc, chunk, N)
    Cf = Cmat.float().reshape(B, nc, chunk, N)

    g = dtf * Af[None, :, None, None]                      # (B, H, nc, L)
    cum = torch.cumsum(g.double(), dim=-1)                 # float64
    seg = cum[..., :, None] - cum[..., None, :]            # (B, H, nc, L, L)
    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    # clamp BEFORE exp: masked (j > i) entries have seg > 0 and can overflow
    seg = torch.where(causal, seg, 0.0).float()
    decay = torch.where(causal, torch.exp(seg), 0.0)
    cb = torch.einsum("bcln,bcmn->bclm", Cf, Bf)           # (B, nc, L, L)
    att = cb[:, None] * decay * dtf[..., None, :]          # (B, H, nc, L, L)
    y_intra = torch.einsum("bhclm,bhcmp->bhclp", att, xf)

    # inter-chunk state carry, a loop over the nc chunks
    total = cum[..., -1]                                   # (B, H, nc)
    w = torch.exp((total[..., None] - cum).float()) * dtf  # (B, H, nc, L)
    chunk_state = torch.einsum("bhclp,bcln->bhcpn", xf * w[..., None], Bf)
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    in_states = []                                         # INCOMING states
    for c in range(nc):
        in_states.append(state)
        state = state * torch.exp(total[:, :, c].float())[..., None, None] \
            + chunk_state[:, :, c]
    y_inter = torch.exp(cum.float())[..., None] * torch.einsum(
        "bcln,bhcpn->bhclp", Cf, torch.stack(in_states, dim=2))
    y = (y_intra + y_inter).reshape(B, H, Sp, P)[:, :, :S]
    return y.to(x.dtype), state


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, Bvec: torch.Tensor, Cvec: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD state update. state (B, H, P, N), x (B, H, P), dt (B, H),
    Bvec/Cvec (B, N). Returns (y (B, H, P) in x.dtype, new state in
    state.dtype)."""
    decay = torch.exp(dt.float() * A.float()[None, :])
    upd = torch.einsum("bhp,bn->bhpn", x.float() * dt[..., None],
                       Bvec.float())
    new = state.float() * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new, Cvec.float())
    return y.to(x.dtype), new.to(state.dtype)

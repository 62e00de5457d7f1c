"""CPU rehearsal of K1's float32 kernel (v4) against the JAX package.

K1 v4 (``csrc/flash_attention.cu``, ``flash_fwd_f32``) runs only on a card
(tests/test_torch_gpu.py). Its tile walk is modelled here in torch on the
CPU and held against the Pallas ``repro.kernels.flash_attention`` (interpret
mode) and, for the lse it writes for K1-bwd, against the logsumexp of
``repro.kernels.ref``'s masked logits in JAX. What the mirror copies from
the kernel:

* tiles of block_q query rows by block_k keys (default 64 x 64), one block
  per (q tile, q head), the heaviest causal q tiles issued first;
* a block's key tiles run from its window's first tile (a tile edge) to
  its causal diagonal or sk_valid, whichever comes first;
* S = (Q·Kᵀ)·D^-0.5, the softcap, then the masks (-inf); the running max
  m over the row, base = m (0 while the row has seen no valid key),
  alpha = 2^((m_old − base)·log2 e), P = 2^((S − base)·log2 e);
* each of the 16 threads of a row keeps its own share of l over its keys
  (tx, tx + 16, ...), summed at the end by four butterfly shuffles;
* O = Σ P·V rescaled by alpha per tile, divided by l; a row with no valid
  key is 0 and its lse +inf; lse = m + log l otherwise.

Tolerance: float32 2e-5·max(1, ‖ref‖∞), as on the card.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import flash_attention as FA
from test_torch_flash_bwd import CASES

TOL = 2e-5
LOG2E = 1.4426950408889634
THREADS_PER_ROW = 16


def v4_block_order(Sq, Hq, block_q):
    """(q tile, q head) of each block in grid order: blockIdx.x runs over
    n_qt·Hq, q tile n_qt − 1 − x // Hq (the heaviest causal tile first)."""
    n_qt = -(-Sq // block_q)
    return [(n_qt - 1 - x // Hq, x % Hq) for x in range(n_qt * Hq)]


def v4_key_tiles(q0, rows, *, block_k, causal, window, q_offset, sk_valid):
    """The key tiles [k_begin, k_end) one block walks."""
    k_end = sk_valid
    if causal:
        k_end = min(k_end, q0 + rows - 1 + q_offset + 1)
    k_begin = max(0, q0 + q_offset - window + 1) if window is not None else 0
    k_begin = (k_begin // block_k) * block_k
    return list(range(k_begin, k_end, block_k)) if k_end > k_begin else []


def _butterfly_sum(x):
    """Sum over the last axis (16 lanes) as four xor shuffles add it."""
    idx = torch.arange(x.shape[-1])
    for o in (8, 4, 2, 1):
        x = x + x[..., idx ^ o]
    return x[..., 0]


def k1_fwd_mirror(q, k, v, *, causal=True, window=None, softcap=None,
                  q_offset=0, sk_valid=None, block_q=64, block_k=64):
    """K1 v4's arithmetic in float32. q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D).
    Returns (out, lse)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    sk_valid = Sk if sk_valid is None else sk_valid
    scale = D ** -0.5
    q, k, v = q.float(), k.float(), v.float()
    out = torch.zeros((B, Hq, Sq, D))
    lse = torch.zeros((B, Hq, Sq))
    lanes = torch.arange(block_k) % THREADS_PER_ROW     # the key's thread
    for qt, h in v4_block_order(Sq, Hq, block_q):
        q0 = qt * block_q
        rows = min(block_q, Sq - q0)
        qs = q[:, h, q0:q0 + rows]
        qpos = torch.arange(q0, q0 + rows)[:, None] + q_offset
        m = torch.full((B, rows), -math.inf)
        l = torch.zeros((B, rows, THREADS_PER_ROW))
        acc = torch.zeros((B, rows, D))
        for k0 in v4_key_tiles(q0, rows, block_k=block_k, causal=causal,
                               window=window, q_offset=q_offset,
                               sk_valid=sk_valid):
            kt = torch.zeros((B, block_k, D))    # zeros past sk_valid
            vt = torch.zeros((B, block_k, D))
            n = min(block_k, sk_valid - k0)
            kt[:, :n] = k[:, h // G, k0:k0 + n]
            vt[:, :n] = v[:, h // G, k0:k0 + n]
            x = (qs @ kt.transpose(-1, -2)) * scale
            if softcap is not None:
                x = softcap * torch.tanh(x / softcap)
            kpos = torch.arange(k0, k0 + block_k)[None, :]
            ok = kpos < sk_valid
            if causal:
                ok = ok & (kpos <= qpos)
            if window is not None:
                ok = ok & (qpos - kpos < window)
            x = torch.where(ok, x, -math.inf)
            mx = torch.maximum(m, x.amax(-1))
            base = torch.where(mx == -math.inf, 0.0, mx)
            alpha = torch.exp2((m - base) * LOG2E)
            p = torch.exp2((x - base[..., None]) * LOG2E)
            share = torch.zeros((B, rows, THREADS_PER_ROW))
            share.index_add_(2, lanes, p)
            l = l * alpha[..., None] + share
            m = mx
            acc = acc * alpha[..., None] + p @ vt
        total = _butterfly_sum(l)
        inv = torch.where(total == 0, 0.0, 1.0 / torch.where(total == 0, 1.0,
                                                             total))
        out[:, h, q0:q0 + rows] = acc * inv[..., None]
        lse[:, h, q0:q0 + rows] = torch.where(
            total > 0, m + torch.log(torch.where(total > 0, total, 1.0)),
            math.inf)
    return out, lse


def _inputs(seed, B, hq, hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, hq, Sq, D), (B, hkv, Sk, D), (B, hkv, Sk, D))]


def _jax_lse(qn, kn, *, causal=True, window=None, softcap=None, q_offset=0,
             sk_valid=None):
    """Each row's logsumexp of the reference's masked logits (JAX), +inf
    where no key is valid."""
    B, Hq, Sq, D = qn.shape
    Hkv, Sk = kn.shape[1], kn.shape[2]
    qg = jnp.asarray(qn).reshape(B, Hkv, Hq // Hkv, Sq, D) * D ** -0.5
    logits = jnp.einsum("bhgqd,bhkd->bhgqk", qg, jnp.asarray(kn))
    if softcap is not None:
        logits = softcap * jnp.tanh(logits / softcap)
    ok = jref._attn_mask(Sq, Sk, causal=causal, window=window,
                         q_offset=q_offset)
    if sk_valid is not None:
        ok = ok & (jnp.arange(Sk) < sk_valid)[None, :]
    lse = jax.nn.logsumexp(jnp.where(ok, logits, -jnp.inf), axis=-1)
    lse = np.asarray(lse, np.float32).reshape(B, Hq, Sq)
    return np.where(np.isneginf(lse), np.inf, lse)


def _valid(Sq, Sk, causal, window, q_offset, sk_valid):
    """(Sq,) rows with at least one valid key."""
    qpos = np.arange(Sq)[:, None] + q_offset
    kpos = np.arange(Sk)[None, :]
    ok = np.broadcast_to(kpos < (Sk if sk_valid is None else sk_valid),
                         (Sq, Sk))
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (qpos - kpos < window)
    return ok.any(-1)


def _close(name, got, want, rows=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    if rows is not None:
        got, want = got[:, :, rows], want[:, :, rows]
    lim = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{name}: max err {err:.3e} > {lim:.3e}"


def check_case(seed, B, hq, hkv, Sq, Sk, D, kw, block_q=64, block_k=64):
    """v4's mirror against the Pallas kernel (interpret mode) and its lse
    against JAX's logsumexp and the port's plain lse; rows with no valid
    key are 0 with lse +inf."""
    qn, kn, vn = _inputs(seed, B, hq, hkv, Sq, Sk, D)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    out, lse = k1_fwd_mirror(q, k, v, block_q=block_q, block_k=block_k, **kw)
    want = pallas_flash(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                        block_q=64, block_k=64, interpret=True, **kw)
    rows = _valid(Sq, Sk, kw.get("causal", True), kw.get("window"),
                  kw.get("q_offset", 0), kw.get("sk_valid"))
    _close("out vs pallas", out, want)
    assert torch.count_nonzero(out[:, :, ~torch.from_numpy(rows)]) == 0
    _close("lse vs jax", lse, _jax_lse(qn, kn, **kw), rows)
    want_lse = FA.flash_attention_lse_ref(q, k, v, **kw)
    _close("lse vs the port's plain lse", lse, want_lse, rows)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    assert (lse[:, :, ~torch.from_numpy(rows)] == math.inf).all()


# (B, Hq, Hkv, Sq, Sk, D, kwargs): tests/test_torch_flash_bwd.py's CASES
# (the training paths' masks), then a negative q_offset under a window
# that begins inside a tile, and sk_valid < Sk with a q_offset
FWD_CASES = CASES + [
    (1, 4, 2, 150, 150, 64, dict(causal=True, q_offset=-70, window=33)),
    (1, 6, 2, 37, 101, 128, dict(causal=True, q_offset=64, sk_valid=77)),
]


@pytest.mark.parametrize("B,hq,hkv,Sq,Sk,D,kw", FWD_CASES)
def test_v4_mirror_matches_pallas_and_jax(B, hq, hkv, Sq, Sk, D, kw):
    check_case(Sq * 3 + hq, B, hq, hkv, Sq, Sk, D, kw)


@pytest.mark.parametrize("block_q", [64, 128])
@pytest.mark.parametrize("block_k", [32, 64, 128])
def test_v4_mirror_every_tile(block_q, block_k):
    """Each tile v4 takes walks the same function: ragged Sq, a window
    across tiles and a q_offset."""
    check_case(7, 1, 4, 2, 200, 230, 64,
               dict(causal=True, window=90, q_offset=30), block_q, block_k)


def test_v4_blocks_issue_the_heaviest_causal_tiles_first():
    """Grid order gives every head its last (longest causal) q tile first;
    the key tiles walked never grow along the order."""
    order = v4_block_order(300, 3, 64)
    assert len(order) == 5 * 3 and len(set(order)) == 15
    work = [len(v4_key_tiles(qt * 64, min(64, 300 - qt * 64), block_k=64,
                             causal=True, window=None, q_offset=0,
                             sk_valid=300)) for qt, _ in order]
    assert work == sorted(work, reverse=True) and work[0] == 5


def test_shared_memory_and_tiles_follow_v4():
    """The wrapper's tile table and shared-memory count are v4's: the same
    tiles as v3, 67 KB at the default tile (three blocks to an SM), and
    128 x 128 over the limit at D 128 only."""
    assert FA.TILES[torch.float32] == FA.TILES[torch.bfloat16]
    assert FA.smem_bytes(64, 64, 64) == 4 * (64 * 64 * 2 + 64 * 68 * 2)
    assert 3 * FA.smem_bytes(64, 64, 64) <= FA.SMEM_BYTES
    assert FA.smem_bytes(128, 128, 64) <= FA.SMEM_BYTES
    assert FA.smem_bytes(128, 128, 128) > FA.SMEM_BYTES
    assert all(FA.smem_bytes(bq, bk, 128) <= FA.SMEM_BYTES
               for bq in (64, 128) for bk in (32, 64, 128)
               if (bq, bk) != (128, 128))


def test_lse_helper_on_the_host_is_the_plain_version():
    """On CPU tensors ``_flash_attention_fwd`` returns the plain output and
    the plain lse, and counts no launch."""
    qn, kn, vn = _inputs(3, 1, 4, 2, 40, 40, 64)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    kw = dict(causal=True, window=9, q_offset=-3)
    before = FA.flash_attention.launches
    out, lse = FA._flash_attention_fwd(q, k, v, **kw)
    assert FA.flash_attention.launches == before
    assert torch.equal(out, FA.flash_attention_ref(q, k, v, **kw))
    assert torch.equal(lse, FA.flash_attention_lse_ref(q, k, v, **kw))
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 40)
    assert torch.isinf(lse[:, :, :3]).all()
    assert torch.isfinite(lse[:, :, 3:]).all()

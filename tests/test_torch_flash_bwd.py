"""CPU rehearsal of K1-bwd's arithmetic against the JAX package.

K1-bwd (``csrc/flash_attention_bwd.cu``) runs only on a card
(tests/test_torch_gpu.py). Its algorithm is modelled here in torch on the
CPU, tile for tile, and held against two independent gradients of the same
attention: ``torch.autograd`` of the port's plain version
(``flash_attention_bwd_ref``) and ``jax.grad`` of
``repro.kernels.ref.mha_attention`` (the JAX package's Pallas K1 has no
gradient, so its plain function is the target). What the mirror copies
from the kernel:

* tiles of 64 query rows by 64 keys, and the same tile ranges: a q tile
  visits key tiles from its window's first one to the causal diagonal, a k
  tile visits the q tiles from the diagonal to its window's last one;
* pass 0 recomputes each row's softmax max and sum online over the key
  tiles (scores only, no P·V), lse = m + log l (+inf for a row with no
  valid key), and delta = rowsum(dO ∘ O) from the forward's output;
* pass 1 walks, per KV head, the group's G query heads in order and their
  q tiles, recomputes P = exp(S − lse), and accumulates dV += Pᵀ·dO and
  dK += dSᵀ·(Q·D^-0.5) with dS = P ∘ (dO·Vᵀ − delta) ∘ (1 − tanh²) under a
  softcap;
* pass 2 accumulates dQ += dS·K over the visible key tiles, then scales by
  D^-0.5;
* Q is scaled by D^-0.5 as it is loaded (the forward's order of rounding).

Tolerance: float32 2e-5·max(1, ‖ref‖∞), as on the card. This mirror lives
here, not in the package.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as FA

TILE = 64
TOL = 2e-5


def _capped(s, softcap):
    """(logit, 1 - tanh²) of scaled scores s."""
    if softcap is None:
        return s, torch.ones_like(s)
    t = torch.tanh(s / softcap)
    return softcap * t, 1 - t * t


def _mask(q0, nq, k0, nk, Sq, Sk, causal, window):
    qpos = torch.arange(q0, q0 + nq)[:, None]
    kpos = torch.arange(k0, k0 + nk)[None, :]
    ok = (qpos < Sq) & (kpos < Sk)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= (qpos - kpos) < window
    return ok


def _key_range(q0, rows, Sk, causal, window):
    end = min(Sk, q0 + rows) if causal else Sk
    begin = max(0, q0 - window + 1) if window is not None else 0
    return (begin // TILE) * TILE, end


def _ds_tile(qs, dos, kt, vt, lse, delta, ok, softcap):
    """P and dS of one tile: qs/dos (..., rows, D), kt/vt (..., keys, D),
    lse/delta (..., rows)."""
    x, dcap = _capped(qs @ kt.transpose(-1, -2), softcap)
    p = torch.where(ok, torch.exp(x - lse[..., None]), 0.0)
    dp = dos @ vt.transpose(-1, -2)
    return p, p * (dp - delta[..., None]) * dcap


def k1_bwd_mirror(q, k, v, o, do, *, causal=True, window=None, softcap=None):
    """K1-bwd's three passes, float32. q/o/do (B, Hq, Sq, D), k/v (B, Hkv,
    Sk, D). Returns (dq, dk, dv, lse)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    k, v, o, do = (t.float() for t in (k, v, o, do))
    qs = q.float() * scale                      # scaled as it is loaded
    kh = k.repeat_interleave(G, dim=1)          # the KV head of each q head
    vh = v.repeat_interleave(G, dim=1)

    # pass 0: lse by the online max and sum over key tiles; delta
    delta = (do * o).sum(-1)
    lse = torch.full((B, Hq, Sq), math.inf)
    for q0 in range(0, Sq, TILE):
        rows = min(TILE, Sq - q0)
        m = torch.full((B, Hq, rows), -math.inf)
        l = torch.zeros((B, Hq, rows))
        kb, ke = _key_range(q0, rows, Sk, causal, window)
        for k0 in range(kb, ke, TILE):
            nk = min(TILE, Sk - k0)
            x, _ = _capped(qs[:, :, q0:q0 + rows] @
                           kh[:, :, k0:k0 + nk].transpose(-1, -2), softcap)
            ok = _mask(q0, rows, k0, nk, Sq, Sk, causal, window)
            x = torch.where(ok, x, -math.inf)
            m_new = torch.maximum(m, x.amax(-1))
            live = m_new > -math.inf
            mn = torch.where(live, m_new, 0.0)
            s = torch.where(live[..., None], torch.exp(x - mn[..., None]), 0.0)
            l = torch.where(live, l * torch.exp(m - mn) + s.sum(-1), l)
            m = torch.where(live, m_new, m)
        lse[:, :, q0:q0 + rows] = torch.where(l > 0, m + torch.log(l),
                                              math.inf)

    # pass 1: dK and dV per (k tile, KV head), the group's heads in order
    dk = torch.zeros((B, Hkv, Sk, D))
    dv = torch.zeros((B, Hkv, Sk, D))
    for k0 in range(0, Sk, TILE):
        nk = min(TILE, Sk - k0)
        kt, vt = k[:, :, k0:k0 + nk], v[:, :, k0:k0 + nk]
        qb = k0 if causal else 0
        qe = min(Sq, k0 + nk - 1 + window) if window is not None else Sq
        for g in range(G):
            heads = torch.arange(Hkv) * G + g
            for q0 in range(qb, qe, TILE):
                rows = min(TILE, Sq - q0)
                sl = (slice(None), heads, slice(q0, q0 + rows))
                ok = _mask(q0, rows, k0, nk, Sq, Sk, causal, window)
                p, ds = _ds_tile(qs[sl], do[sl], kt, vt, lse[sl], delta[sl],
                                 ok, softcap)
                dv[:, :, k0:k0 + nk] += p.transpose(-1, -2) @ do[sl]
                dk[:, :, k0:k0 + nk] += ds.transpose(-1, -2) @ qs[sl]

    # pass 2: dQ per (q tile, q head) over the visible key tiles
    dq = torch.zeros((B, Hq, Sq, D))
    for q0 in range(0, Sq, TILE):
        rows = min(TILE, Sq - q0)
        sl = (slice(None), slice(None), slice(q0, q0 + rows))
        kb, ke = _key_range(q0, rows, Sk, causal, window)
        for k0 in range(kb, ke, TILE):
            nk = min(TILE, Sk - k0)
            ok = _mask(q0, rows, k0, nk, Sq, Sk, causal, window)
            _, ds = _ds_tile(qs[sl], do[sl], kh[:, :, k0:k0 + nk],
                             vh[:, :, k0:k0 + nk], lse[sl], delta[sl], ok,
                             softcap)
            dq[sl] += ds @ kh[:, :, k0:k0 + nk]
    return dq * scale, dk, dv, lse


def _inputs(seed, B, hq, hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    shapes = [(B, hq, Sq, D), (B, hkv, Sk, D), (B, hkv, Sk, D),
              (B, hq, Sq, D)]
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _close(name, got, want):
    want = np.asarray(want, dtype=np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    lim = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{name}: max err {err:.3e} > {lim:.3e}"


# (B, Hq, Hkv, Sq, Sk, D, kwargs): smollm's G = 3, qwen2-vl's G = 7, MHA,
# ragged lengths (not multiples of the 64-row tile), a window inside one
# tile and one across tiles, grok-1's softcap of 30 and a small softcap
# that bends every logit, and whisper's cross shape (Sq != Sk, non-causal)
CASES = [
    (2, 6, 2, 100, 100, 64, dict(causal=True)),
    (1, 7, 1, 130, 130, 64, dict(causal=True)),
    (1, 4, 4, 150, 150, 64, dict(causal=True, window=17)),
    (1, 6, 2, 140, 140, 128, dict(causal=True, window=90)),
    (1, 4, 2, 96, 96, 64, dict(causal=True, softcap=30.0)),
    (1, 4, 2, 96, 96, 64, dict(causal=True, softcap=2.0, window=33)),
    (1, 4, 4, 24, 150, 64, dict(causal=False)),
    (1, 6, 3, 70, 130, 64, dict(causal=False, softcap=5.0)),
]


@pytest.mark.parametrize("B,hq,hkv,Sq,Sk,D,kw", CASES)
def test_mirror_matches_torch_autograd_and_jax_grad(B, hq, hkv, Sq, Sk, D, kw):
    qn, kn, vn, don = _inputs(Sq * 7 + hq, B, hq, hkv, Sq, Sk, D)
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    o = FA.flash_attention_ref(q, k, v, **kw)
    dq, dk, dv, _ = k1_bwd_mirror(q, k, v, o, do, **kw)
    # the port's plain version: torch.autograd of flash_attention_ref
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv),
                               FA.flash_attention_bwd_ref(q, k, v, do, **kw)):
        _close(f"{name} vs torch", got, want)
    # the reference: jax.grad of repro.kernels.ref.mha_attention
    def loss(qj, kj, vj):
        out = jref.mha_attention(qj, kj, vj, causal=kw["causal"],
                                 window=kw.get("window"),
                                 softcap=kw.get("softcap"))
        return jnp.sum(out * don)
    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(qn), jnp.asarray(kn),
                                           jnp.asarray(vn))
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), jg):
        _close(f"{name} vs jax", got, want)


def test_wrapper_on_the_host_is_the_plain_version():
    """On CPU tensors the K1-bwd wrapper returns its plain version, counts
    no launch, and keeps the inputs' dtype."""
    qn, kn, vn, don = _inputs(5, 1, 4, 2, 40, 40, 64)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in (qn, kn, vn, don))
    before = FA.flash_attention_bwd.launches
    got = FA.flash_attention_bwd(q, k, v, FA.flash_attention_ref(q, k, v), do)
    want = FA.flash_attention_bwd_ref(q, k, v, do)
    assert FA.flash_attention_bwd.launches == before
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)


def test_lse_is_the_row_logsumexp_and_empty_rows_get_no_gradient():
    """Pass 0's lse equals logsumexp over each row's valid logits; a row
    whose window holds no key (causal, Sq > Sk) has lse = +inf and gives
    no gradient in any pass, where the kernel's forward writes 0."""
    B, hq, hkv, Sq, Sk, D, window = 1, 2, 1, 90, 40, 64, 20
    qn, kn, vn, don = _inputs(11, B, hq, hkv, Sq, Sk, D)
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    o = FA.flash_attention_ref(q, k, v, causal=True, window=window)
    qpos = torch.arange(Sq)
    empty = qpos - (Sk - 1) >= window                 # no key in the window
    o[:, :, empty] = 0.0                              # the kernel's forward
    dq, dk, dv, lse = k1_bwd_mirror(q, k, v, o, do, causal=True,
                                    window=window)
    assert empty.any() and torch.isinf(lse[:, :, empty]).all()
    assert (dq[:, :, empty] == 0).all()
    logits = (q * D ** -0.5) @ k.repeat_interleave(hq // hkv, 1).transpose(-1, -2)
    ok = FA._ref._attn_mask(Sq, Sk, causal=True, window=window)
    want = torch.logsumexp(torch.where(ok, logits, -math.inf), dim=-1)
    torch.testing.assert_close(lse[:, :, ~empty], want[:, :, ~empty],
                               atol=2e-5, rtol=2e-5)
    # rows with a key: the gradients are torch's over those rows alone
    keep = ~empty
    qk, dok = q[:, :, keep].clone(), do[:, :, keep].clone()
    wq, wk, wv = FA.flash_attention_bwd_ref(qk, k, v, dok, causal=True,
                                            window=window)
    _close("dq", dq[:, :, keep], wq)
    _close("dk", dk, wk)
    _close("dv", dv, wv)

"""CPU rehearsal of K1-bwd's arithmetic against the JAX package.

K1-bwd (``csrc/flash_attention_bwd.cu``) runs only on a card
(tests/test_torch_gpu.py). Its algorithm is modelled here in torch on the
CPU, tile for tile, and held against two independent gradients of the same
attention: ``torch.autograd`` of the port's plain version
(``flash_attention_bwd_ref``) and ``jax.grad`` of
``repro.kernels.ref.mha_attention`` (the JAX package's Pallas K1 has no
gradient, so its plain function is the target). What the mirror copies
from the kernel:

* each row's lse comes from the forward: K1 v4's mirror
  (tests/test_torch_flash_f32.py), which the kernel's forward computes in
  the same walk; no pass over the keys recomputes it;
* tiles of 64 query rows by 64 keys, and the same tile ranges: a q tile
  visits key tiles from its window's first one to the causal diagonal, a k
  tile visits the q tiles from the diagonal to its window's last one;
* delta = rowsum(dO ∘ O) from the forward's output;
* the dK/dV pass runs per (k tile, query head): over its q tiles it forms
  dPᵀ = V·dOᵀ and Sᵀ = K·Qᵀ, P = exp(S·D^-0.5 capped − lse) and dS = P ∘
  (dP − delta) ∘ (1 − tanh²) under a softcap, and accumulates dV += Pᵀ·dO
  and dK += dSᵀ·Q, dK scaled by D^-0.5 at the end; with one query head per
  KV head that is dK and dV, else each head's share, summed over the group
  in head order by a last pass;
* the dQ pass forms S and dP again per (q tile, query head) over the
  visible key tiles and accumulates dQ += dS·K, then scales by D^-0.5.

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


def _ds_tile(s, dp, lse, delta, ok, softcap, scale):
    """P and dS of one tile from the unscaled scores s and dP = dO·Vᵀ
    (..., rows, keys), lse/delta (..., rows)."""
    x, dcap = _capped(s * scale, softcap)
    p = torch.where(ok, torch.exp(x - lse[..., None]), 0.0)
    return p, p * (dp - delta[..., None]) * dcap


def k1_bwd_mirror(q, k, v, o, do, lse, *, causal=True, window=None,
                  softcap=None):
    """K1-bwd's passes, float32, on the forward's lse. q/o/do (B, Hq, Sq,
    D), k/v (B, Hkv, Sk, D), lse (B, Hq, Sq). Returns (dq, dk, dv)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    kh = k.repeat_interleave(G, dim=1)          # the KV head of each q head
    vh = v.repeat_interleave(G, dim=1)
    delta = (do * o).sum(-1)

    # dK and dV per (k tile, query head): each head's share
    dk_share = torch.zeros((B, Hq, Sk, D))
    dv_share = torch.zeros((B, Hq, Sk, D))
    for k0 in range(0, Sk, TILE):
        nk = min(TILE, Sk - k0)
        kt, vt = kh[:, :, k0:k0 + nk], vh[:, :, k0:k0 + nk]
        qb = k0 if causal else 0
        qe = min(Sq, k0 + nk - 1 + window) if window is not None else Sq
        dk_t = torch.zeros((B, Hq, nk, D))
        dv_t = torch.zeros((B, Hq, nk, D))
        for q0 in range(qb, qe, TILE):
            rows = min(TILE, Sq - q0)
            sl = (slice(None), slice(None), slice(q0, q0 + rows))
            ok = _mask(q0, rows, k0, nk, Sq, Sk, causal, window)
            dpt = vt @ do[sl].transpose(-1, -2)           # dPᵀ = V·dOᵀ
            st = kt @ q[sl].transpose(-1, -2)             # Sᵀ = K·Qᵀ
            p, ds = _ds_tile(st.transpose(-1, -2), dpt.transpose(-1, -2),
                             lse[sl], delta[sl], ok, softcap, scale)
            dv_t += p.transpose(-1, -2) @ do[sl]
            dk_t += ds.transpose(-1, -2) @ q[sl]
        dk_share[:, :, k0:k0 + nk] = dk_t * scale
        dv_share[:, :, k0:k0 + nk] = dv_t
    if G == 1:
        dk, dv = dk_share, dv_share
    else:                                      # the group sum, head order
        dk = torch.zeros((B, Hkv, Sk, D))
        dv = torch.zeros((B, Hkv, Sk, D))
        for g in range(G):
            dk += dk_share[:, g::G]
            dv += dv_share[:, g::G]

    # dQ per (q tile, query head) over the visible key tiles
    dq = torch.zeros((B, Hq, Sq, D))
    for q0 in range(0, Sq, TILE):
        rows = min(TILE, Sq - q0)
        sl = (slice(None), slice(None), slice(q0, q0 + rows))
        kb, ke = _key_range(q0, rows, Sk, causal, window)
        for k0 in range(kb, ke, TILE):
            nk = min(TILE, Sk - k0)
            kt, vt = kh[:, :, k0:k0 + nk], vh[:, :, k0:k0 + nk]
            ok = _mask(q0, rows, k0, nk, Sq, Sk, causal, window)
            _, ds = _ds_tile(q[sl] @ kt.transpose(-1, -2),
                             do[sl] @ vt.transpose(-1, -2), lse[sl],
                             delta[sl], ok, softcap, scale)
            dq[sl] += ds @ kt
    return dq * scale, dk, dv


def _forward(q, k, v, **kw):
    """K1 v4's mirror: (out, lse), as the forward hands them to K1-bwd."""
    from test_torch_flash_f32 import k1_fwd_mirror
    return k1_fwd_mirror(q, k, v, **kw)


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
    o, lse = _forward(q, k, v, **kw)
    dq, dk, dv = k1_bwd_mirror(q, k, v, o, do, lse, **kw)
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
    out, lse = FA._flash_attention_fwd(q, k, v)
    before = FA.flash_attention_bwd.launches
    got = FA.flash_attention_bwd(q, k, v, out, do, lse)
    want = FA.flash_attention_bwd_ref(q, k, v, do)
    assert FA.flash_attention_bwd.launches == before
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)


def test_lse_is_the_row_logsumexp_and_empty_rows_get_no_gradient():
    """The forward's lse (K1 v4's mirror, and the port's plain lse) equals
    logsumexp over each row's valid logits; a row whose window holds no key
    (causal, Sq > Sk) has lse = +inf and output 0 from the forward, and
    gets no gradient in any pass of K1-bwd."""
    B, hq, hkv, Sq, Sk, D, window = 1, 2, 1, 90, 40, 64, 20
    qn, kn, vn, don = _inputs(11, B, hq, hkv, Sq, Sk, D)
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    o, lse = _forward(q, k, v, causal=True, window=window)
    qpos = torch.arange(Sq)
    empty = qpos - (Sk - 1) >= window                 # no key in the window
    assert empty.any() and torch.isinf(lse[:, :, empty]).all()
    assert (lse[:, :, empty] > 0).all() and (o[:, :, empty] == 0).all()
    plain = FA.flash_attention_lse_ref(q, k, v, causal=True, window=window)
    assert torch.equal(torch.isinf(plain), torch.isinf(lse))
    logits = (q * D ** -0.5) @ k.repeat_interleave(hq // hkv, 1).transpose(-1, -2)
    ok = FA._ref._attn_mask(Sq, Sk, causal=True, window=window)
    want = torch.logsumexp(torch.where(ok, logits, -math.inf), dim=-1)
    for got in (lse, plain):
        torch.testing.assert_close(got[:, :, ~empty], want[:, :, ~empty],
                                   atol=2e-5, rtol=2e-5)
    dq, dk, dv = k1_bwd_mirror(q, k, v, o, do, lse, causal=True,
                               window=window)
    assert (dq[:, :, empty] == 0).all()
    # rows with a key: the gradients are torch's over those rows alone
    keep = ~empty
    qk, dok = q[:, :, keep].clone(), do[:, :, keep].clone()
    wq, wk, wv = FA.flash_attention_bwd_ref(qk, k, v, dok, causal=True,
                                            window=window)
    _close("dq", dq[:, :, keep], wq)
    _close("dk", dk, wk)
    _close("dv", dv, wv)

"""CPU rehearsal of the arithmetic of K5 v2 (the SSD chunked scan as three
passes) against the JAX package.

The Hopper kernel runs only on a card (tests/test_torch_gpu.py). Its
algorithm is modelled here in torch on the CPU, pass by pass, so that it is
held against the reference before any card sees it:

1. every chunk's local state (x * w)^T @ B, w_j = exp(cum_L - cum_j) dt_j,
   and its total decay cum_L, with cum summed in float64;
2. the scan over chunks, S_c = exp(total_c) S_{c-1} + local_c, which leaves
   each chunk the state entering it and gives the final state;
3. every chunk's outputs, y = att @ x + exp(cum_i) (C @ S_in^T) with
   att = (C @ B^T) * exp(cum_i - cum_j) * dt_j for j <= i.

Three operands of the bf16 kernel's products are computed values: x * w
(the chunk-state product), att (att @ x) and S_in (C @ S_in^T). The kernel
carries each as a pair of bf16 values, hi = bf16(v) and lo = bf16(v - hi),
and writes y in bf16. The mirror runs with and without those roundings, on
inputs that bf16 holds exactly, and is held against
``repro.kernels.ref.ssd_scan`` (sequential) and the Pallas ``ssd_scan`` in
interpret mode, on y and the final state: float32 at 2e-5 without the
roundings, 5e-2 with them (the tolerances of tests/test_kernels.py). One
bf16 rounding of each operand in place of the pair (``single``) is
modelled for comparison: it moves y and the state further from the
reference, which is why the kernel carries pairs.

This mirror is a model of the kernel's algorithm and lives here, not in the
package.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro.kernels.ssm_scan import ssd_scan as pallas_ssd

F32_TOL = 2e-5
BF16_TOL = 5e-2


def _bf16(t):
    return t.bfloat16().float()


def _hi_lo(t):
    """v as the bf16 kernel carries it: bf16(v) + bf16(v - bf16(v))."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def ssd_passes(x, dt, A, Bm, Cm, *, chunk, rounded, single=False):
    """K5 v2's arithmetic. x (B, H, S, P), Bm and Cm (B, S, N), dt (B, H, S)
    and A (H,), all float32. ``rounded``: the bf16 kernel's roundings (x * w,
    att and S_in as hi + lo pairs, y in bf16); with ``single``, one bf16
    rounding of each of the three instead. Returns (y, final state, the
    states entering each chunk (B, H, chunks, P, N))."""
    out = _bf16 if rounded else (lambda t: t)
    bf = _bf16 if single else _hi_lo
    if not rounded:
        bf = out
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    L = chunk
    nc = -(-S // L)
    pad = nc * L - S
    xc = F.pad(x, (0, 0, 0, pad)).reshape(B, H, nc, L, P)
    dtc = F.pad(dt, (0, pad)).reshape(B, H, nc, L)
    Bc = F.pad(Bm, (0, 0, 0, pad)).reshape(B, nc, L, N)
    Cc = F.pad(Cm, (0, 0, 0, pad)).reshape(B, nc, L, N)

    # pass 1: cum in float64 (float32 products), w, the local states
    cum = torch.cumsum((dtc * A[None, :, None, None]).double(), dim=-1)
    total = cum[..., -1]
    w = torch.exp((total[..., None] - cum).float()) * dtc
    local = torch.einsum("bhclp,bcln->bhcpn", bf(xc * w[..., None]), Bc)
    totals = total.float()

    # pass 2: the scan; each chunk keeps the state entering it
    s = torch.zeros(B, H, P, N)
    incoming = []
    for c in range(nc):
        incoming.append(s)
        s = s * torch.exp(totals[:, :, c])[..., None, None] + local[:, :, c]
    s_in = torch.stack(incoming, dim=2)

    # pass 3: att from C @ B^T, masked before exp, then the outputs
    ii = torch.arange(L)
    causal = ii[:, None] >= ii[None, :]
    seg = torch.where(causal, cum[..., :, None] - cum[..., None, :],
                      0.0).float()
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    att = torch.where(causal, cb[:, None] * torch.exp(seg) * dtc[..., None, :],
                      0.0)
    y = torch.einsum("bhcij,bhcjp->bhcip", bf(att), xc) \
        + torch.exp(cum.float())[..., None] \
        * torch.einsum("bcin,bhcpn->bhcip", Cc, bf(s_in))
    y = y.reshape(B, H, nc * L, P)[:, :, :S]
    return out(y), s, s_in


@functools.lru_cache(maxsize=None)
def _case(chunk, P, N):
    """Inputs that bf16 holds exactly (x, B, C; dt and A float32), B = 2,
    H = 2 and a ragged S of three chunks, and the JAX package's answers:
    the sequential oracle and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(100 + chunk + P + N)
    B, H, S = 2, 2, 2 * chunk + chunk // 3 + 1
    to_bf16 = lambda a: torch.from_numpy(a).bfloat16().float().numpy()
    x = to_bf16(rng.normal(size=(B, H, S, P)).astype(np.float32))
    dt = rng.uniform(0.001, 0.2, size=(B, H, S)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, size=(H,)).astype(np.float32)
    Bm = to_bf16(rng.normal(size=(B, S, N)).astype(np.float32))
    Cm = to_bf16(rng.normal(size=(B, S, N)).astype(np.float32))
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    wants = [jref.ssd_scan(*j), pallas_ssd(*j, chunk=chunk, interpret=True)]
    wants = [(np.asarray(y), np.asarray(fs)) for y, fs in wants]
    return [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)], wants


@pytest.mark.parametrize("rounded", [False, True])
@pytest.mark.parametrize("P,N", [(32, 32), (64, 64), (64, 128)])
@pytest.mark.parametrize("chunk", [32, 128])
def test_ssd_passes_mirror_matches_jax_and_pallas(chunk, P, N, rounded):
    inputs, wants = _case(chunk, P, N)
    y, fs, s_in = ssd_passes(*inputs, chunk=chunk, rounded=rounded)
    assert y.shape == inputs[0].shape and fs.shape == (2, 2, P, N)
    assert torch.count_nonzero(s_in[:, :, 0]) == 0     # S_in of chunk 0
    tol = BF16_TOL if rounded else F32_TOL
    for want_y, want_fs in wants:
        np.testing.assert_allclose(y.numpy(), want_y, atol=tol, rtol=tol)
        np.testing.assert_allclose(fs.numpy(), want_fs, atol=tol, rtol=tol)


def test_ssd_passes_roundings_are_what_separates_the_paths():
    """The rounded mirrors differ from the unrounded one (the roundings are
    live at this shape), within the bf16 tolerance; the hi + lo pairs leave
    the final state within 1e-4 (its only bf16 roundings are the lo halves)
    and y within its own bf16 rounding, where one rounding of each operand
    moves both further."""
    inputs, _ = _case(128, 64, 128)
    y0, fs0, _ = ssd_passes(*inputs, chunk=128, rounded=False)
    y1, fs1, _ = ssd_passes(*inputs, chunk=128, rounded=True)
    y2, fs2, _ = ssd_passes(*inputs, chunk=128, rounded=True, single=True)
    for a, b in ((y1, y0), (fs1, fs0), (y2, y0), (fs2, fs0)):
        assert not torch.equal(a, b)
        torch.testing.assert_close(a, b, atol=BF16_TOL, rtol=BF16_TOL)
    torch.testing.assert_close(fs1, fs0, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(y1, y0, atol=1e-4, rtol=2 ** -7)
    assert (fs2 - fs0).abs().max() > 10 * (fs1 - fs0).abs().max()
    assert (y2 - y0).abs().max() > (y1 - y0).abs().max()

"""CPU rehearsal of K5-bwd's arithmetic against the JAX package.

K5-bwd (``csrc/ssm_scan_bwd.cu``, v2) runs only on a card
(tests/test_torch_gpu.py). Its algorithm is modelled here in torch on the
CPU, chunk for chunk and slab for slab, and held against two independent
gradients of the same scan: ``torch.autograd`` of the port's plain chunked
version (``ssd_scan_bwd_ref``) and ``jax.grad`` of the JAX package's
sequential oracle ``repro.kernels.ref.ssd_scan`` (its Pallas K5 has no
gradient, so its plain functions are the target), and of its chunked form
``ref.ssd_scan_chunked`` at chunk 32. What the mirror copies from the
kernel, per (lane, head, chunk) of L steps, with cum = cumsum(dt·A) in
float64, E_ij = exp(cum_i − cum_j) for j ≤ i (never above the diagonal),
T = cum_{L−1} and w_j = exp(T − cum_j)·dt_j:

* from K5's workspace, S_in (the state entering each chunk) and each
  chunk's total decay, as K5's passes 1 and 2 leave them;
* pass A writes each chunk's Σ_i exp(cum_i)·dy_i C_iᵀ (P × N);
* pass B scans the chunks in reverse: G_last = dfinal (0 without one),
  G_{c−1} = exp(T_c)·G_c + local_c, each chunk left holding the gradient G
  of the state leaving it;
* pass C1, per key slab of R = min(L, 64) keys j over tiles of rows i ≥ j:
  with u_ji = (dy_i·x_j) E_ij and v_ji = (C_i·B_j) E_ij, dx_j =
  dt_j Σ_i v_ji dy_i + w_j G B_j, the per-head dB_j = dt_j Σ_i u_ji C_i +
  Gᵀ (w_j x_j), r_j = x_jᵀ G B_j, the direct d(dt)_j = B_j·Σ_i u_ji C_i +
  exp(T − cum_j)·r_j (its first term is Σ_i (dy_i·x_j)(C_i·B_j) E_ij), and
  the column sums of M_ij = (dy_i·x_j)(C_i·B_j) E_ij dt_j as dt_j times it;
* pass C2, per row slab of R rows i over tiles of keys j ≤ i, with D_ij =
  (dy_i·x_j) E_ij dt_j: the per-head dC_i = Σ_j D_ij B_j + exp(cum_i)
  S_inᵀ dy_i, and the row sums of M as C_i·Σ_j D_ij B_j, plus
  exp(cum_i)·dy_i·(S_in C_i);
* pass C3: d(cum) = row sums − column sums + exp(cum)·dy·(S_in C) − w·r,
  with dT = exp(T)⟨G, S_in⟩ + Σ_j w_j r_j at position L − 1, reverse-summed
  in float64 into dg; d(dt) += dg·A_h, and a per-(lane, chunk) dA partial
  Σ_j dg_j dt_j;
* the last pass sums dB and dC over the heads and dA over lanes and chunks,
  in a fixed order.

Rows past S load as zeros with dt = 0 and their gradients are never kept.
The mirror keeps the kernels' order of sums: dt_j scales C1's sums over
i once the walk is done, w_j scales x_j before Gᵀ·x_j, M's row and column
sums come from the dC and dB sums (so no two score tiles are live at once
and C2 forms no C·Bᵀ), and each sum over rows or keys runs in order within
a tile and tile after tile. The layout test below holds v2's threads and
shared memory.
Tolerance: float32 2e-5·max(1, ‖ref‖∞), as on the card. This mirror lives
here, not in the package.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro_torch.kernels import ssm_scan as SS

TOL = 2e-5
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def k5_bwd_mirror(x, dt, A, Bm, Cm, dy, dfinal=None, *, chunk):
    """K5-bwd's passes, float32 (cum and the reverse sum of d(cum) in
    float64). x and dy (B, H, S, P), Bm and Cm (B, S, N), dt (B, H, S),
    A (H,), dfinal (B, H, P, N) or None. Returns (dx, ddt, dA, dB, dC)."""
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    L = chunk
    R = min(L, 64)                      # slab rows, and tile rows
    nc = -(-S // L)
    pad = nc * L - S
    xc = F.pad(x, (0, 0, 0, pad)).reshape(B, H, nc, L, P)
    dyc = F.pad(dy, (0, 0, 0, pad)).reshape(B, H, nc, L, P)
    dtc = F.pad(dt, (0, pad)).reshape(B, H, nc, L)
    Bc = F.pad(Bm, (0, 0, 0, pad)).reshape(B, nc, L, N)
    Cc = F.pad(Cm, (0, 0, 0, pad)).reshape(B, nc, L, N)
    cum = torch.cumsum((dtc * A[None, :, None, None]).double(), dim=-1)
    T = cum[..., -1]
    totals = T.float()
    w = torch.exp((T[..., None] - cum).float()) * dtc
    ecum = torch.exp(cum.float())

    # K5's workspace after its passes 1 and 2: S_in of every chunk
    local = torch.einsum("bhclp,bcln->bhcpn", xc * w[..., None], Bc)
    s, s_in = torch.zeros(B, H, P, N), []
    for c in range(nc):
        s_in.append(s)
        s = s * torch.exp(totals[:, :, c])[..., None, None] + local[:, :, c]
    s_in = torch.stack(s_in, dim=2)

    # pass A: each chunk's Σ_i exp(cum_i) dy_i C_iᵀ
    dlocal = torch.einsum("bhclp,bcln->bhcpn", dyc * ecum[..., None], Cc)
    # pass B: the reverse scan; each chunk keeps the gradient of the state
    # leaving it
    g = torch.zeros(B, H, P, N) if dfinal is None else dfinal.float()
    G = [None] * nc
    for c in reversed(range(nc)):
        G[c] = g
        g = g * torch.exp(totals[:, :, c])[..., None, None] + dlocal[:, :, c]
    G = torch.stack(G, dim=2)

    def decay(c, i0, ni, j0, nj):
        """E (B, H, ni, nj) for rows i0.., keys j0.., 0 where j > i."""
        i = torch.arange(i0, i0 + ni)[:, None]
        j = torch.arange(j0, j0 + nj)[None, :]
        seg = cum[:, :, c, i0:i0 + ni, None] - cum[:, :, c, None, j0:j0 + nj]
        return torch.where(j <= i, torch.exp(torch.where(
            j <= i, seg, 0.0).float()), 0.0)

    dxc = torch.zeros(B, H, nc, L, P)
    dBp = torch.zeros(B, H, nc, L, N)
    dCp = torch.zeros(B, H, nc, L, N)
    colpart = torch.zeros(B, H, nc, L)
    rowpart = torch.zeros(B, H, nc, L)
    wr = torch.zeros(B, H, nc, L)
    ddt_direct = torch.zeros(B, H, nc, L)
    for c in range(nc):
        # pass C1: key slabs [j0, j0 + R), row tiles [i0, i0 + R), i0 >= j0
        for j0 in range(0, L, R):
            xs, bs = xc[:, :, c, j0:j0 + R], Bc[:, c, j0:j0 + R]
            dts = dtc[:, :, c, j0:j0 + R]
            acc_dx = torch.zeros(B, H, R, P)   # Σ_i v_ji dy_i
            acc_dB = torch.zeros(B, H, R, N)   # Σ_i u_ji C_i
            for i0 in range(j0, L, R):
                dys, cs = dyc[:, :, c, i0:i0 + R], Cc[:, c, i0:i0 + R]
                E = decay(c, i0, R, j0, R).transpose(-1, -2)   # (j, i)
                u = torch.einsum("bhjp,bhip->bhji", xs, dys) * E
                acc_dB += u @ cs[:, None]
                v = torch.einsum("bjn,bin->bji", bs, cs)[:, None] * E
                acc_dx += v @ dys
            # the direct term Σ_i (dy_i·x_j)(C_i·B_j) E_ij, through dB's sum
            direct = (bs[:, None] * acc_dB).sum(-1)
            gc = G[:, :, c]
            gb = torch.einsum("bjn,bhpn->bhjp", bs, gc)
            r = (xs * gb).sum(-1)
            wj = w[:, :, c, j0:j0 + R]
            acc_dx = dts[..., None] * acc_dx + wj[..., None] * gb
            acc_dB = dts[..., None] * acc_dB + (wj[..., None] * xs) @ gc
            dxc[:, :, c, j0:j0 + R] = acc_dx
            dBp[:, :, c, j0:j0 + R] = acc_dB
            # the column sums of M: dt_j times the direct term
            colpart[:, :, c, j0:j0 + R] = -dts * direct - wj * r
            wr[:, :, c, j0:j0 + R] = wj * r
            ddt_direct[:, :, c, j0:j0 + R] = direct + torch.exp(
                (T[:, :, c, None] - cum[:, :, c, j0:j0 + R]).float()) * r
        # pass C2: row slabs [i0, i0 + R), key tiles [j0, j0 + R), j0 <= i0
        for i0 in range(0, L, R):
            dys, cs = dyc[:, :, c, i0:i0 + R], Cc[:, c, i0:i0 + R]
            acc_dC = torch.zeros(B, H, R, N)
            for j0 in range(0, i0 + R, R):
                xs, bs = xc[:, :, c, j0:j0 + R], Bc[:, c, j0:j0 + R]
                E = decay(c, i0, R, j0, R)                     # (i, j)
                dyx = torch.einsum("bhip,bhjp->bhij", dys, xs)
                D = dyx * E * dtc[:, :, c, None, j0:j0 + R]
                acc_dC += D @ bs[:, None]
            # M's row sum Σ_j D_ij (C_i·B_j) = C_i · Σ_j D_ij B_j
            row_m = (cs[:, None] * acc_dC).sum(-1)
            ein = torch.zeros(B, H, R)
            if c > 0:
                sin = s_in[:, :, c]
                sc = torch.einsum("bin,bhpn->bhip", cs, sin)
                e = ecum[:, :, c, i0:i0 + R]
                ein = e * (dys * sc).sum(-1)
                acc_dC += e[..., None] * (dys @ sin)
            dCp[:, :, c, i0:i0 + R] = acc_dC
            rowpart[:, :, c, i0:i0 + R] = row_m + ein

    # pass C3: d(cum), its reverse sum dg in float64 from dT, d(dt), dA
    valid = (torch.arange(nc * L) < S).reshape(nc, L)
    dcum = torch.where(valid, rowpart + colpart, 0.0).double()
    dT = torch.exp(totals) * (G * s_in).sum((-1, -2)) \
        + torch.where(valid, wr, 0.0).double().sum(-1)
    dg = (dcum.flip(-1).cumsum(-1).flip(-1) + dT[..., None]).float()
    ddt = ddt_direct + dg * A[None, :, None, None]
    dA_part = torch.where(valid, dg * dtc, 0.0).double().sum(-1).float()

    # the last pass: sums over heads, and over lanes and chunks
    def cut(t):
        return t.reshape(B, H, nc * L, *t.shape[4:])[:, :, :S]
    return (cut(dxc), cut(ddt), dA_part.sum((0, 2)), cut(dBp).sum(1),
            cut(dCp).sum(1))


@functools.lru_cache(maxsize=None)
def _case(chunk, P, N, S, with_final):
    """Seeded float32 inputs (B = 2, H = 3), dy and dfinal, and jax.grad of
    the JAX package's sequential scan (and of its chunked form at chunk
    32) on them."""
    rng = np.random.default_rng(1000 * chunk + 10 * P + N + S)
    B, H = 2, 3
    x = rng.normal(size=(B, H, S, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.2, size=(B, H, S)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, size=(H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    dy = rng.normal(size=(B, H, S, P)).astype(np.float32)
    dfinal = rng.normal(size=(B, H, P, N)).astype(np.float32) \
        if with_final else None
    wants = {"sequential": _jax_grads(jref.ssd_scan, (x, dt, A, Bm, Cm), dy,
                                      dfinal)}
    if chunk == 32:
        wants["chunked"] = _jax_grads(functools.partial(
            jref.ssd_scan_chunked, chunk=chunk), (x, dt, A, Bm, Cm), dy,
            dfinal)
    ins = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm, dy)]
    return ins, None if dfinal is None else torch.from_numpy(dfinal), wants


def _jax_grads(fn, inputs, dy, dfinal):
    def loss(*args):
        y, fs = fn(*args)
        out = jnp.sum(y * dy)
        return out if dfinal is None else out + jnp.sum(fs * dfinal)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in inputs))
    return [np.asarray(g) for g in grads]


def _close(label, got, want):
    want = np.asarray(want, dtype=np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, f"{label}: {got.shape} vs {want.shape}"
    lim = TOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{label}: max err {err:.3e} > {lim:.3e}"


# (P, N, chunk, S): the reduced configs' P = N = 32 at chunk 32, zamba2's N
# 64 and mamba2's N 128 at chunk 128, and both chunks at the other (P, N);
# each S ragged (not a multiple of the chunk) and one multiple of it
CASES = [(32, 32, 32, 77), (32, 32, 32, 64), (64, 128, 32, 45),
         (64, 64, 128, 300), (64, 128, 128, 256), (32, 64, 128, 150)]


@pytest.mark.parametrize("with_final", [False, True])
@pytest.mark.parametrize("P,N,chunk,S", CASES)
def test_mirror_matches_torch_autograd_and_jax_grad(P, N, chunk, S,
                                                    with_final):
    ins, dfinal, wants = _case(chunk, P, N, S, with_final)
    got = k5_bwd_mirror(*ins, dfinal, chunk=chunk)
    # the port's plain version: torch.autograd of ref.ssd_scan_chunked
    for name, g, w in zip(NAMES, got, SS.ssd_scan_bwd_ref(
            *ins, dfinal, chunk=chunk)):
        _close(f"{name} vs torch", g, w)
    # the reference: jax.grad of repro.kernels.ref's scans
    for which, jg in wants.items():
        for name, g, w in zip(NAMES, got, jg):
            _close(f"{name} vs jax {which}", g, w)


def test_jax_chunked_form_at_chunk_128_is_within_the_float32_gate():
    """JAX's chunked form sums cum in float32 (the port's in float64). At
    chunk 128 its gradients still sit within 2e-5·max(1, ‖ref‖∞) of the
    mirror here (B 2, H 3, S 300, P 64, N 64, with a final-state
    gradient)."""
    ins, dfinal, _ = _case(128, 64, 64, 300, True)
    got = k5_bwd_mirror(*ins, dfinal, chunk=128)
    jg = _jax_grads(functools.partial(jref.ssd_scan_chunked, chunk=128),
                    [t.numpy() for t in ins[:5]], ins[5].numpy(),
                    dfinal.numpy())
    for name, g, w in zip(NAMES, got, jg):
        _close(f"{name} vs jax chunked (chunk 128)", g, w)


@pytest.mark.parametrize("with_final", [False, True])
def test_function_on_the_host_is_the_plain_autograd(with_final):
    """``SSDScan`` on CPU tensors: its forward is the plain version and its
    backward (``ssd_scan_bwd``'s plain path) gives the gradients of
    autograd through ``ssd_scan_ref``, bit for bit; no kernel counts
    move."""
    ins, dfinal, _ = _case(32, 32, 32, 77, with_final)
    leaves = [t.clone().requires_grad_(True) for t in ins[:5]]
    before = (SS.ssd_scan.launches, SS.ssd_scan_bwd.launches)
    y, fs = SS.ssd_scan_grad(*leaves, chunk=32)
    outs, seeds = [y], [ins[5]]
    if with_final:
        outs.append(fs)
        seeds.append(dfinal)
    got = torch.autograd.grad(outs, leaves, seeds)
    plain = [t.clone().requires_grad_(True) for t in ins[:5]]
    py, pfs = SS.ssd_scan_ref(*plain, chunk=32)
    assert torch.equal(y, py) and torch.equal(fs, pfs)
    pouts = [py, pfs] if with_final else [py]
    want = torch.autograd.grad(pouts, plain, seeds)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert (SS.ssd_scan.launches, SS.ssd_scan_bwd.launches) == before


def test_wrapper_on_the_host_is_the_plain_version():
    """On CPU tensors the K5-bwd wrapper returns its plain version in each
    input's dtype and counts no launch."""
    ins, _, _ = _case(32, 32, 32, 64, False)
    x, dt, A, Bm, Cm, dy = ins
    x, Bm, Cm, dy = (t.bfloat16() for t in (x, Bm, Cm, dy))
    before = SS.ssd_scan_bwd.launches
    got = SS.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=32)
    want = SS.ssd_scan_bwd_ref(x, dt, A, Bm, Cm, dy, chunk=32)
    assert SS.ssd_scan_bwd.launches == before
    for g, w, t in zip(got, want, (x, dt, A, Bm, Cm)):
        assert g.dtype == t.dtype and torch.equal(g, w)


def test_shared_memory_and_tiles_follow_v2():
    """K5-bwd v2's slab kernels (C1 keys, C2 rows) run 2R threads, 8 slab
    rows a thread, and every instantiation fits two blocks to an SM; its
    dY·Cᵀ pass is K5 v3's chunk-state layout. At mamba2-130m's shape (P 64,
    N 128, chunk 128) C1 and C2 hold 115,712 bytes, two blocks to the byte
    (228 KB less 1 KB a block): the two walked tiles are swizzled because,
    padded by 4 floats a row as K1's tiles are, one block would fit."""
    for P in SS.HEAD_DIMS:
        for N in SS.STATE_DIMS:
            for L in SS.CHUNKS:
                lay = SS.layouts(P, N, L)
                assert lay["ssd_bwd_keys_kernel"] == lay["ssd_bwd_rows_kernel"]
                assert lay["ssd_bwd_dstate_kernel"] == \
                    lay["ssd_chunk_state_f32"]
                threads, nbytes = lay["ssd_bwd_keys_kernel"]
                assert threads == 2 * SS.slab_rows(L)
                assert SS.blocks_per_sm(nbytes) >= 2, (P, N, L)
    nbytes = SS.layouts(64, 128, 128)["ssd_bwd_keys_kernel"][1]
    assert nbytes == 115712
    assert 2 * (nbytes + SS.BLOCK_RESERVED_BYTES) == SS.SM_SMEM_BYTES
    assert SS.blocks_per_sm(nbytes + 4 * 4 * 64 * 2) == 1

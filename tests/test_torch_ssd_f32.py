"""CPU rehearsal of K5's float32 kernels (v3) against the JAX package.

K5 v3 (``csrc/ssm_scan.cu``, namespace ``f32``) runs only on a card
(tests/test_torch_gpu.py). Its tile walk is modelled here in torch on the
CPU and held against ``repro.kernels.ref.ssd_scan`` (the sequential oracle)
and the Pallas ``repro.kernels.ssm_scan.ssd_scan`` in interpret mode, on y
and the final state. What the mirror copies from the kernels, per (lane,
head, chunk of L steps):

* cum = cumsum(dt·A) in float64 from float32 products, the same code in
  every pass; rows past S are zeros with dt = 0;
* pass 1 (``ssd_chunk_state_f32``, the outer sum of ssm_common.cuh):
  w_j = exp(float(cum_L − cum_j))·dt_j, x_j·w_j rounded to float32, and the
  local state Σ_{j < valid} (x_j w_j)ᵀ B_j;
* pass 2, the scan over chunks, v2's: each chunk keeps the state S_in
  entering it, chunk 0's is 0;
* pass 3 (``ssd_output_f32``): one block per slab of R = min(L, 64) rows,
  the last (heaviest) slab of a chunk first, a slab wholly past S skipped;
  the key tiles of R keys 0 .. slab, each s = C_slab·B_tileᵀ, att =
  s·exp(float(cum_i − cum_j))·dt_j for j ≤ i and 0 above the diagonal
  (never reaching exp), y += att·x_tile; then, for a chunk after the first,
  q = C_slab·S_inᵀ in accumulators of its own and y += exp(float(cum_i))·q;
  rows past S are never stored.

Tolerance: float32 atol = rtol = 2e-5, tests/test_kernels.py's and the
card's.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro.kernels.ssm_scan import ssd_scan as pallas_ssd
from repro_torch.kernels import ssm_scan as SS

TOL = 2e-5
BLOCK_SMEM_LIMIT = 232448     # dynamic shared memory one block may have


def v3_slab_order(L):
    """Row slabs of a chunk in grid order: the last, which walks the most
    key tiles, first."""
    R = SS.slab_rows(L)
    return [L // R - 1 - x for x in range(L // R)]


def v3_key_tiles(slab, L):
    """First keys of the tiles slab ``slab`` walks: every tile up to its
    diagonal."""
    R = SS.slab_rows(L)
    return [t * R for t in range(slab + 1)]


def v3_mirror(x, dt, A, Bm, Cm, *, chunk):
    """K5 v3's float32 arithmetic. x (B, H, S, P), dt (B, H, S), A (H,),
    Bm and Cm (B, S, N). Returns (y, final state, the state entering each
    chunk (B, H, chunks, P, N))."""
    B, H, S, P = x.shape
    N = Bm.shape[-1]
    L, R = chunk, SS.slab_rows(chunk)
    nc = -(-S // L)
    pad = nc * L - S
    xc = F.pad(x, (0, 0, 0, pad)).reshape(B, H, nc, L, P)
    dtc = F.pad(dt, (0, pad)).reshape(B, H, nc, L)
    Bc = F.pad(Bm, (0, 0, 0, pad)).reshape(B, nc, L, N)
    Cc = F.pad(Cm, (0, 0, 0, pad)).reshape(B, nc, L, N)
    cum = torch.cumsum((dtc * A[None, :, None, None]).double(), dim=-1)

    # pass 1: the outer sum of x·w and B over the chunk's keys
    total = cum[..., -1]
    w = torch.exp((total[..., None] - cum).float()) * dtc
    local = torch.einsum("bhclp,bcln->bhcpn", xc * w[..., None], Bc)
    # pass 2: the scan
    s, s_in = torch.zeros(B, H, P, N), []
    for c in range(nc):
        s_in.append(s)
        s = s * torch.exp(total[:, :, c].float())[..., None, None] \
            + local[:, :, c]
    s_in = torch.stack(s_in, dim=2)

    # pass 3: slabs, key tiles, the state term
    y = torch.zeros(B, H, nc * L, P)
    for c in range(nc):
        valid = min(L, S - c * L)
        for slab in v3_slab_order(L):
            r0 = slab * R
            if r0 >= valid:
                continue
            rows = torch.arange(r0, r0 + R)
            cs = Cc[:, c, r0:r0 + R]
            acc = torch.zeros(B, H, R, P)
            for k0 in v3_key_tiles(slab, L):
                keys = torch.arange(k0, k0 + R)
                sc = torch.einsum("bin,bjn->bij", cs, Bc[:, c, k0:k0 + R])
                causal = keys[None, :] <= rows[:, None]
                seg = torch.where(causal, cum[:, :, c, r0:r0 + R, None]
                                  - cum[:, :, c, None, k0:k0 + R], 0.0)
                att = torch.where(causal, sc[:, None] * torch.exp(seg.float())
                                  * dtc[:, :, c, None, k0:k0 + R], 0.0)
                acc = acc + att @ xc[:, :, c, k0:k0 + R]
            if c > 0:
                q = torch.einsum("bin,bhpn->bhip", cs, s_in[:, :, c])
                acc = acc + torch.exp(
                    cum[:, :, c, r0:r0 + R].float())[..., None] * q
            n = min(R, valid - r0)
            y[:, :, c * L + r0:c * L + r0 + n] = acc[:, :, :n]
    return y[:, :, :S], s, s_in


@functools.lru_cache(maxsize=None)
def _case(P, N, chunk, S):
    """Seeded float32 inputs (B = 2, H = 2) and the JAX package's answers:
    the sequential oracle and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(7 * P + 3 * N + chunk + S)
    B, H = 2, 2
    x = rng.normal(size=(B, H, S, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.2, size=(B, H, S)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, size=(H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    wants = {"sequential": jref.ssd_scan(*j),
             "pallas": pallas_ssd(*j, chunk=chunk, interpret=True)}
    wants = {k: (np.asarray(y), np.asarray(fs)) for k, (y, fs) in
             wants.items()}
    return [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)], wants


def _check(P, N, chunk, S):
    inputs, wants = _case(P, N, chunk, S)
    y, fs, s_in = v3_mirror(*inputs, chunk=chunk)
    assert y.shape == inputs[0].shape and fs.shape == (2, 2, P, N)
    assert torch.count_nonzero(s_in[:, :, 0]) == 0   # chunk 0: no state term
    for which, (want_y, want_fs) in wants.items():
        for name, got, want in (("y", y, want_y), ("final state", fs,
                                                   want_fs)):
            np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL,
                                       err_msg=f"{name} vs {which}")
    # the kernel's own plain version, the chunked form, agrees too
    want_y, want_fs = SS.ssd_scan_ref(*inputs, chunk=chunk)
    torch.testing.assert_close(y, want_y, atol=TOL, rtol=TOL)
    torch.testing.assert_close(fs, want_fs, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("P", SS.HEAD_DIMS)
@pytest.mark.parametrize("N", SS.STATE_DIMS)
@pytest.mark.parametrize("chunk", SS.CHUNKS)
def test_v3_mirror_every_instantiation(P, N, chunk):
    """Every (P, N, L) the kernels are built for, three chunks with a
    ragged last one (its second slab, at L = 128, wholly past S)."""
    _check(P, N, chunk, 2 * chunk + chunk // 3 + 1)


@pytest.mark.parametrize("P,N,chunk", [(64, 128, 128), (64, 64, 128),
                                       (32, 32, 32)])
@pytest.mark.parametrize("part", ["short", "one", "slab"])
def test_v3_mirror_edges(P, N, chunk, part):
    """S < chunk (chunk 0 alone, ragged), exactly one chunk (no state term
    anywhere) and a last chunk whose final slab starts one row before S."""
    S = {"short": chunk // 3 + 5, "one": chunk,
         "slab": chunk + chunk - SS.slab_rows(chunk) + 1}[part]
    _check(P, N, chunk, S)


def test_v3_walks_every_causal_tile_once_heaviest_first():
    """At L = 128 a chunk's two slabs walk one and two key tiles, slab 1
    first; at L = 32 one slab walks one tile: every (row, key) pair with
    key <= row lies in exactly one walked tile."""
    for L in SS.CHUNKS:
        R = SS.slab_rows(L)
        order = v3_slab_order(L)
        assert order == sorted(order, reverse=True)
        seen = np.zeros((L, L), int)
        for slab in order:
            for k0 in v3_key_tiles(slab, L):
                seen[slab * R:(slab + 1) * R, k0:k0 + R] += 1
        assert (seen[np.tril_indices(L)] == 1).all()
        assert seen.max() == 1


def test_shared_memory_and_tiles_follow_v3():
    """The layout table is v3's: 2R threads for the outputs pass (8 rows a
    thread), 2P for the chunk-state pass, and every float32 instantiation
    at two or more blocks an SM; at mamba2-130m's shape the outputs pass
    holds 100,864 bytes (98.5 KB)."""
    for P in SS.HEAD_DIMS:
        for N in SS.STATE_DIMS:
            for L in SS.CHUNKS:
                lay = SS.layouts(P, N, L)
                threads, nbytes = lay["ssd_output_f32"]
                assert threads == 2 * SS.slab_rows(L)
                assert lay["ssd_chunk_state_f32"][0] == P // 8 * 16
                for kern in ("ssd_output_f32", "ssd_chunk_state_f32"):
                    assert lay[kern][1] <= BLOCK_SMEM_LIMIT
                    assert SS.blocks_per_sm(lay[kern][1]) >= 2, (P, N, L,
                                                                  kern)
    lay = SS.layouts(64, 128, 128)
    assert lay["ssd_output_f32"] == (128, 100864)
    assert lay["ssd_chunk_state_f32"] == (128, 100352)
    assert SS.blocks_per_sm(100864) == 2


def test_float32_products_use_no_shuffles():
    """v3 left the bf16 fragments' float32 multiply (``Mma<float>``, which
    fetched each operand a lane lacked by shuffle) behind: the float32
    passes and the micro-tile products they and K5-bwd run on have no
    shuffle; K5-bwd's only shuffles are row sums after its products and
    the float64 scans."""
    from repro_torch.kernels import _build
    fwd = (_build.CSRC_DIR / "ssm_scan.cu").read_text()
    assert "Mma<float>" not in fwd
    f32 = fwd[fwd.index("namespace f32 {"):fwd.index("}  // namespace f32")]
    assert "__shfl" not in f32 and "ssd_output_f32" in f32
    tiles = (_build.CSRC_DIR / "flash_common.cuh").read_text()
    products = tiles[tiles.index("template <bool SW>"):
                     tiles.index("// Max and sum over the 16 threads")]
    assert "__shfl" not in products and "void atb(" in products
    common = (_build.CSRC_DIR / "ssm_common.cuh").read_text()
    assert "__shfl" not in common[common.index("the chunk's outer sum"):]
    bwd = (_build.CSRC_DIR / "ssm_scan_bwd.cu").read_text()
    slabs = bwd[bwd.index("// C1: the key slab"):bwd.index("C3: d(cum)")]
    assert "__shfl" not in slabs and slabs.count("row_sum16(") == 4

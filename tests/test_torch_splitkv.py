"""CPU rehearsal of the arithmetic of K1 v3 and K2 v3 against the JAX package.

The Hopper kernels run only on a card (tests/test_torch_gpu.py). What is new
in their arithmetic is modelled here in torch on the CPU, so that it is held
against the reference before any card sees it:

* K2 v3 splits the KV axis across blocks: each split of ``block_k`` keys
  keeps its own float32 partial (m, l, acc), and a combine pass merges the
  live splits by max-rescale. The mirror below does exactly that, and is
  held against ``repro.kernels.ref.decode_attention`` and the Pallas
  ``decode_attention`` (interpret mode) in float32 at 2e-5, at kv_len on
  either side of a split edge, a window that cuts splits, and G = 1 and 4.
* K3 v2 runs the same split and combine over a paged cache: split s holds
  positions [s·block_k, (s + 1)·block_k) of the lane's logical cache, each
  read from pool block ``block_tables[b, pos // span]`` at row
  ``pos % span``, and the splits are fixed from span · max_blocks. Its
  mirror is held against ``repro.kernels.ref.paged_decode_attention`` and
  the Pallas ``paged_decode_attention`` (interpret mode) in float32 at
  2e-5, at kv_len on either side of a split edge, a window that cuts
  splits, a lane with kv_len 0, span 16 and 32, and G = 1 and 4.
* K4 v2 runs K3 v2's split and combine over int8 pools with one float32
  scale per key row, folded as K4's plain version folds them: the score is
  (q·k8)·ks, then the softcap and the mask, and each split accumulates
  p·vs·v8 while l sums p. Its mirror is held against
  ``repro.kernels.ref.paged_decode_attention_quant_fused`` and the Pallas
  ``paged_decode_attention_int8`` (interpret mode) in float32 at 2e-5, over
  the same grid of cases as K3's, plus a softcap with a lane of kv_len 0.
* K1 v3 computes S = Q·Kᵀ from bf16 values with float32 accumulation, scales
  S (not Q) by D^-0.5 in float32, and rounds P to bf16 before P·V while the
  row sums l use the unrounded P. The mirror below walks key tiles with that
  online softmax and is held against ``repro.kernels.ref.mha_attention`` at
  the bf16 tolerance 2e-2, on rows that have a valid key.

These mirrors are models of the kernels' algorithms and live here, not in
the package.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.decode_attention import \
    paged_decode_attention as pallas_paged
from repro.kernels.decode_attention import \
    paged_decode_attention_int8 as pallas_int8

NEG_INF = -1e30     # the kernels' and the reference's mask value
F32_TOL = 2e-5
BF16_TOL = 2e-2


# ------------------------------------------------------------------ K2 v3
def splitkv_decode(q, k, v, kv_len, *, block_k, window=None, softcap=None):
    """K2 v3's arithmetic: per-split float32 partials, then the combine.

    q (B, Hq, 1, D), caches (B, Hkv, Smax, D), kv_len (B,) int. Returns
    (out (B, Hq, 1, D) float32, partials (B, Hq, splits, D + 2))."""
    return _splitkv(q, lambda pos: (k[:, :, pos], v[:, :, pos]), k.shape[2],
                    kv_len, block_k=block_k, window=window, softcap=softcap)


def paged_splitkv_decode(q, k_pool, v_pool, block_tables, kv_len, *,
                         block_k, window=None, softcap=None):
    """K3 v2's arithmetic: K2 v3's over a paged cache. Pools (num_blocks,
    Hkv, span, D); key position pos of lane b is row pos % span of pool
    block block_tables[b, pos // span]; the splits cover span·max_blocks."""
    span = k_pool.shape[2]
    tables = torch.as_tensor(block_tables).long()

    def rows(pos):
        blk = tables[:, pos // span]                          # (B, n)
        off = pos % span
        return (k_pool[blk, :, off].permute(0, 2, 1, 3),
                v_pool[blk, :, off].permute(0, 2, 1, 3))
    return _splitkv(q, rows, span * tables.shape[1], kv_len,
                    block_k=block_k, window=window, softcap=softcap)


def paged_splitkv_int8_decode(q, k_pool, v_pool, k_scale_pool, v_scale_pool,
                              block_tables, kv_len, *, block_k, window=None,
                              softcap=None):
    """K4 v2's arithmetic: K3 v2's over int8 pools (num_blocks, Hkv, span, D)
    with float32 scale pools (num_blocks, Hkv, span, 1), one scale per key
    row, folded into the score and into p, never into a dequantized row."""
    span = k_pool.shape[2]
    tables = torch.as_tensor(block_tables).long()

    def rows(pos):
        blk = tables[:, pos // span]                          # (B, n)
        off = pos % span
        return tuple(t[blk, :, off].permute(0, 2, 1, 3) for t in
                     (k_pool, v_pool, k_scale_pool, v_scale_pool))
    return _splitkv(q, rows, span * tables.shape[1], kv_len,
                    block_k=block_k, window=window, softcap=softcap)


def _splitkv(q, rows, Smax, kv_len, *, block_k, window, softcap):
    """The split and the combine; rows(pos) gives K and V (B, Hkv, n, D) of
    the key positions pos, and for int8 rows also their scales
    (B, Hkv, n, 1)."""
    B, Hq, _, D = q.shape
    splits = max(1, -(-Smax // block_k))
    qs = q[:, :, 0].float() * D ** -0.5                       # (B, Hq, D)
    kvl = torch.as_tensor(kv_len).long()
    k_end = torch.clamp(kvl, max=Smax)
    k_lo = torch.clamp(kvl - window, min=0) if window else torch.zeros_like(kvl)
    parts = torch.empty(B, Hq, splits, D + 2)
    for s in range(splits):
        s0 = torch.clamp(k_lo, min=s * block_k)
        s1 = torch.clamp(k_end, max=s * block_k + block_k)
        pos = torch.arange(s * block_k, min(Smax, s * block_k + block_k))
        ok = (pos[None, :] >= s0[:, None]) & (pos[None, :] < s1[:, None])
        ok = ok[:, None, :]                                   # (B, 1, n)
        kp, vp, *scales = rows(pos)
        G = Hq // kp.shape[1]
        kf = kp.float().repeat_interleave(G, dim=1)
        vf = vp.float().repeat_interleave(G, dim=1)
        x = torch.einsum("bhd,bhnd->bhn", qs, kf)
        if scales:          # int8 rows: s = (q·k8)·ks
            ksc, vsc = (t[..., 0].repeat_interleave(G, dim=1) for t in scales)
            x = x * ksc
        if softcap is not None:
            x = softcap * torch.tanh(x / softcap)
        x = torch.where(ok, x, torch.full_like(x, NEG_INF))
        m = x.amax(-1)                                        # (B, Hq)
        p = torch.where(ok, torch.exp(x - m[..., None]), torch.zeros_like(x))
        l = p.sum(-1)
        live = (s0 < s1)[:, None].expand(B, Hq)
        pv = p * vsc if scales else p       # int8 rows: p·vs·v8
        parts[:, :, s, :D] = torch.einsum("bhn,bhnd->bhd", pv, vf)
        parts[:, :, s, D] = torch.where(live, m, torch.full_like(m, NEG_INF))
        parts[:, :, s, D + 1] = torch.where(live, l, torch.zeros_like(l))
    m, l = parts[..., D], parts[..., D + 1]
    live = l > 0
    mx = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(-1,
                                                               keepdim=True)
    c = torch.where(live, torch.exp(m - mx), torch.zeros_like(m))
    total = (c * l).sum(-1)
    acc = (c[..., None] * parts[..., :D]).sum(-2)
    out = torch.where(total[..., None] > 0,
                      acc / torch.where(total > 0, total, 1.0)[..., None],
                      torch.zeros_like(acc))
    return out[:, :, None], parts


def _decode_inputs(seed, B, Hq, Hkv, Smax, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, 1, D), (B, Hkv, Smax, D), (B, Hkv, Smax, D))]


@pytest.mark.parametrize("block_k", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window", [None, 71])
def test_splitkv_mirror_matches_jax_and_pallas(block_k, G, window):
    """kv_len 1, block_k - 1, block_k, block_k + 1 and Smax (ragged: Smax is
    not a multiple of block_k); window 71 cuts splits in two."""
    Hkv, D = 2, 64
    Smax = 3 * block_k + 9
    kv_len = np.asarray([1, block_k - 1, block_k, block_k + 1, Smax],
                        np.int32)
    q, k, v = _decode_inputs(20 + G, len(kv_len), G * Hkv, Hkv, Smax, D)
    got, _ = splitkv_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), kv_len, block_k=block_k,
                            window=window)
    kw = {} if window is None else {"window": window}
    want = jref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), kv_len=jnp.asarray(kv_len),
                                 **kw)
    pallas = pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(kv_len), interpret=True, **kw)
    for ref_out in (want, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_out),
                                   atol=F32_TOL, rtol=F32_TOL)


def test_splitkv_mirror_softcap_and_dead_splits():
    """Softcap 20 at D = 128; a lane with kv_len 0 gets 0 (no live split),
    and every split past kv_len or left of the window carries l = 0."""
    B, Hq, Hkv, Smax, D, bk, window = 3, 8, 2, 300, 128, 64, 100
    kv_len = np.asarray([0, 130, 300], np.int32)
    q, k, v = _decode_inputs(31, B, Hq, Hkv, Smax, D)
    got, parts = splitkv_decode(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), kv_len, block_k=bk,
                                window=window, softcap=20.0)
    assert torch.count_nonzero(got[0]) == 0
    live = (parts[..., D + 1] > 0).any(1)                    # (B, splits)
    # lane 1: keys [30, 130) -> splits 0..2; lane 2: [200, 300) -> 3, 4
    assert live.tolist() == [[False] * 5, [True, True, True, False, False],
                             [False, False, False, True, True]]
    want = jref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), kv_len=jnp.asarray(kv_len),
                                 window=window, softcap=20.0)
    np.testing.assert_allclose(got.numpy()[1:], np.asarray(want)[1:],
                               atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------------------------ K3 v2
@functools.lru_cache(maxsize=None)
def _paged_case(span, G, window):
    """Pools, tables and the JAX package's answers (reference and Pallas in
    interpret mode) for lanes of kv_len 0, then either side of every split
    edge of block_k 32, 64 and 128, then the whole table. Each lane's live
    blocks are distinct random pool blocks; dead entries are the null
    block 0."""
    Hkv, D = 2, 64
    kv_len = np.asarray([0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 0],
                        np.int32)
    max_blocks = -(-(2 * 128 + 9) // span)
    kv_len[-1] = span * max_blocks
    B = len(kv_len)
    rng = np.random.default_rng(50 + span + G)
    num_blocks = 1 + int(sum(-(-n // span) for n in kv_len))
    q = rng.normal(size=(B, G * Hkv, 1, D)).astype(np.float32)
    kp, vp = (rng.normal(size=(num_blocks, Hkv, span, D)).astype(np.float32)
              for _ in range(2))
    tables = np.zeros((B, max_blocks), np.int32)
    perm = rng.permutation(num_blocks - 1) + 1
    used = 0
    for b, n in enumerate(kv_len):
        nb = -(-int(n) // span)
        tables[b, :nb] = perm[used:used + nb]
        used += nb
    kw = {} if window is None else {"window": window}
    j = [jnp.asarray(a) for a in (q, kp, vp, tables, kv_len)]
    wants = [jref.paged_decode_attention(*j[:4], kv_len=j[4], **kw),
             pallas_paged(*j, interpret=True, **kw)]
    return (q, kp, vp, tables, kv_len), [np.asarray(w) for w in wants]


@pytest.mark.parametrize("block_k", [32, 64, 128])
@pytest.mark.parametrize("span", [16, 32])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window", [None, 71])
def test_paged_splitkv_mirror_matches_jax_and_pallas(block_k, span, G,
                                                     window):
    (q, kp, vp, tables, kv_len), wants = _paged_case(span, G, window)
    got, parts = paged_splitkv_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        tables, kv_len, block_k=block_k, window=window)
    assert parts.shape[2] == -(-span * tables.shape[1] // block_k)
    dead = kv_len == 0
    assert torch.count_nonzero(got[dead]) == 0
    assert torch.count_nonzero(parts[dead][..., -1]) == 0     # l = 0
    for want in wants:
        np.testing.assert_allclose(got.numpy()[~dead], want[~dead],
                                   atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------------------------ K4 v2
def _tables(rng, kv_len, span, max_blocks, num_blocks):
    """Each lane's live blocks are distinct random pool blocks; dead
    entries are the null block 0."""
    tables = np.zeros((len(kv_len), max_blocks), np.int32)
    perm = rng.permutation(num_blocks - 1) + 1
    used = 0
    for b, n in enumerate(kv_len):
        nb = -(-int(n) // span)
        tables[b, :nb] = perm[used:used + nb]
        used += nb
    return tables


def _int8_case(seed, span, G, kv_len, max_blocks, window=None, softcap=None):
    """int8 pools, float32 scale pools in [0.005, 0.02), tables, and the JAX
    package's answers: the fused int8 read and the Pallas kernel in
    interpret mode."""
    Hkv, D = 2, 64
    rng = np.random.default_rng(seed)
    num_blocks = 1 + int(sum(-(-n // span) for n in kv_len))
    q = rng.normal(size=(len(kv_len), G * Hkv, 1, D)).astype(np.float32)
    shape = (num_blocks, Hkv, span, D)
    kp, vp = (rng.integers(-127, 128, size=shape).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.005, 0.02, size=shape[:3] + (1,))
              .astype(np.float32) for _ in range(2))
    tables = _tables(rng, kv_len, span, max_blocks, num_blocks)
    kw = {k: v for k, v in (("window", window), ("softcap", softcap))
          if v is not None}
    j = [jnp.asarray(a) for a in (q, kp, vp, ks, vs, tables, kv_len)]
    wants = [jref.paged_decode_attention_quant_fused(*j[:6], kv_len=j[6],
                                                     **kw),
             pallas_int8(*j, interpret=True, **kw)]
    return (q, kp, vp, ks, vs, tables, kv_len), [np.asarray(w) for w in wants]


@functools.lru_cache(maxsize=None)
def _paged_int8_case(span, G, window):
    """K3's lanes (kv_len 0, either side of every split edge of block_k 32,
    64 and 128, the whole table) over int8 pools."""
    kv_len = np.asarray([0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 0],
                        np.int32)
    max_blocks = -(-(2 * 128 + 9) // span)
    kv_len[-1] = span * max_blocks
    return _int8_case(70 + span + G, span, G, kv_len, max_blocks, window)


def _check_int8_mirror(inputs, wants, block_k, window=None, softcap=None):
    q, kp, vp, ks, vs, tables, kv_len = inputs
    got, parts = paged_splitkv_int8_decode(
        *(torch.from_numpy(a) for a in (q, kp, vp, ks, vs)), tables, kv_len,
        block_k=block_k, window=window, softcap=softcap)
    assert parts.shape[2] == -(-kp.shape[2] * tables.shape[1] // block_k)
    dead = kv_len == 0
    assert torch.count_nonzero(got[dead]) == 0
    assert torch.count_nonzero(parts[dead][..., -1]) == 0     # l = 0
    for want in wants:
        np.testing.assert_allclose(got.numpy()[~dead], want[~dead],
                                   atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("block_k", [32, 64, 128])
@pytest.mark.parametrize("span", [16, 32])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window", [None, 71])
def test_paged_splitkv_int8_mirror_matches_jax_and_pallas(block_k, span, G,
                                                          window):
    inputs, wants = _paged_int8_case(span, G, window)
    _check_int8_mirror(inputs, wants, block_k, window=window)


def test_paged_splitkv_int8_mirror_softcap_and_dead_lane():
    """Softcap 20 at pool blocks of 8 (the reduced tests' span), G = 4: the
    lane of kv_len 0 is 0 and carries l = 0 in every split."""
    kv_len = np.asarray([0, 45, 96, 130], np.int32)
    inputs, wants = _int8_case(91, 8, 4, kv_len, 18, softcap=20.0)
    _check_int8_mirror(inputs, wants, 64, softcap=20.0)


# ------------------------------------------------------------------ K1 v3
def flash_bf16(q, k, v, *, block_k, causal=True, window=None, softcap=None,
               q_offset=0, sk_valid=None):
    """K1 v3's arithmetic on bf16 inputs: S from the bf16 values with
    float32 accumulation, scaled in float32; softcap, then the masks; online
    softmax over key tiles in float32; P rounded to bf16 before P·V, l from
    the unrounded P; 0 for a row with no valid key. Returns float32."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    sk_valid = Sk if sk_valid is None else sk_valid
    qf = q.float()
    kf = k.float().repeat_interleave(G, dim=1)
    vf = v.float().repeat_interleave(G, dim=1)
    qpos = torch.arange(Sq)[:, None] + q_offset
    m = torch.full((B, Hq, Sq, 1), -float("inf"))
    l = torch.zeros(B, Hq, Sq, 1)
    acc = torch.zeros(B, Hq, Sq, D)
    for k0 in range(0, Sk, block_k):
        kpos = torch.arange(k0, min(Sk, k0 + block_k))[None, :]
        ok = kpos < sk_valid
        if causal:
            ok = ok & (kpos <= qpos)
        if window is not None:
            ok = ok & (qpos - kpos < window)
        x = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, kpos[0]]) * D ** -0.5
        if softcap is not None:
            x = softcap * torch.tanh(x / softcap)
        x = torch.where(ok, x, torch.full_like(x, -float("inf")))
        mx = torch.maximum(m, x.amax(-1, keepdim=True))
        base = torch.where(mx == -float("inf"), torch.zeros_like(mx), mx)
        alpha = torch.exp(m - base)
        p = torch.exp(x - base)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(),
                          vf[:, :, kpos[0]])
        acc = acc * alpha + pv
        m = mx
    return torch.where(l > 0, acc / torch.where(l > 0, l, 1.0),
                       torch.zeros_like(acc))


def _valid_rows(Sq, Sk, q_offset, window, sk_valid):
    """Causal query rows with at least one valid key."""
    qpos = np.arange(Sq) + q_offset
    nearest = np.minimum(qpos, sk_valid - 1)
    ok = nearest >= 0
    if window is not None:
        ok &= (qpos - nearest) < window
    return ok


@pytest.mark.parametrize("case", [
    dict(Sq=37, Sk=37, D=128),
    dict(Sq=300, Sk=300, D=64, Hq=4, Hkv=4),
    dict(Sq=37, Sk=101, D=128, q_offset=64),
    dict(Sq=40, Sk=40, D=64, q_offset=-4),
    dict(Sq=64, Sk=64, D=128, softcap=30.0),
    dict(Sq=200, Sk=200, D=64, window=17),
    dict(Sq=100, Sk=100, D=128, sk_valid=77),
])
@pytest.mark.parametrize("block_k", [32, 128])
def test_flash_bf16_mirror_matches_jax(case, block_k):
    c = dict(case)
    Sq, Sk, D = c.pop("Sq"), c.pop("Sk"), c.pop("D")
    Hq, Hkv = c.pop("Hq", 4), c.pop("Hkv", 2)
    rng = np.random.default_rng(40 + Sq + D)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((1, Hq, Sq, D), (1, Hkv, Sk, D), (1, Hkv, Sk, D))]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrs)
    got = flash_bf16(q, k, v, block_k=block_k, **c)
    sk_valid = c.pop("sk_valid", None)
    kw = dict(causal=True, **c)
    if sk_valid is not None:
        kw["kv_len"] = jnp.asarray([sk_valid], jnp.int32)
    qj, kj, vj = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    want = np.asarray(jref.mha_attention(qj, kj, vj, **kw), np.float32)
    rows = _valid_rows(Sq, Sk, c.get("q_offset", 0), c.get("window"),
                       Sk if sk_valid is None else sk_valid)
    assert rows.any()
    np.testing.assert_allclose(got.numpy()[:, :, rows],
                               want[:, :, rows], atol=BF16_TOL, rtol=BF16_TOL)
    assert torch.count_nonzero(got[:, :, ~rows]) == 0

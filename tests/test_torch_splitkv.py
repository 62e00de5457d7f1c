"""CPU rehearsal of the arithmetic of K1 v3 and K2 v3 against the JAX package.

The Hopper kernels run only on a card (tests/test_torch_gpu.py). What is new
in their arithmetic is modelled here in torch on the CPU, so that it is held
against the reference before any card sees it:

* K2 v4 splits the KV axis into splits of ``block_k`` keys: each live split
  keeps its own float32 partial (m, l, acc), and a combine pass merges a
  lane's live splits by max-rescale. A work item is one (lane, KV head,
  live split); the kernel builds the list of them from kv_len (each lane's
  live split range, an exclusive prefix over the lanes, 128 lanes a list)
  and a fixed grid of P blocks walks it, block i taking items i, i + P, ...
  and finding an item's lane by binary search on the prefix; a lane whose
  live keys fit one warp step (a dead slot's one key) lists its items apart,
  each taken by one warp alone. The mirror below does exactly that
  (``live_splits``, ``walk``): it computes every split's partial as K2 v3
  did, writes only the walked items' into a workspace of NaN, checks that
  each live item is walked once, and combines each lane's live range
  alone. It is held against
  ``repro.kernels.ref.decode_attention`` and the Pallas ``decode_attention``
  (interpret mode) in float32 at 2e-5, at kv_len on either side of a split
  edge, a window that cuts splits, and G = 1 and 4, at P = 1, P = 7 and P
  above the item count, and with lists of 2 lanes.
* K3 v3 runs the same work list and combine over a paged cache: split s
  holds positions [s·block_k, (s + 1)·block_k) of the lane's logical cache,
  each read from pool block ``block_tables[b, pos // span]`` at row
  ``pos % span``, and the workspace's splits are fixed from span ·
  max_blocks. Its mirror is held against
  ``repro.kernels.ref.paged_decode_attention`` and the Pallas
  ``paged_decode_attention`` (interpret mode) in float32 at 2e-5, at kv_len
  0 and 1, on either side of a split edge, a window that cuts splits, every
  lane dead (kv_len 0 and 1), one lane at the whole table among short ones,
  span 16 and 32, G = 1 and 4, and P = 1, 7 and above the item count.
* K4 v3 runs K3 v3's work list and combine over int8 pools with one float32
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
LIST_LANES = 128    # lanes the split kernel lists at a time (a block's threads)
WARPS = 4           # a split block's warps
# the split kernel's grid P, and the lanes a list holds: one block; seven,
# walking items strided; more blocks than items; lists of 2 lanes
GRIDS = [(1, LIST_LANES), (7, LIST_LANES), (None, LIST_LANES), (3, 2)]


# ------------------------------------------------------------------ K2 v4
def live_splits(kv_len, limit, window, block_k):
    """Each lane's live splits and keys (lo, n, keys): the splits [lo, lo +
    n) hold the keys [k_lo, k_end), k_end = min(kv_len, limit), k_lo =
    kv_len - window or 0; n = 0 when no key is live (kv_len 0)."""
    out = []
    for kvl in (int(x) for x in kv_len):
        k_end = min(kvl, limit)
        k_lo = max(0, kvl - window) if window else 0
        lo = k_lo // block_k
        out.append((lo, -(-k_end // block_k) - lo if k_lo < k_end else 0,
                    max(0, k_end - k_lo)))
    return out


def keys_per_step(dtype, D):
    """Keys of one warp step: a lane loads 16 bytes of a float or bf16 row,
    8 values of an int8 one, and 32 lanes cover 32 / (D / values) rows."""
    values = 8 if dtype == torch.int8 else 16 // dtype.itemsize
    return 32 // (D // values)


def _owner(first, it):
    """The last j with first[j] <= it, by the kernel's binary search."""
    j, hi = 0, len(first) - 2
    while j < hi:
        mid = (j + hi + 1) >> 1
        if first[mid] <= it:
            j = mid
        else:
            hi = mid - 1
    return j


def walk(lanes, Hkv, grid, kps, list_lanes=LIST_LANES, NW=WARPS):
    """The items, as (lane, KV head, split), that each of ``grid`` blocks of
    NW warps takes as a block, and that each warp takes alone, each in its
    order. The lanes are listed ``list_lanes`` at a time; a lane whose live
    keys fit one warp step (``kps`` keys) owns one-warp items, any other
    block items, Hkv · n of them (KV head, then split), found through an
    exclusive prefix of each kind, each kind numbered across lists. Block i
    takes block items i, i + grid, ...; warp w of block i one-warp items
    i·NW + w, then every grid·NW-th."""
    def take(start, stride, kind):
        mine, nxt, base = [], start, 0
        for b0 in range(0, len(lanes), list_lanes):
            listed = lanes[b0:b0 + list_lanes]
            first = [0]
            for _, n, keys in listed:
                first.append(first[-1] + (Hkv * n if kind(keys) else 0))
            while nxt - base < first[-1]:
                it = nxt - base
                j = _owner(first, it)
                lo, n, _ = listed[j]
                r = it - first[j]
                mine.append((b0 + j, r // n, lo + r % n))
                nxt += stride
            base += first[-1]
        return mine
    blocks = [take(i, grid, lambda keys: keys > kps) for i in range(grid)]
    warps = [take(i * NW + w, grid * NW, lambda keys: keys <= kps)
             for i in range(grid) for w in range(NW)]
    return blocks, warps


def splitkv_decode(q, k, v, kv_len, *, block_k, window=None, softcap=None,
                   grid=None, list_lanes=LIST_LANES):
    """K2 v4's arithmetic: the live items' float32 partials, then the
    combine.

    q (B, Hq, 1, D), caches (B, Hkv, Smax, D), kv_len (B,) int. Returns
    (out (B, Hq, 1, D) float32, workspace (B, Hq, splits, D + 2), NaN where
    no item wrote)."""
    return _splitkv(q, lambda pos: (k[:, :, pos], v[:, :, pos]), k.shape[1],
                    k.shape[2], keys_per_step(k.dtype, k.shape[3]), kv_len,
                    block_k=block_k, window=window, softcap=softcap,
                    grid=grid, list_lanes=list_lanes)


def paged_splitkv_decode(q, k_pool, v_pool, block_tables, kv_len, *,
                         block_k, window=None, softcap=None, grid=None):
    """K3 v3's arithmetic: K2 v4's over a paged cache. Pools (num_blocks,
    Hkv, span, D); key position pos of lane b is row pos % span of pool
    block block_tables[b, pos // span]; the splits cover span·max_blocks."""
    span = k_pool.shape[2]
    tables = torch.as_tensor(block_tables).long()

    def rows(pos):
        blk = tables[:, pos // span]                          # (B, n)
        off = pos % span
        return (k_pool[blk, :, off].permute(0, 2, 1, 3),
                v_pool[blk, :, off].permute(0, 2, 1, 3))
    return _splitkv(q, rows, k_pool.shape[1], span * tables.shape[1],
                    keys_per_step(k_pool.dtype, k_pool.shape[3]), kv_len,
                    block_k=block_k, window=window, softcap=softcap,
                    grid=grid)


def paged_splitkv_int8_decode(q, k_pool, v_pool, k_scale_pool, v_scale_pool,
                              block_tables, kv_len, *, block_k, window=None,
                              softcap=None, grid=None):
    """K4 v3's arithmetic: K3 v3's over int8 pools (num_blocks, Hkv, span, D)
    with float32 scale pools (num_blocks, Hkv, span, 1), one scale per key
    row, folded into the score and into p, never into a dequantized row."""
    span = k_pool.shape[2]
    tables = torch.as_tensor(block_tables).long()

    def rows(pos):
        blk = tables[:, pos // span]                          # (B, n)
        off = pos % span
        return tuple(t[blk, :, off].permute(0, 2, 1, 3) for t in
                     (k_pool, v_pool, k_scale_pool, v_scale_pool))
    return _splitkv(q, rows, k_pool.shape[1], span * tables.shape[1],
                    keys_per_step(k_pool.dtype, k_pool.shape[3]), kv_len,
                    block_k=block_k, window=window, softcap=softcap,
                    grid=grid)


def _split_partials(q, rows, Smax, kv_len, *, block_k, window, softcap):
    """Every split's float32 partial (B, Hq, splits, D + 2), a dead split's
    with l = 0: the body of one work item, computed for all at once.
    rows(pos) gives K and V (B, Hkv, n, D) of the key positions pos, and for
    int8 rows also their scales (B, Hkv, n, 1)."""
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
    return parts


def _splitkv(q, rows, Hkv, Smax, kps, kv_len, *, block_k, window, softcap,
             grid, list_lanes=LIST_LANES):
    """The work list, its walk by ``grid`` blocks (None: one block per item
    the shapes allow, more than there are), and the combine; ``kps`` keys
    make one warp step."""
    B, Hq, _, D = q.shape
    G = Hq // Hkv
    parts = _split_partials(q, rows, Smax, kv_len, block_k=block_k,
                            window=window, softcap=softcap)
    ranges = live_splits(kv_len, Smax, window, block_k)
    items = [(b, hk, lo + i) for b, (lo, n, _) in enumerate(ranges)
             for hk in range(Hkv) for i in range(n)]
    blocks, warps = walk(ranges, Hkv, grid or Hkv * B * parts.shape[2], kps,
                         list_lanes)
    walked = [item for mine in blocks + warps for item in mine]
    assert sorted(walked) == items                # each live item once
    # a warp alone takes an item of one warp step
    assert all(ranges[b][2] <= kps for mine in warps for b, _, _ in mine)
    # the live items are exactly the splits with a key (l > 0)
    assert sorted((b, h // G, s) for b, h, s in
                  (parts[..., D + 1] > 0).nonzero().tolist()
                  if h % G == 0) == items
    ws = torch.full_like(parts, float("nan"))
    for b, hk, s in walked:
        ws[b, hk * G:(hk + 1) * G, s] = parts[b, hk * G:(hk + 1) * G, s]
    out = torch.zeros(B, Hq, D)
    for b, (lo, n, _) in enumerate(ranges):
        if n == 0:
            continue
        p = ws[b, :, lo:lo + n]                               # (Hq, n, D + 2)
        m, l = p[..., D], p[..., D + 1]
        live = l > 0
        mx = torch.where(live, m, torch.full_like(m, NEG_INF)).amax(
            -1, keepdim=True)
        c = torch.where(live, torch.exp(m - mx), torch.zeros_like(m))
        total = (c * l).sum(-1)
        acc = (c[..., None] * p[..., :D]).sum(-2)
        out[b] = torch.where(total[..., None] > 0,
                             acc / torch.where(total > 0, total, 1.0)[..., None],
                             torch.zeros_like(acc))
    return out[:, :, None], ws


def _decode_inputs(seed, B, Hq, Hkv, Smax, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, 1, D), (B, Hkv, Smax, D), (B, Hkv, Smax, D))]


@functools.lru_cache(maxsize=None)
def _dense_case(block_k, G, window):
    """kv_len 1, block_k - 1, block_k, block_k + 1 and Smax (ragged: Smax is
    not a multiple of block_k), caches, and the JAX package's answers
    (reference and Pallas in interpret mode)."""
    Hkv, D = 2, 64
    Smax = 3 * block_k + 9
    kv_len = np.asarray([1, block_k - 1, block_k, block_k + 1, Smax],
                        np.int32)
    q, k, v = _decode_inputs(20 + G, len(kv_len), G * Hkv, Hkv, Smax, D)
    kw = {} if window is None else {"window": window}
    j = [jnp.asarray(a) for a in (q, k, v, kv_len)]
    wants = [jref.decode_attention(*j[:3], kv_len=j[3], **kw),
             pallas_decode(*j, interpret=True, **kw)]
    return (q, k, v, kv_len), [np.asarray(w) for w in wants]


@pytest.mark.parametrize("grid,list_lanes", GRIDS)
@pytest.mark.parametrize("block_k", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window", [None, 71])
def test_splitkv_mirror_matches_jax_and_pallas(block_k, G, window, grid,
                                               list_lanes):
    """kv_len on both sides of split edges; window 71 cuts splits in two;
    grids of 1, 7 and more blocks than items, and lists of 2 lanes."""
    (q, k, v, kv_len), wants = _dense_case(block_k, G, window)
    got, _ = splitkv_decode(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), kv_len, block_k=block_k,
                            window=window, grid=grid, list_lanes=list_lanes)
    for want in wants:
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL,
                                   rtol=F32_TOL)


def test_splitkv_mirror_softcap_and_dead_splits():
    """Softcap 20 at D = 128; a lane with kv_len 0 gets 0 (no live split),
    and no item writes a split past kv_len or left of the window."""
    B, Hq, Hkv, Smax, D, bk, window = 3, 8, 2, 300, 128, 64, 100
    kv_len = np.asarray([0, 130, 300], np.int32)
    q, k, v = _decode_inputs(31, B, Hq, Hkv, Smax, D)
    got, parts = splitkv_decode(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), kv_len, block_k=bk,
                                window=window, softcap=20.0)
    assert torch.count_nonzero(got[0]) == 0
    live = ~parts[..., D + 1].isnan().any(1)                 # (B, splits)
    # lane 1: keys [30, 130) -> splits 0..2; lane 2: [200, 300) -> 3, 4
    assert live.tolist() == [[False] * 5, [True, True, True, False, False],
                             [False, False, False, True, True]]
    want = jref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), kv_len=jnp.asarray(kv_len),
                                 window=window, softcap=20.0)
    np.testing.assert_allclose(got.numpy()[1:], np.asarray(want)[1:],
                               atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------------------------ K3 v3
LANE_MIXES = ["edges", "dead", "one_long"]


def _lanes(mix, full):
    """kv_len of a mix of lanes; ``full``: the whole table. edges: kv_len 0,
    then either side of every split edge of block_k 32, 64 and 128, then
    the whole table; dead: every lane dead, freed (kv_len 1) or never used
    (0); one_long: one lane at the whole table among short ones."""
    return np.asarray({"edges": [0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 129,
                                 full],
                       "dead": [1, 0, 1, 1, 0, 1, 1, 1],
                       "one_long": [1, 3, 1, full, 1, 40, 1, 2]}[mix],
                      np.int32)


@functools.lru_cache(maxsize=None)
def _paged_case(span, G, window, mix):
    """Pools, tables and the JAX package's answers (reference and Pallas in
    interpret mode) for a mix of lanes. Each lane's live blocks are distinct
    random pool blocks; dead entries are the null block 0."""
    Hkv, D = 2, 64
    max_blocks = -(-(2 * 128 + 9) // span)
    kv_len = _lanes(mix, span * max_blocks)
    B = len(kv_len)
    rng = np.random.default_rng(50 + span + G + 100 * LANE_MIXES.index(mix))
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


@pytest.mark.parametrize("grid", [1, 7, None])
@pytest.mark.parametrize("mix", LANE_MIXES)
@pytest.mark.parametrize("block_k", [32, 64, 128])
@pytest.mark.parametrize("span", [16, 32])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window", [None, 71])
def test_paged_splitkv_mirror_matches_jax_and_pallas(block_k, span, G,
                                                     window, mix, grid):
    (q, kp, vp, tables, kv_len), wants = _paged_case(span, G, window, mix)
    got, parts = paged_splitkv_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        tables, kv_len, block_k=block_k, window=window, grid=grid)
    assert parts.shape[2] == -(-span * tables.shape[1] // block_k)
    dead = kv_len == 0
    assert torch.count_nonzero(got[dead]) == 0
    assert parts[dead].isnan().all()             # no item: never written
    for want in wants:
        np.testing.assert_allclose(got.numpy()[~dead], want[~dead],
                                   atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------------------------ K4 v3
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
def _paged_int8_case(span, G, window, mix):
    """K3's mixes of lanes over int8 pools."""
    max_blocks = -(-(2 * 128 + 9) // span)
    kv_len = _lanes(mix, span * max_blocks)
    return _int8_case(70 + span + G + 100 * LANE_MIXES.index(mix), span, G,
                      kv_len, max_blocks, window)


def _check_int8_mirror(inputs, wants, block_k, window=None, softcap=None,
                       grid=None):
    q, kp, vp, ks, vs, tables, kv_len = inputs
    got, parts = paged_splitkv_int8_decode(
        *(torch.from_numpy(a) for a in (q, kp, vp, ks, vs)), tables, kv_len,
        block_k=block_k, window=window, softcap=softcap, grid=grid)
    assert parts.shape[2] == -(-kp.shape[2] * tables.shape[1] // block_k)
    dead = kv_len == 0
    assert torch.count_nonzero(got[dead]) == 0
    assert parts[dead].isnan().all()             # no item: never written
    for want in wants:
        np.testing.assert_allclose(got.numpy()[~dead], want[~dead],
                                   atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("grid", [1, 7, None])
@pytest.mark.parametrize("mix", LANE_MIXES)
@pytest.mark.parametrize("block_k", [32, 64, 128])
@pytest.mark.parametrize("span", [16, 32])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window", [None, 71])
def test_paged_splitkv_int8_mirror_matches_jax_and_pallas(block_k, span, G,
                                                          window, mix, grid):
    inputs, wants = _paged_int8_case(span, G, window, mix)
    _check_int8_mirror(inputs, wants, block_k, window=window, grid=grid)


def test_paged_splitkv_int8_mirror_softcap_and_dead_lane():
    """Softcap 20 at pool blocks of 8 (the reduced tests' span), G = 4: the
    lane of kv_len 0 is 0 and no item writes any of its splits."""
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

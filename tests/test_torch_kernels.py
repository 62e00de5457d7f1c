"""The port's attention kernels against the JAX package.

Each plain torch version (the CPU execution path, and the oracle the Hopper
kernels are held against on the card) is compared with the JAX reference and
with the Pallas kernel in interpret mode, on the same numpy inputs, at the
shapes of tests/test_kernels.py. Tolerances: float32 2e-5, bfloat16 2e-2.
(The Pallas comparison runs for float32 inputs; bfloat16 inputs are held
against the JAX reference, which keeps this file to seconds.) Only rows with
at least one valid key are compared: there the reference
gives mean(V) and the kernels give 0 (ROADMAP Queue 3).

The kernels themselves run only on a card: tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.decode_attention import \
    paged_decode_attention as pallas_paged
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as a JAX array and a torch tensor of the same dtype
    (both round float32 to bfloat16 to nearest even)."""
    return jnp.asarray(a, JDT[dtype]), torch.from_numpy(a).to(TDT[dtype])


def _close(got_t, want_j, dtype, rows=None):
    got = got_t.float().numpy()
    want = np.asarray(want_j, np.float32)
    if rows is not None:
        got, want = got[..., rows, :], want[..., rows, :]
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def _qkv(rng, B, Hq, Hkv, Sq, Sk, D, dtype):
    q = rng.normal(size=(B, Hq, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32)
    return _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)


# --------------------------------------------------------------- flash (K1)
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (1, 1, 1, 128, 64),
    (2, 4, 2, 256, 64),
    (1, 8, 1, 200, 128),
    (2, 6, 2, 384, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax(B, Hq, Hkv, S, D, dtype):
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, B, Hq, Hkv, S, S, D, dtype)
    want = jref.mha_attention(qj, kj, vj, causal=True)
    got = ops.flash_attention(qt, kt, vt, causal=True)
    assert got.dtype == TDT[dtype] and got.shape == qt.shape
    _close(got, want, dtype)
    if dtype == "float32":
        _close(got, pallas_flash(qj, kj, vj, causal=True, interpret=True),
               dtype)
    _close(FA.flash_attention(qt, kt, vt, causal=True), want, dtype)


@pytest.mark.parametrize("window", [1, 17, 64, 1000])
def test_flash_plain_sliding_window(window):
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, 4, 2, 300, 300, 64, "float32")
    want = jref.mha_attention(qj, kj, vj, causal=True, window=window)
    pallas = pallas_flash(qj, kj, vj, causal=True, window=window,
                          interpret=True)
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    _close(got, want, "float32")
    _close(got, pallas, "float32")


@pytest.mark.parametrize("kwargs", [{"softcap": 30.0, "causal": True},
                                    {"causal": False},
                                    {"causal": False, "softcap": 10.0}])
def test_flash_plain_softcap_and_noncausal(kwargs):
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 2, 4, 4, 160, 160, 64, "float32")
    want = jref.mha_attention(qj, kj, vj, **kwargs)
    pallas = pallas_flash(qj, kj, vj, interpret=True, **kwargs)
    got = ops.flash_attention(qt, kt, vt, **kwargs)
    _close(got, want, "float32")
    _close(got, pallas, "float32")


def test_flash_plain_q_offset_and_sk_valid():
    """A later chunk of queries against all keys (q_offset), and keys past
    sk_valid masked. Rows that see no valid key are left out of the
    comparison with the Pallas kernel (it writes 0 there)."""
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, 2, 2, 64, 256, 64, "float32")
    want = jref.mha_attention(qj, kj, vj, causal=True, q_offset=192)
    pallas = pallas_flash(qj, kj, vj, causal=True, q_offset=192,
                          interpret=True)
    got = ops.flash_attention(qt, kt, vt, causal=True, q_offset=192)
    _close(got, want, "float32")
    _close(got, pallas, "float32")
    # sk_valid: the plain version masks through kv_len, as the kernel does
    want = jref.mha_attention(qj, kj, vj, causal=False,
                              kv_len=jnp.asarray([100], jnp.int32))
    pallas = pallas_flash(qj, kj, vj, causal=False, sk_valid=100,
                          interpret=True)
    got = FA.flash_attention_ref(qt, kt, vt, causal=False, sk_valid=100)
    _close(got, want, "float32")
    _close(got, pallas, "float32")


def test_flash_plain_rows_without_a_valid_key():
    """Pinned reference behaviour: a row with no valid key is mean(V) in the
    plain version and 0 in the kernels (Pallas here, CUDA on the card)."""
    rng = np.random.default_rng(4)
    (qj, qt), (kj, kt), (vj, vt) = _qkv(rng, 1, 2, 1, 8, 8, 64, "float32")
    got = FA.flash_attention_ref(qt, kt, vt, causal=True, q_offset=-4)
    pallas = pallas_flash(qj, kj, vj, causal=True, q_offset=-4, interpret=True)
    dead = slice(0, 4)                          # qpos < 0: no key at or left
    np.testing.assert_allclose(got[:, :, dead].numpy(),
                               vt.mean(dim=2, keepdim=True).expand(
                                   1, 2, 4, 64).numpy(), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(pallas)[:, :, dead], 0.0)
    _close(got, pallas, "float32", rows=slice(4, 8))


def test_chunked_plain_matches_dense_plain():
    rng = np.random.default_rng(5)
    (_, qt), (_, kt), (_, vt) = _qkv(rng, 1, 4, 2, 1000, 1000, 64, "float32")
    want = ref.mha_attention(qt, kt, vt, causal=True, window=123)
    got = ref.mha_attention_chunked(qt, kt, vt, causal=True, window=123,
                                    block_q=256)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    got = ops.flash_attention(qt, kt, vt, causal=True, window=123, block_q=256)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


# --------------------------------------------------------------- decode (K2)
@pytest.mark.parametrize("B,Hq,Hkv,Smax,D", [
    (1, 4, 4, 128, 64),
    (2, 8, 2, 300, 64),
    (3, 4, 1, 257, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_jax(B, Hq, Hkv, Smax, D, dtype):
    rng = np.random.default_rng(10)
    qj, qt = _pair(rng.normal(size=(B, Hq, 1, D)).astype(np.float32), dtype)
    kj, kt = _pair(rng.normal(size=(B, Hkv, Smax, D)).astype(np.float32), dtype)
    vj, vt = _pair(rng.normal(size=(B, Hkv, Smax, D)).astype(np.float32), dtype)
    kv = rng.integers(1, Smax + 1, size=(B,)).astype(np.int32)
    want = jref.decode_attention(qj, kj, vj, kv_len=jnp.asarray(kv))
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(kv))
    assert got.dtype == TDT[dtype] and got.shape == qt.shape
    _close(got, want, dtype)
    if dtype == "float32":
        _close(got, pallas_decode(qj, kj, vj, jnp.asarray(kv), interpret=True),
               dtype)
    _close(DA.decode_attention(qt, kt, vt, torch.from_numpy(kv)), want, dtype)


@pytest.mark.parametrize("kwargs", [{"window": 64}, {"softcap": 20.0},
                                    {"window": 32, "softcap": 5.0},
                                    {"window": 100}])
def test_decode_plain_window_and_softcap(kwargs):
    """window 64/32 on a 384-row cache takes the sliding-window gather fast
    path (Smax > 2 * window); window 100 the masked dense path."""
    rng = np.random.default_rng(11)
    B, Hq, Hkv, Smax, D = 2, 8, 2, 384, 64
    qj, qt = _pair(rng.normal(size=(B, Hq, 1, D)).astype(np.float32), "float32")
    kj, kt = _pair(rng.normal(size=(B, Hkv, Smax, D)).astype(np.float32),
                   "float32")
    vj, vt = _pair(rng.normal(size=(B, Hkv, Smax, D)).astype(np.float32),
                   "float32")
    kv = np.asarray([100, 384], np.int32)
    want = jref.decode_attention(qj, kj, vj, kv_len=jnp.asarray(kv), **kwargs)
    pallas = pallas_decode(qj, kj, vj, jnp.asarray(kv), interpret=True,
                           **kwargs)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(kv), **kwargs)
    _close(got, want, "float32")
    _close(got, pallas, "float32")


# ---------------------------------------------------------- paged decode (K3)
def _paged_inputs(rng, B, Hq, Hkv, bs, nb, mb, D, dtype):
    q = _pair(rng.normal(size=(B, Hq, 1, D)).astype(np.float32), dtype)
    kp = _pair(rng.normal(size=(nb, Hkv, bs, D)).astype(np.float32), dtype)
    vp = _pair(rng.normal(size=(nb, Hkv, bs, D)).astype(np.float32), dtype)
    tables = rng.integers(0, nb, size=(B, mb)).astype(np.int32)
    return q, kp, vp, tables


@pytest.mark.parametrize("B,Hq,Hkv,bs,nb,mb,D", [
    (1, 4, 4, 128, 8, 4, 64),
    (2, 8, 2, 16, 24, 6, 64),
    (3, 4, 1, 32, 12, 5, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_jax(B, Hq, Hkv, bs, nb, mb, D, dtype):
    rng = np.random.default_rng(20)
    (qj, qt), (kj, kt), (vj, vt), tables = _paged_inputs(
        rng, B, Hq, Hkv, bs, nb, mb, D, dtype)
    kv = rng.integers(1, mb * bs + 1, size=(B,)).astype(np.int32)
    want = jref.paged_decode_attention(qj, kj, vj, jnp.asarray(tables),
                                       kv_len=jnp.asarray(kv))
    tt, kvt = torch.from_numpy(tables), torch.from_numpy(kv)
    got = ops.paged_decode_attention(qt, kt, vt, tt, kvt)
    _close(got, want, dtype)
    if dtype == "float32":
        _close(got, pallas_paged(qj, kj, vj, jnp.asarray(tables),
                                 jnp.asarray(kv), interpret=True), dtype)
    _close(DA.paged_decode_attention(qt, kt, vt, tt, kvt), want, dtype)
    # the gathered contiguous view is the reference's, element for element
    np.testing.assert_array_equal(
        ref.gather_paged_kv(kt, tt).float().numpy(),
        np.asarray(jref.gather_paged_kv(kj, jnp.asarray(tables)), np.float32))


@pytest.mark.parametrize("kwargs", [{"window": 64}, {"softcap": 20.0},
                                    {"window": 48, "softcap": 5.0}])
def test_paged_plain_window_and_softcap(kwargs):
    rng = np.random.default_rng(21)
    (qj, qt), (kj, kt), (vj, vt), tables = _paged_inputs(
        rng, 2, 8, 2, 32, 16, 8, 64, "float32")
    kv = np.asarray([60, 256], np.int32)
    want = jref.paged_decode_attention(qj, kj, vj, jnp.asarray(tables),
                                       kv_len=jnp.asarray(kv), **kwargs)
    pallas = pallas_paged(qj, kj, vj, jnp.asarray(tables), jnp.asarray(kv),
                          interpret=True, **kwargs)
    got = ops.paged_decode_attention(qt, kt, vt, torch.from_numpy(tables),
                                     torch.from_numpy(kv), **kwargs)
    _close(got, want, "float32")
    _close(got, pallas, "float32")


# ---------------------------------------------------------------- dispatch
def test_ops_rejects_unknown_backend():
    x = torch.zeros((1, 1, 4, 64))
    with pytest.raises(ValueError, match="backend"):
        ops.flash_attention(x, x, x, backend="pallas")


def test_launch_counters_start_at_zero_and_cpu_does_not_count():
    """A wrapper counts kernel launches only; the CPU path launches none."""
    before = (FA.flash_attention.launches, DA.decode_attention.launches,
              DA.paged_decode_attention.launches)
    x = torch.zeros((1, 2, 4, 64))
    FA.flash_attention(x, x, x)
    DA.decode_attention(x[:, :, :1], x, x, torch.ones(1, dtype=torch.int32))
    DA.paged_decode_attention(x[:, :, :1], x[0:1].expand(2, 2, 4, 64)
                              .contiguous(), x[0:1].expand(2, 2, 4, 64)
                              .contiguous(), torch.zeros((1, 1), dtype=torch.int32),
                              torch.ones(1, dtype=torch.int32))
    after = (FA.flash_attention.launches, DA.decode_attention.launches,
             DA.paged_decode_attention.launches)
    assert after == before


def test_kernel_sources_and_build_are_lazy():
    """Importing the wrappers builds nothing; the sources the build compiles
    exist in the package and name the TPU kernels they replace."""
    from repro_torch.kernels import _build
    assert _build._lib is None
    srcs = {p.name for p in _build._sources()}
    assert srcs == {"flash_attention.cu", "decode_attention.cu",
                    "ssm_scan.cu", "flash_attention_bwd.cu",
                    "ssm_scan_bwd.cu", "chunk_attention.cu"}
    text = (_build.CSRC_DIR / "flash_attention.cu").read_text()
    assert "repro/kernels/flash_attention.py" in text
    # K1-bwd: the gradient of the same TPU kernel, which has no backward
    text = (_build.CSRC_DIR / "flash_attention_bwd.cu").read_text()
    assert "repro/kernels/flash_attention.py" in text
    assert 'extern "C" int repro_flash_attention_bwd(' in text
    # dtype, D, q k v o dO, the forward's lse, dq dk dv, the scratch (delta,
    # dK and dV shares), 7 ints, 2 floats, the stream
    assert len(_build._SIGNATURES["repro_flash_attention_bwd"]) == 24
    # K1 takes one more pointer than it returns: the lse it may write
    assert len(_build._SIGNATURES["repro_flash_attention"]) == 21
    # K5-bwd: the gradient of the SSD scan, which has no backward either
    text = (_build.CSRC_DIR / "ssm_scan_bwd.cu").read_text()
    assert "repro/kernels/ssm_scan.py" in text and "_ssd_kernel" in text
    assert 'extern "C" int repro_ssd_scan_bwd(' in text
    # dtype, N, 19 pointers (inputs, dy, dfinal, the forward's workspace,
    # the scratch, the gradients), B H S P chunk, the stream
    assert len(_build._SIGNATURES["repro_ssd_scan_bwd"]) == 27
    text = (_build.CSRC_DIR / "decode_attention.cu").read_text()
    assert "_decode_kernel" in text and "_paged_decode_kernel" in text
    # K6, the paged chunk attention, replaces no Pallas kernel: the JAX
    # package's chunked prefill attends on its plain path
    text = (_build.CSRC_DIR / "chunk_attention.cu").read_text()
    assert "Replaces no Pallas kernel" in text
    assert 'extern "C" int repro_paged_chunk_attention(' in text
    # dtype, D, q k_pool v_pool table kv_len q_offset o, 6 ints, 2 floats,
    # the stream
    assert len(_build._SIGNATURES["repro_paged_chunk_attention"]) == 18
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_ssm_scan_source_is_built_lazily():
    """K5's source is in the lazy build, names the TPU kernel it replaces,
    and its C entry point has a ctypes signature; importing its wrapper
    builds nothing."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssm_scan  # noqa: F401
    assert _build._lib is None
    assert _build.CSRC_DIR / "ssm_scan.cu" in _build._sources()
    text = (_build.CSRC_DIR / "ssm_scan.cu").read_text()
    assert "repro/kernels/ssm_scan.py" in text and "_ssd_kernel" in text
    assert 'extern "C" int repro_ssd_scan(' in text
    # inputs, outputs, the workspace (states, totals), shapes, chunk, the
    # passes mask and the stream
    assert len(_build._SIGNATURES["repro_ssd_scan"]) == 18

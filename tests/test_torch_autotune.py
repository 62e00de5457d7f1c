"""The port's autotuner, timer and tuned dispatch against the JAX package's
(the analogues of tests/test_autotune.py).

  * param spaces hold the default first; the "ref" rows are the
    reference's, the "cuda" rows the Hopper kernels' own parameters;
  * the cache round-trips in the reference's JSON, is deterministic,
    refuses another environment and another version, and loads a cache
    the JAX package wrote (with ``require_env=False``);
  * with no cache installed every ``ops`` entry point is bit for bit its
    untuned self; an installed cache routes ``impl`` and tiles, and an
    explicit kwarg beats it;
  * the timer counts the reference timer's work and a grid search never
    picks a winner slower than the default on the measured grid.

Everything here runs the plain path (backend "ref") on the CPU; the "cuda"
backend is timed on the card by chip_smoke.py.
"""
import inspect
import json

import numpy as np
import pytest
import torch

from repro.kernels import autotune as JAT
from repro_torch.core.pricing import KernelSample
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as SS
from repro_torch.kernels import timing
from repro_torch.launch import envcfg


@pytest.fixture(autouse=True)
def _no_installed_cache():
    """Every test starts and ends with no process-wide cache installed."""
    AT.install(None)
    yield
    AT.install(None)


def det_timer(kernel, shape, *, params, backend, iters, seed):
    """Deterministic fake timer (the reference test's): time depends only on
    (kernel, shape, params), with a fixed non-default winner per kernel."""
    fast = {"flash_attention": {"block_q": 256},
            "ssm_scan": {"chunk": 64},
            "decode_attention": {"block_kv": 64},
            "paged_decode_quant": {"impl": "fused"}}
    base = 1e-3 * (1 + sum(shape.values()) / 1024)
    t = base * (0.5 if params == fast.get(kernel) else 1.0 + 0.01 * (
        sum(ord(c) for c in json.dumps(params, sort_keys=True)) % 7))
    return KernelSample(kernel, 1e9, 1e6,
                        float(shape.get("c", shape.get("s", 0))), t, 0.01)


def make_cache(backend="ref"):
    shapes = {"flash_attention": [{"s": 1024}], "ssm_scan": [{"s": 512}],
              "paged_decode_quant": [{"b": 8, "c": 1024}]}
    if backend != "ref":
        shapes["decode_attention"] = [{"b": 2, "c": 2048}]
    return AT.autotune(shapes, profile="host-cpu", backend=backend,
                       timer=det_timer)


def _entry(kernel, backend, bucket, params):
    return AT.TunedEntry(kernel=kernel, backend=backend, bucket=bucket,
                         params=params, t_s=1.0, t_default_s=1.0,
                         noise_frac=0.0, flops=0.0, bytes=0.0, ctx=0.0)


# ------------------------------------------------------------- param spaces
def test_spaces_contain_defaults_first():
    for (kernel, backend), default in AT.DEFAULT_PARAMS.items():
        assert backend in AT.BACKENDS and kernel in AT.KERNELS
        space = AT.param_space(kernel, backend)
        if not space:
            assert default == {}, (kernel, backend)
            continue
        assert space[0] == default, (kernel, backend)
        assert all(space.count(c) == 1 for c in space)


def test_ref_rows_copy_the_reference():
    for kernel in AT.KERNELS:
        assert AT.default_params(kernel, "ref") == \
            JAT.default_params(kernel, "ref")
        assert AT.param_space(kernel, "ref") == JAT.param_space(kernel, "ref")


def test_cuda_rows_are_the_kernels_own_parameters():
    """Defaults are today's kernel defaults; every candidate is one the
    kernels take."""
    assert AT.default_params("flash_attention", "cuda") == \
        {"block_q": 64, "block_kv": 64}
    assert AT.default_params("decode_attention", "cuda") == {"block_kv": 64}
    flash = inspect.signature(FA.flash_attention).parameters
    assert (flash["block_q"].default, flash["block_k"].default) == (64, 64)
    decode = inspect.signature(DA.decode_attention).parameters
    assert decode["block_k"].default == 64
    assert AT.default_params("paged_decode_quant", "cuda") == \
        {"impl": "gather"}
    assert AT.default_params("ssm_scan", "cuda") == {"chunk": 128}
    for c in AT.param_space("flash_attention", "cuda"):
        assert c["block_q"] in FA.TILE_SIZES
        for dtype, (tiles_q, tiles_k) in FA.TILES.items():
            assert c["block_q"] in tiles_q and c["block_kv"] in tiles_k, dtype
    assert len(AT.param_space("flash_attention", "cuda")) == 6
    assert {c["block_kv"] for c in AT.param_space("decode_attention",
                                                  "cuda")} == {32, 64, 128}
    assert {c["chunk"] for c in AT.param_space("ssm_scan", "cuda")} == \
        set(SS.CHUNKS)
    assert {c["impl"] for c in AT.param_space("paged_decode_quant",
                                              "cuda")} == set(ops.QUANT_IMPLS)
    with pytest.raises(KeyError):
        AT.param_space("flash_attention", "pallas")


@pytest.mark.parametrize("kernel,dims", [
    ("flash_attention", {"s": 1024}), ("flash_attention", {"s": 1000}),
    ("flash_attention", {"s": 1025}), ("ssm_scan", {"s": 512}),
    ("paged_decode_quant", {"b": 6, "c": 1500}),
    ("paged_decode_quant", {"b": 4, "c": 34 * 16}),
    ("decode_attention", {"b": 1, "c": 544})])
def test_shape_bucket_pow2_as_the_reference(kernel, dims):
    assert AT.shape_bucket(kernel, **dims) == JAT.shape_bucket(kernel, **dims)


def test_shape_bucket_values():
    assert AT.shape_bucket("flash_attention", s=1000) == "s1024"
    assert AT.shape_bucket("flash_attention", s=1025) == "s2048"
    assert AT.shape_bucket("paged_decode_quant", b=4, c=34 * 16) == "b4c1024"
    with pytest.raises(KeyError):
        AT.shape_bucket("nope", s=1)


# ------------------------------------------------------------------- cache
def test_cache_roundtrip(tmp_path):
    cache = make_cache()
    assert len(cache.entries) == 3
    path = cache.dump(AT.cache_path("host-cpu", "ref", str(tmp_path)))
    loaded = AT.AutotuneCache.load(path)
    assert loaded.to_json() == cache.to_json()
    for e in cache.entries.values():
        assert loaded.resolve(e.kernel, e.backend, e.bucket) == e.params
    assert loaded.resolve("flash_attention", "ref", "s4096") is None
    assert loaded.resolve("flash_attention", "cuda", "s1024") is None
    assert AT.cache_path("p", "cuda").endswith(
        "build/repro_torch/autotune/p__cuda.json")


def test_cache_deterministic_at_fixed_seed_env():
    a, b = make_cache(), make_cache()
    assert a.to_json() == b.to_json()
    assert a.to_json()["env"]["torch"] == torch.__version__


def test_stale_env_refused(tmp_path):
    cache = make_cache()
    path = cache.dump(str(tmp_path / "c.json"))
    with open(path) as f:
        data = json.load(f)
    data["env"]["torch"] = "0.0.0-stale"
    data["env_digest"] = envcfg.fingerprint_digest(data["env"])
    stale = str(tmp_path / "stale.json")
    with open(stale, "w") as f:
        json.dump(data, f)
    with pytest.raises(AT.StaleCacheError):
        AT.AutotuneCache.load(stale)
    assert AT.AutotuneCache.load(stale, require_env=False).entries
    data["env_digest"] = "0" * 16            # tampered: corruption
    with open(stale, "w") as f:
        json.dump(data, f)
    with pytest.raises(ValueError, match="corrupt"):
        AT.AutotuneCache.load(stale, require_env=False)


def test_cache_version_pinned(tmp_path):
    data = make_cache().to_json()
    data["version"] = AT.CACHE_VERSION + 1
    path = str(tmp_path / "v.json")
    with open(path, "w") as f:
        json.dump(data, f)
    with pytest.raises(ValueError, match="version"):
        AT.AutotuneCache.load(path)


@pytest.mark.parametrize("var", ["CUDA_VISIBLE_DEVICES", "REPRO_CACHE_MODE",
                                 "REPRO_ANY_SETTING"])
def test_env_fingerprint_tracks_captured_vars(monkeypatch, var):
    monkeypatch.delenv(var, raising=False)
    base = envcfg.fingerprint_digest()
    monkeypatch.setenv(var, "weird-test-value")
    assert envcfg.env_fingerprint()[f"env:{var}"] == "weird-test-value"
    assert envcfg.fingerprint_digest() != base


def test_env_fingerprint_records_versions_and_device():
    fp = envcfg.env_fingerprint()
    for key in ("torch", "cuda", "triton", "numpy", "python", "machine",
                "system", "device_name", "device_count", "tf32_matmul",
                "tf32_cudnn"):
        assert key in fp
    assert list(fp) == sorted(fp)
    # the port sets both TF32 switches off at import
    assert fp["tf32_matmul"] == fp["tf32_cudnn"] == "False"
    if not torch.cuda.is_available():
        assert (fp["device_name"], fp["device_count"]) == ("cpu", "0")


def test_jax_cache_json_loads_without_env_check(tmp_path):
    """A cache the JAX package wrote loads here with require_env=False (its
    digest checks out: the same hash of the recorded env) and resolves the
    same winners; with the env check it is stale."""
    jshapes = {"flash_attention": [{"s": 1024}], "ssm_scan": [{"s": 512}],
               "paged_decode_quant": [{"b": 8, "c": 1024}]}
    jcache = JAT.autotune(jshapes, profile="host-cpu", backend="ref",
                          timer=det_timer)
    path = jcache.dump(str(tmp_path / "jax.json"))
    with pytest.raises(AT.StaleCacheError):
        AT.AutotuneCache.load(path)
    mine = AT.AutotuneCache.load(path, require_env=False)
    assert mine.env == jcache.env
    for e in jcache.entries.values():
        assert mine.resolve(e.kernel, e.backend, e.bucket) == e.params
    assert mine.to_json()["entries"] == json.loads(
        json.dumps(jcache.to_json()["entries"]))


def test_tuned_samples_are_the_ports_kernel_samples():
    samples = make_cache().tuned_samples()
    assert all(isinstance(s, KernelSample) for s in samples)
    assert [s.kernel for s in samples] == sorted(s.kernel for s in samples)
    assert make_cache().geomean_speedup() > 1.0


# ------------------------------------------------- untuned dispatch (no cache)
def _attn_inputs(seed=0, B=2, Hq=4, Hkv=2, S=256, Dh=64):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(B, h, S, Dh))
                                  .astype(np.float32))
                 for h in (Hq, Hkv, Hkv))


def _quant_inputs(seed=0, B=2, Hq=4, Hkv=2, Dh=64, bs=16, mb=8):
    rng = np.random.default_rng(seed)
    ctx, nb = bs * mb, 1 + B * mb
    t = torch.from_numpy
    q = t(rng.normal(size=(B, Hq, 1, Dh)).astype(np.float32))
    kp = t(rng.integers(-127, 128, (nb, Hkv, bs, Dh)).astype(np.int8))
    vp = t(rng.integers(-127, 128, (nb, Hkv, bs, Dh)).astype(np.int8))
    ks = t(rng.uniform(.005, .02, (nb, Hkv, bs, 1)).astype(np.float32))
    vs = t(rng.uniform(.005, .02, (nb, Hkv, bs, 1)).astype(np.float32))
    tables = t(np.arange(1, 1 + B * mb).reshape(B, mb).astype(np.int32))
    kv_len = t(np.asarray([ctx - (37 * i) % 101 for i in range(B)], np.int32))
    return q, kp, vp, ks, vs, tables, kv_len


def _ssd_inputs(seed=3, B=2, H=4, S=384, P=16, N=8):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(a.astype(np.float32))
    return (f(rng.normal(size=(B, H, S, P))), f(rng.uniform(.001, .2, (B, H, S))),
            f(-rng.uniform(.5, 4., (H,))), f(rng.normal(size=(B, S, N))),
            f(rng.normal(size=(B, S, N))))


def test_untuned_dispatch_bit_for_bit():
    """No cache installed: each entry point equals its direct plain call
    with the default parameters."""
    q, k, v = _attn_inputs(S=2048)       # > the plain default block_q
    assert torch.equal(ops.flash_attention(q, k, v),
                       ref.mha_attention_chunked(q, k, v, causal=True,
                                                 block_q=1024))
    qd = q[:, :, :1]
    kv_len = torch.tensor([2048, 1500], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(qd, k, v, kv_len),
                       ref.decode_attention(qd, k, v, kv_len=kv_len))
    x = _ssd_inputs()
    y, fin = ops.ssd_scan(*x)
    yw, finw = ref.ssd_scan_chunked(*x, chunk=128)
    assert torch.equal(y, yw) and torch.equal(fin, finw)


def test_untuned_quant_path_is_the_gather_composition():
    q, kp, vp, ks, vs, tables, kv_len = _quant_inputs()
    for backend in ("auto", "ref"):
        got = ops.paged_decode_attention_quant(
            q, kp, vp, ks, vs, tables, kv_len, softcap=30.0, backend=backend)
        k_read = ref.dequantize_kv(ref.gather_paged_kv(kp, tables),
                                   ref.gather_paged_kv(ks, tables), q.dtype)
        v_read = ref.dequantize_kv(ref.gather_paged_kv(vp, tables),
                                   ref.gather_paged_kv(vs, tables), q.dtype)
        want = ops.decode_attention(q, k_read, v_read, kv_len, softcap=30.0,
                                    backend=backend)
        assert torch.equal(got, want), backend
        assert torch.equal(got, ref.paged_decode_attention_quant(
            q, kp, vp, ks, vs, tables, kv_len=kv_len, softcap=30.0))


# --------------------------------------------------------- tuned dispatch
def test_tuned_quant_impl_switches_kernel():
    cache = make_cache()                        # fused wins under det_timer
    q, kp, vp, ks, vs, tables, kv_len = _quant_inputs(B=8, mb=64)  # b8c1024
    gather = ops.paged_decode_attention_quant(q, kp, vp, ks, vs, tables,
                                              kv_len)
    AT.install(cache)
    tuned = ops.paged_decode_attention_quant(q, kp, vp, ks, vs, tables,
                                             kv_len)
    want = ref.paged_decode_attention_quant_fused(q, kp, vp, ks, vs, tables,
                                                  kv_len=kv_len)
    assert torch.equal(tuned, want)
    # numerically interchangeable, not bit-equal (no q.dtype rounding)
    torch.testing.assert_close(tuned, gather, atol=2e-5, rtol=0)
    # an explicit impl beats the tuned one
    assert torch.equal(ops.paged_decode_attention_quant(
        q, kp, vp, ks, vs, tables, kv_len, impl="gather"), gather)
    with pytest.raises(ValueError, match="impl"):
        ops.paged_decode_attention_quant(q, kp, vp, ks, vs, tables, kv_len,
                                         impl="nope")


def test_tuned_params_reach_the_plain_path_and_kwargs_override(monkeypatch):
    AT.install(make_cache())
    seen = {}
    orig_fa, orig_ss = ref.mha_attention_chunked, ref.ssd_scan_chunked

    def spy_fa(q, k, v, **kw):
        seen["flash"] = kw
        return orig_fa(q, k, v, **kw)

    def spy_ss(*a, **kw):
        seen["ssm"] = kw
        return orig_ss(*a, **kw)

    monkeypatch.setattr(ops._ref, "mha_attention_chunked", spy_fa)
    monkeypatch.setattr(ops._ref, "ssd_scan_chunked", spy_ss)
    q, k, v = _attn_inputs(S=1024, B=1)
    ops.flash_attention(q, k, v)
    assert seen["flash"]["block_q"] == 256            # det_timer's winner
    ops.flash_attention(q, k, v, block_q=128)
    assert seen["flash"]["block_q"] == 128            # explicit kwarg wins
    q2, k2, v2 = _attn_inputs(S=2048, B=1)
    ops.flash_attention(q2, k2, v2)                   # s2048: no entry
    assert "block_q" not in seen["flash"]
    x = _ssd_inputs(S=512)
    ops.ssd_scan(*x)
    assert seen["ssm"]["chunk"] == 64
    ops.ssd_scan(*x, chunk=32)
    assert seen["ssm"]["chunk"] == 32


def test_cuda_entries_do_not_steer_the_plain_path():
    """A CPU tensor looks up the "ref" rows only: a "cuda" entry for the
    same bucket changes nothing there."""
    q, kp, vp, ks, vs, tables, kv_len = _quant_inputs(B=8, mb=64)
    untuned = ops.paged_decode_attention_quant(q, kp, vp, ks, vs, tables,
                                               kv_len)
    AT.install(AT.AutotuneCache("p", "cuda", entries=[_entry(
        "paged_decode_quant", "cuda", "b8c1024", {"impl": "fused"})]))
    assert torch.equal(ops.paged_decode_attention_quant(
        q, kp, vp, ks, vs, tables, kv_len), untuned)


# ------------------------------------------------------------ the tuner
def test_autotune_never_slower_on_measured_grid():
    """Real (tiny) grid search on the plain path: the winner's time never
    exceeds the default's, because the default is in every space."""
    shapes = {"ssm_scan": [{"s": 64}], "flash_attention": [{"s": 64}],
              "paged_decode_quant": [{"b": 2, "c": 64}]}
    cache = AT.autotune(shapes, profile="host-cpu", backend="ref", iters=2)
    assert len(cache.entries) == 3
    for e in cache.entries.values():
        assert e.t_s <= e.t_default_s and e.speedup >= 1.0
        assert e.noise_frac >= 0.0
    assert cache.geomean_speedup() >= 1.0


def test_autotune_needs_an_explicit_known_backend():
    with pytest.raises(TypeError):
        AT.autotune({"ssm_scan": [{"s": 64}]}, profile="p", timer=det_timer)
    with pytest.raises(ValueError, match="backend"):
        AT.autotune({"ssm_scan": [{"s": 64}]}, profile="p", backend="pallas",
                    timer=det_timer)


def test_cuda_timing_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.time_kernel("ssm_scan", {"s": 64}, backend="cuda")


@pytest.mark.parametrize("kernel,shape,params", [
    ("flash_attention", {"s": 64}, None),
    ("decode_attention", {"b": 2, "c": 64}, None),
    ("paged_decode_quant", {"b": 2, "c": 64}, {"impl": "gather"}),
    ("paged_decode_quant", {"b": 2, "c": 64}, {"impl": "fused"}),
    ("kv_migrate", {"blocks": 1}, None),
    ("kv_migrate", {"blocks": 8}, None),
    ("ssm_scan", {"s": 64}, {"chunk": 32})])
def test_timer_work_counts_are_the_reference_timers(kernel, shape, params):
    """The same kernel kinds and analytic work counts as the reference's
    benchmarks/microbench.time_kernel on the plain path."""
    from benchmarks.microbench import time_kernel as jax_time_kernel
    got = timing.time_kernel(kernel, shape, params=params, backend="ref",
                             iters=1)
    want = jax_time_kernel(kernel, shape, params=params, backend="ref",
                           iters=1)
    assert (got.kernel, got.flops, got.bytes, got.ctx) == \
        (want.kernel, want.flops, want.bytes, want.ctx)
    assert got.t_s > 0 and got.noise_frac >= 0.0


def test_timer_runs_through_ops_with_the_pinned_params(monkeypatch):
    seen = []
    orig = ops.paged_decode_attention_quant

    def spy(*a, **kw):
        seen.append(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(timing.ops, "paged_decode_attention_quant", spy)
    timing.time_kernel("paged_decode_quant", {"b": 2, "c": 32},
                       params={"impl": "fused"}, backend="ref", iters=3)
    assert len(seen) == 2 + 3                  # two warm-ups, three timed
    assert all(kw["impl"] == "fused" and kw["backend"] == "ref"
               for kw in seen)

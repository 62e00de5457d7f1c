"""The port's SSM and hybrid families against the JAX package.

Plain SSD functions against the JAX reference and the Pallas K5 in interpret
mode, at the cases of tests/test_kernels.py (float32 2e-5, bfloat16 5e-2);
the Mamba2 block, the reduced mamba2-130m and zamba2-1.2b models (logits
and caches at 1e-4 in float32: XLA and torch sum in different orders), the
engine, the dense batcher and FleetRouter on the same weights, converted
through numpy. The kernel itself runs only on a card:
tests/test_torch_gpu.py.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.systems import paper_fleet as jax_paper_fleet
from repro.kernels import ref as jref
from repro.kernels.ssm_scan import ssd_scan as pallas_ssd
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro.serving.batching import ContinuousBatcher as JaxBatcher
from repro.serving.batching import Request as JaxRequest
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.router import FleetRouter as JaxRouter
from repro_torch.configs import get_config
from repro_torch.core.systems import paper_fleet
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as SS
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.batching import ContinuousBatcher, Request
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.router import FleetRouter

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["mamba2-130m", "zamba2-1.2b"]
TOL = 1e-4
SSD_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _ssd_inputs(rng, B, H, S, P, N, dtype, dt_lo=0.001, a_hi=4.0):
    """numpy inputs of the SSD scan as (jax, torch) pairs; dt and A are
    float32, as the model hands them over."""
    x = rng.normal(size=(B, H, S, P)).astype(np.float32)
    dt = rng.uniform(dt_lo, 0.2, size=(B, H, S)).astype(np.float32)
    A = -rng.uniform(0.5, a_hi, size=(H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    j = (jnp.asarray(x, JDT[dtype]), jnp.asarray(dt), jnp.asarray(A),
         jnp.asarray(Bm, JDT[dtype]), jnp.asarray(Cm, JDT[dtype]))
    t = (torch.from_numpy(x).to(TDT[dtype]), torch.from_numpy(dt),
         torch.from_numpy(A), torch.from_numpy(Bm).to(TDT[dtype]),
         torch.from_numpy(Cm).to(TDT[dtype]))
    return j, t


# ------------------------------------------------------------ (a) SSD scan
@pytest.mark.parametrize("B,H,S,P,N,chunk", [
    (1, 1, 64, 32, 16, 32),
    (2, 3, 200, 32, 64, 64),     # ragged (padding path)
    (1, 4, 256, 64, 128, 128),   # full-size state
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_plain_matches_jax_and_pallas(B, H, S, P, N, chunk, dtype):
    rng = np.random.default_rng(0)
    j, t = _ssd_inputs(rng, B, H, S, P, N, dtype)
    tol = SSD_TOL[dtype]
    y_want, fs_want = jref.ssd_scan(*j)
    y_pallas, fs_pallas = pallas_ssd(*j, chunk=chunk, interpret=True)
    y_got, fs_got = ops.ssd_scan(*t, chunk=chunk)
    assert y_got.dtype == TDT[dtype] and y_got.shape == (B, H, S, P)
    assert fs_got.dtype == torch.float32 and fs_got.shape == (B, H, P, N)
    for want_y, want_fs in ((y_want, fs_want), (y_pallas, fs_pallas)):
        _close(y_got, want_y, tol)
        _close(fs_got, want_fs, tol)
    # the sequential oracle, and the kernel wrapper's CPU path
    y_seq, fs_seq = ref.ssd_scan(*t)
    _close(y_seq, y_want, tol)
    _close(fs_seq, fs_want, tol)
    y_w, fs_w = SS.ssd_scan(*t, chunk=chunk)
    assert torch.equal(y_w, y_got) and torch.equal(fs_w, fs_got)


@pytest.mark.parametrize("jax_fn", ["ssd_scan", "ssd_scan_chunked"])
def test_ssd_chunked_plain_matches_jax_at_mamba2_shape(jax_fn):
    """mamba2-130m's full scan shape (H = 24, P = 64, N = 128, S = 512,
    chunk 128), float32: the port's plain chunked form against the JAX
    sequential oracle and the JAX chunked form."""
    rng = np.random.default_rng(5)
    j, t = _ssd_inputs(rng, 1, 24, 512, 64, 128, "float32")
    kw = {"chunk": 128} if jax_fn == "ssd_scan_chunked" else {}
    y_want, fs_want = getattr(jref, jax_fn)(*j, **kw)
    y_got, fs_got = ref.ssd_scan_chunked(*t, chunk=128)
    _close(y_got, y_want, SSD_TOL["float32"])
    _close(fs_got, fs_want, SSD_TOL["float32"])


def test_ssd_chunked_plain_matches_sequential_and_default_chunk():
    rng = np.random.default_rng(1)
    _, t = _ssd_inputs(rng, 2, 2, 330, 32, 16, "float32")
    y1, f1 = ref.ssd_scan(*t)
    y2, f2 = ref.ssd_scan_chunked(*t, chunk=128)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=2e-5)
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), atol=2e-5)
    y3, f3 = ops.ssd_scan(*t)                   # chunk=None is 128
    assert torch.equal(y3, y2) and torch.equal(f3, f2)
    y4, f4 = ops.ssd_scan(*t, chunk=32, backend="ref")
    np.testing.assert_allclose(y4.numpy(), y1.numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="backend"):
        ops.ssd_scan(*t, backend="pallas")


def test_ssd_decode_step_continues_the_scan():
    """Decode steps from the scan's final state continue the sequence, and
    each step equals the JAX reference's."""
    rng = np.random.default_rng(2)
    S = 96
    (xj, dtj, Aj, Bj, Cj), (x, dt, A, Bm, Cm) = _ssd_inputs(
        rng, 1, 2, S + 3, 32, 16, "float32", dt_lo=0.01, a_hi=2.0)
    y_full, _ = ref.ssd_scan(x, dt, A, Bm, Cm)
    _, state = ops.ssd_scan(x[:, :, :S], dt[:, :, :S], A, Bm[:, :S], Cm[:, :S])
    _, jstate = jref.ssd_scan(xj[:, :, :S], dtj[:, :, :S], Aj, Bj[:, :S],
                              Cj[:, :S])
    for s in range(S, S + 3):
        y_t, state = ops.ssd_decode_step(state, x[:, :, s], dt[:, :, s], A,
                                         Bm[:, s], Cm[:, s])
        jy_t, jstate = jref.ssd_decode_step(jstate, xj[:, :, s], dtj[:, :, s],
                                            Aj, Bj[:, s], Cj[:, s])
        np.testing.assert_allclose(y_t.numpy(), y_full[:, :, s].numpy(),
                                   atol=2e-5)
        _close(y_t, jy_t, 2e-5)
        _close(state, jstate, 2e-5)
        assert state.dtype == torch.float32


def test_ssd_kernel_wrapper_counts_no_cpu_launch():
    rng = np.random.default_rng(3)
    _, t = _ssd_inputs(rng, 1, 2, 40, 64, 64, "float32")
    before = SS.ssd_scan.launches
    SS.ssd_scan(*t)
    SS.ssd_scan_ref(*t)
    assert SS.ssd_scan.launches == before


# ------------------------------------------------------------ models
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, torch cfg, torch params) of one reduced arch."""
    jcfg = jax_config(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("S", [2, 45])
def test_mamba_block_prefill_and_decode_match_reference(pair, S):
    """(b) One Mamba2 block: the prompt with its states (S = 2 < W - 1 takes
    the conv-state padding), then three decode steps."""
    jcfg, jp, tcfg, tp = pair
    jm = jax.tree.map(lambda a: a[0], jp["layers"]["mamba"])
    tm = tp["layers"][0]["mamba"]
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, S + 3, jcfg.d_model)).astype(np.float32)
    jy, jconv, jssm = JSSM.mamba_apply_with_state(jm, jcfg,
                                                  jnp.asarray(x[:, :S]))
    ty, tconv, tssm = SSM.mamba_apply_with_state(tm, tcfg,
                                                 torch.from_numpy(x[:, :S]))
    _close(ty, jy)
    _close(tconv, jconv)
    _close(tssm, jssm)
    assert tconv.shape == (2, tcfg.ssm.conv_width - 1,
                           tcfg.d_inner + 2 * tcfg.ssm.state_dim)
    _close(SSM.mamba_apply(tm, tcfg, torch.from_numpy(x[:, :S])), jy)
    for s in range(S, S + 3):
        jy, jconv, jssm = JSSM.mamba_decode_step(
            jm, jcfg, jnp.asarray(x[:, s:s + 1]), jconv, jssm)
        ty, tconv, tssm = SSM.mamba_decode_step(
            tm, tcfg, torch.from_numpy(x[:, s:s + 1]), tconv, tssm)
        _close(ty, jy)
        _close(tconv, jconv)
        _close(tssm, jssm)


def test_prefill_and_decode_logits_and_caches(pair):
    """(c) prefill + 4 decode steps: logits, and every cache tensor (conv,
    ssm, and the hybrid's ak/av), equal to the reference's."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 37)).astype(np.int32)
    jc = JM.init_cache(jcfg, 2, 48)
    tc = M.init_cache(tcfg, 2, 48)
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = M.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl)
    for _ in range(4):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = M.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
        _close(tl, jl)
    for k in jc:
        _close(tc[k], jc[k])
    assert tc["ssm"].dtype == torch.float32


def test_init_params_shapes_and_dtypes_match_reference(pair):
    """The port's own init draws the reference's tree, shapes and leaf
    dtypes (the numbers differ: torch and JAX generators)."""
    jcfg, _, tcfg, _ = pair
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, torch.bfloat16)
    own = M.init_params(tcfg, torch.Generator().manual_seed(0),
                        torch.bfloat16)

    def flat(p, prefix=""):
        if isinstance(p, torch.Tensor):
            return {prefix: (tuple(p.shape), p.dtype)}
        items = p.items() if isinstance(p, dict) else enumerate(p)
        out = {}
        for k, v in items:
            out.update(flat(v, f"{prefix}/{k}"))
        return out

    assert flat(own) == flat(tp)
    assert M.param_count(own) == M.param_count(tp)
    assert ("shared_attn" in own) == (tcfg.family == "hybrid")


def test_bf16_conversion_keeps_float32_mamba_leaves():
    """(h) bf16 weights: A_log, D and dt_bias stay float32 and equal to the
    reference's; the other leaves are bfloat16."""
    cfg = jax_config("mamba2-130m").reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = from_jax_params(jax.tree.map(np.asarray, jp),
                         get_config("mamba2-130m").reduced(), torch.bfloat16)
    for i, layer in enumerate(tp["layers"]):
        mp = layer["mamba"]
        for leaf in ("A_log", "D", "dt_bias"):
            want = np.asarray(jp["layers"]["mamba"][leaf][i])
            assert want.dtype == np.float32
            assert mp[leaf].dtype == torch.float32
            np.testing.assert_array_equal(mp[leaf].numpy(), want)
        assert mp["zx_proj"]["w"].dtype == torch.bfloat16
        assert mp["conv_w"].dtype == torch.bfloat16
    assert tp["embed"]["emb"].dtype == torch.bfloat16


# ------------------------------------------------------------ serving
@pytest.fixture(scope="module", params=ARCHS)
def engines(request):
    jcfg = jax_config(request.param).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = get_config(request.param).reduced()
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    return (JaxEngine(jcfg, jp, max_len=96),
            InferenceEngine(tcfg, tp, max_len=96, device="cpu"))


def test_engine_greedy_matches_jax_over_16_steps(engines):
    """(d)"""
    jeng, teng = engines
    rng = np.random.default_rng(6)
    toks = rng.integers(0, teng.cfg.vocab_size, size=(2, 11)).astype(np.int32)
    want = jeng.generate({"tokens": jnp.asarray(toks)}, 16).tokens
    got = teng.generate({"tokens": torch.from_numpy(toks)}, 16)
    assert got.tokens.shape == (2, 16) and got.steps == 16
    np.testing.assert_array_equal(got.tokens, want)


@pytest.mark.parametrize("slots", [1, 2])
def test_dense_batcher_matches_solo_and_jax(engines, slots):
    """(e) The conv/ssm (and ak/av) lanes splice at axis 1: batched tokens
    equal solo generation, and the JAX batcher's."""
    jeng, teng = engines
    prompts = [np.arange(6 + 3 * i) % teng.cfg.vocab_size for i in range(3)]

    def run(cb, mk):
        reqs = [mk(i, p, 4) for i, p in enumerate(prompts)]
        for r in reqs:
            cb.submit(r)
        cb.run()
        assert all(r.done for r in reqs)
        return [list(r.out_tokens) for r in reqs]

    got = run(ContinuousBatcher(teng, slots=slots), Request)
    assert got == run(JaxBatcher(jeng, slots=slots), JaxRequest)
    for toks, p in zip(got, prompts):
        solo = teng.generate({"tokens": p.astype(np.int32)[None]}, 4)
        assert toks == list(solo.tokens[0])


@pytest.mark.parametrize("policy", ["threshold", "capacity_aware"])
@pytest.mark.parametrize("batched", [False, True])
def test_router_fleet_report_matches_jax(policy, batched):
    """(f) reduced mamba2-130m behind both routers: same pools, bookings and
    tokens, on the engine-only path and through dense batchers."""
    jcfg = jax_config("mamba2-130m").reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = get_config("mamba2-130m").reduced()
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    jeng = JaxEngine(jcfg, jp, max_len=96)
    teng = InferenceEngine(tcfg, tp, max_len=96, device="cpu")
    prompts = [np.arange(m) % tcfg.vocab_size for m in (6, 64, 6, 64)]
    routers = []
    for Router, fleet, eng in ((JaxRouter, jax_paper_fleet, jeng),
                               (FleetRouter, paper_fleet, teng)):
        eff, perf = fleet()
        r = Router(eng.cfg, {"eff": eff, "perf": perf},
                   {"eff": eng, "perf": eng}, policy=policy, t_in=32,
                   counts={eff.name: 4, perf.name: 1})
        if batched:
            r.attach_batchers(slots=2)
        routed = [r.submit(p, 4) for p in prompts]
        if batched:
            r.drain()
        routers.append((r, routed))
    (jr, jrouted), (tr, trouted) = routers
    assert tr.fleet_report() == jr.fleet_report()
    for a, b in zip(jrouted, trouted):
        assert (a.pool, a.energy_j, a.runtime_s) == (b.pool, b.energy_j,
                                                      b.runtime_s)
        ta = a.request.out_tokens if batched else list(a.output)
        tb = b.request.out_tokens if batched else list(b.output)
        assert ta == tb


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_cache_refused_as_in_reference(arch):
    """(g) SSM and hybrid lanes are not pageable: init_paged_cache and
    attach_batchers(paged=True) raise the reference's ValueError."""
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    with pytest.raises(ValueError) as jerr:
        JM.init_paged_cache(jcfg, 2, 6, 8)
    with pytest.raises(ValueError) as terr:
        M.init_paged_cache(tcfg, 2, 6, 8)
    assert str(terr.value) == str(jerr.value)
    params = M.init_params(tcfg, torch.Generator().manual_seed(0))
    eng = InferenceEngine(tcfg, params, max_len=32, device="cpu")
    eff, perf = paper_fleet()
    router = FleetRouter(tcfg, {"eff": eff, "perf": perf},
                         {"eff": eng, "perf": eng})
    with pytest.raises(ValueError, match="paged KV cache supports"):
        router.attach_batchers(paged=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_entry_point_on_the_host(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--device", "cpu", "--requests", "3", "--max-new-tokens", "3",
         "--fleet", "paper"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("req") == 3 and "fleet report" in out.stdout

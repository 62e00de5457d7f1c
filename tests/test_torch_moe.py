"""The port's MoE family against the JAX package on the same weights.

``moe_apply`` is held to the JAX function (output and Switch aux loss)
under capacity dispatch, dropless dispatch and, with
``REPRO_MOE_DISPATCH=grouped`` set for both packages at T = 4096, grouped
dispatch; the drop cases of tests/test_moe.py run on the port. Reduced
phi3.5-moe and grok-1 (weights from ``repro.models.model.init_params``
through numpy) give the JAX package's logits for the dense and the paged
step functions, and its greedy tokens through the engine, both batchers
and FleetRouter, with ``fleet_report()`` equal; phi3.5-moe with an int8
KV cache does so under both int8 read paths. Float32 atol/rtol 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.systems import paper_fleet as jax_paper_fleet
from repro.kernels import autotune as JAT
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.serving.batching import ContinuousBatcher as JaxDense
from repro.serving.batching import PagedContinuousBatcher as JaxPaged
from repro.serving.batching import Request as JaxRequest
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.router import FleetRouter as JaxRouter
from repro_torch.configs import get_config
from repro_torch.core.systems import paper_fleet
from repro_torch.kernels import autotune as AT
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.batching import (ContinuousBatcher,
                                          PagedContinuousBatcher, Request)
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.router import FleetRouter

TOL = 1e-4
ARCHS = ["phi3.5-moe-42b-a6.6b", "grok-1-314b"]
PHI = ARCHS[0]


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=TOL,
                               rtol=TOL)


def _moe_pair(arch, **moe_changes):
    """(jax cfg, torch cfg, jax moe params, torch moe params)."""
    jcfg = jax_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    if moe_changes:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, **moe_changes))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, **moe_changes))
    jp = JMOE.moe_init(jax.random.PRNGKey(11), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


def _run_both(jcfg, tcfg, jp, tp, x, **kw):
    jy, jaux = JMOE.moe_apply(jp, jcfg, jnp.asarray(x), **kw)
    ty, taux = MOE.moe_apply(tp, tcfg, torch.from_numpy(x), **kw)
    return (jy, jaux), (ty, taux)


# ----------------------------------------------------------------- moe_apply
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dropless,capacity_factor",
                         [(False, None), (False, 0.5), (True, None)])
def test_moe_apply_matches_jax(arch, dropless, capacity_factor):
    """Capacity dispatch at the reduced config's capacity (which never
    binds), at a capacity that drops tokens, and dropless."""
    changes = {} if capacity_factor is None else \
        {"capacity_factor": capacity_factor}
    jcfg, tcfg, jp, tp = _moe_pair(arch, **changes)
    x = np.random.default_rng(0).normal(
        size=(2, 24, jcfg.d_model)).astype(np.float32)
    (jy, jaux), (ty, taux) = _run_both(jcfg, tcfg, jp, tp, x,
                                       dropless=dropless)
    _close(ty, jy)
    _close(taux, jaux)


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_dispatch_matches_jax(arch, monkeypatch):
    """REPRO_MOE_DISPATCH=grouped at T = 4096 (16 groups of 256 tokens),
    with a capacity that binds per group, in both packages; the global
    dispatch of the same tokens differs (other tokens are dropped)."""
    jcfg, tcfg, jp, tp = _moe_pair(arch, capacity_factor=0.5)
    x = np.random.default_rng(1).normal(
        size=(2, 2048, jcfg.d_model)).astype(np.float32)
    (gy, _), _ = _run_both(jcfg, tcfg, jp, tp, x)
    monkeypatch.setenv("REPRO_MOE_DISPATCH", "grouped")
    (jy, jaux), (ty, taux) = _run_both(jcfg, tcfg, jp, tp, x)
    _close(ty, jy)
    _close(taux, jaux)
    assert not np.allclose(np.asarray(jy), np.asarray(gy), atol=TOL)
    # dropless and T < 4096 keep the global dispatch under the lever
    (jd, _), (td, _) = _run_both(jcfg, tcfg, jp, tp, x[:, :100])
    _close(td, jd)


def _dense_oracle(p, cfg, x):
    """tests/test_moe.py's oracle: a per-token loop in float64, no capacity
    (swiglu experts)."""
    k = cfg.moe.num_experts_per_tok
    xt = x.reshape(-1, x.shape[-1]).astype(np.float64)
    w = {n: np.asarray(p[n], np.float64) for n in ("gate", "up", "down")}
    logits = xt @ np.asarray(p["router"]["w"], np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    out = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        top = np.argsort(-probs[t])[:k]
        for e, wi in zip(top, probs[t, top] / probs[t, top].sum()):
            h = xt[t] @ w["gate"][e]
            h = h / (1 + np.exp(-h)) * (xt[t] @ w["up"][e])
            out[t] += wi * (h @ w["down"][e])
    return out.reshape(x.shape)


def test_moe_matches_dense_oracle_dropless():
    """As tests/test_moe.py: dropless MoE equals a per-token loop."""
    jcfg, tcfg, jp, tp = _moe_pair(PHI)
    x = np.random.default_rng(2).normal(
        size=(2, 6, jcfg.d_model)).astype(np.float32)
    y, _ = MOE.moe_apply(tp, tcfg, torch.from_numpy(x), dropless=True)
    np.testing.assert_allclose(y.numpy(), _dense_oracle(jp, jcfg, x),
                               atol=1e-3)


@pytest.mark.parametrize("case", ["dropless_composition", "capacity_drops"])
def test_moe_drop_cases(case):
    """The drop cases of tests/test_moe.py on the port: dropless output does
    not depend on the batch's other tokens; tokens over capacity contribute
    zero (finite, never larger than the dropless output)."""
    if case == "dropless_composition":
        _, tcfg, _, tp = _moe_pair("grok-1-314b")
        x = torch.from_numpy(np.random.default_rng(3).normal(
            size=(4, 8, tcfg.d_model)).astype(np.float32))
        y_full, _ = MOE.moe_apply(tp, tcfg, x, dropless=True)
        y_half, _ = MOE.moe_apply(tp, tcfg, x[:2], dropless=True)
        torch.testing.assert_close(y_full[:2], y_half, atol=1e-5, rtol=1e-5)
    else:
        _, tcfg, _, tp = _moe_pair(PHI, capacity_factor=0.25)
        x = torch.from_numpy(np.random.default_rng(4).normal(
            size=(2, 16, tcfg.d_model)).astype(np.float32))
        y, _ = MOE.moe_apply(tp, tcfg, x)
        y_free, _ = MOE.moe_apply(tp, tcfg, x, dropless=True)
        assert torch.isfinite(y).all()
        # C = int(0.25 * 32 * 2 / 4) = 4 slots per expert: 16 of 64 kept
        dropped = (y == 0).all(dim=-1).sum().item()
        assert dropped > 0
        assert torch.linalg.norm(y) <= torch.linalg.norm(y_free) * 1.5


def test_moe_init_shapes_match_reference():
    jcfg, tcfg, jp, _ = _moe_pair("grok-1-314b")           # gelu: no gate
    own = MOE.moe_init(torch.Generator().manual_seed(0), tcfg, torch.float32,
                       "cpu")
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes
    assert "gate" not in own


# ------------------------------------------------------------ whole models
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jax_config(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def test_prefill_and_decode_logits(pair):
    """Prefill routes with capacity, decode dropless, in both packages."""
    jcfg, jp, tcfg, tp = pair
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, 13)).astype(np.int32)
    jc = JM.init_cache(jcfg, 2, 40)
    tc = M.init_cache(tcfg, 2, 40)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = M.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl)
    for _ in range(4):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = M.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
        _close(tl, jl)
    _close(tc["k"], jc["k"])


def test_paged_chunk_and_decode_logits(pair):
    """Two lanes of one pool: chunked prefill (dropless), then batched paged
    decode with one lane dead for a step."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(1)
    bs, chunk, lens = 8, 16, (21, 12)
    jc = JM.init_paged_cache(jcfg, 2, 12, bs, max_blocks_per_lane=5)
    tc = M.init_paged_cache(tcfg, 2, 12, bs, max_blocks_per_lane=5)
    tables = np.asarray([[3, 7, 1, 9, 0], [2, 5, 11, 0, 0]], np.int32)
    jc = dict(jc, block_tables=jnp.asarray(tables))
    tc["block_tables"].copy_(torch.from_numpy(tables))
    last = []
    for lane, n in enumerate(lens):
        p = rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
        for s in range(0, n, chunk):
            c = min(chunk, n - s)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :c] = p[s:s + c]
            jl, jc = JM.prefill_paged_chunk(jp, jcfg, jnp.asarray(buf), jc,
                                            lane=lane, n_valid=c)
            tl, tc = M.prefill_paged_chunk(tp, tcfg, torch.from_numpy(buf),
                                           tc, lane=lane, n_valid=c)
            _close(tl, jl)
        last.append(np.asarray(jnp.argmax(jl, -1), np.int32))
    toks = np.concatenate(last)[:, None]
    for step in range(3):
        live = np.asarray([True, step != 1])
        jl, jc = JM.decode_step_paged(jp, jcfg, jnp.asarray(toks), jc,
                                      live=jnp.asarray(live))
        tl, tc = M.decode_step_paged(tp, tcfg, torch.from_numpy(toks), tc,
                                     live=torch.from_numpy(live))
        _close(tl, jl)
        toks = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _close(tc["kp"][:, 1:], jc["kp"][:, 1:])


# ------------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def engines():
    """JAX and torch engines on one set of reduced phi3.5-moe weights."""
    jcfg = jax_config(PHI).reduced()
    tcfg = get_config(PHI).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(7))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    return (JaxEngine(jcfg, jp, max_len=96),
            InferenceEngine(tcfg, tp, max_len=96, device="cpu"))


def _prompts(vocab):
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, size=20)
    return [np.concatenate([base, rng.integers(0, vocab, size=n)])
            for n in (3, 9)] + [rng.integers(0, vocab, size=11)]


def test_engine_greedy_matches_jax(engines):
    jeng, teng = engines
    toks = np.random.default_rng(2).integers(
        0, teng.cfg.vocab_size, size=(2, 9)).astype(np.int32)
    want = jeng.generate({"tokens": jnp.asarray(toks)}, 12).tokens
    got = teng.generate({"tokens": torch.from_numpy(toks)}, 12)
    np.testing.assert_array_equal(got.tokens, want)


@pytest.mark.parametrize("paged", [False, True])
def test_batcher_tokens_match_jax(engines, paged):
    """Each batcher's greedy tokens equal the JAX batcher's; the paged and
    dense batchers agree (the reduced config is dropless)."""
    jeng, teng = engines
    prompts = _prompts(teng.cfg.vocab_size)

    def run(cb, mk):
        reqs = [mk(i, p, 5) for i, p in enumerate(prompts)]
        for r in reqs:
            cb.submit(r)
        cb.run()
        assert all(r.done for r in reqs)
        return [list(r.out_tokens) for r in reqs]

    if paged:
        kw = dict(slots=2, num_blocks=32, block_size=8, chunk=8)
        got = run(PagedContinuousBatcher(teng, **kw), Request)
        assert got == run(JaxPaged(jeng, **kw), JaxRequest)
        assert got == run(ContinuousBatcher(teng, slots=2), Request)
    else:
        got = run(ContinuousBatcher(teng, slots=2), Request)
        assert got == run(JaxDense(jeng, slots=2), JaxRequest)


@pytest.mark.parametrize("policy", ["threshold", "capacity_aware"])
@pytest.mark.parametrize("paged", [False, True])
def test_router_fleet_report_matches_jax(engines, policy, paged):
    jeng, teng = engines
    prompts = [np.arange(m) % teng.cfg.vocab_size for m in (6, 40, 6)]
    routers = []
    for Router, fleet, eng in ((JaxRouter, jax_paper_fleet, jeng),
                               (FleetRouter, paper_fleet, teng)):
        eff, perf = fleet()
        r = Router(eng.cfg, {"eff": eff, "perf": perf},
                   {"eff": eng, "perf": eng}, policy=policy, t_in=32,
                   counts={eff.name: 4, perf.name: 1})
        if paged:
            r.attach_batchers(slots=2, paged=True, num_blocks=32,
                              block_size=16)
        routed = [r.submit(p, 4) for p in prompts]
        if paged:
            r.drain()
        routers.append((r, routed))
    (jr, jrouted), (tr, trouted) = routers
    assert tr.fleet_report() == jr.fleet_report()
    for a, b in zip(jrouted, trouted):
        assert (a.pool, a.energy_j, a.runtime_s) == (b.pool, b.energy_j,
                                                      b.runtime_s)
        ta = a.request.out_tokens if paged else list(a.output)
        tb = b.request.out_tokens if paged else list(b.output)
        assert ta == tb


# ------------------------------------------------------------- int8 KV cache
@pytest.fixture
def _no_installed_cache():
    AT.install(None)
    JAT.install(None)
    yield
    AT.install(None)
    JAT.install(None)


def test_int8_dense_logits_match_jax(engines):
    """As tests/test_kv_quant.py:30: phi3.5-moe with an int8 dense cache.
    Prefill logits match (attention runs on the fresh K/V). Each decode step
    starts from the JAX package's int8 cache and matches its logits; the
    int8 entries each package writes differ by at most one rounding step (a
    value at a half-way point moved by float noise: one of 8,192 entries in
    this prefill). The port's int8 decode stays within the JAX test's 5% of
    its float32 cache's logits."""
    jeng, teng = engines
    jcfg, tcfg = jeng.cfg, teng.cfg
    toks = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, size=(2, 19)).astype(np.int32)
    jc = JM.init_cache(jcfg, 2, 64, kv_quant=True)
    tc = M.init_cache(tcfg, 2, 64, kv_quant=True)
    fc = M.init_cache(tcfg, 2, 64)
    jl, jc = JM.prefill(jeng.params, jcfg,
                        {"tokens": jnp.asarray(toks[:, :16])}, jc)
    tl, tc = M.prefill(teng.params, tcfg,
                       {"tokens": torch.from_numpy(toks[:, :16])}, tc)
    fl, fc = M.prefill(teng.params, tcfg,
                       {"tokens": torch.from_numpy(toks[:, :16])}, fc)
    _close(tl, jl)
    for t in range(3):
        for name in ("k", "v"):
            d = np.abs(tc[name].numpy().astype(np.int32)
                       - np.asarray(jc[name]).astype(np.int32))
            assert d.max() <= 1, name
            tc[name].copy_(torch.from_numpy(np.array(jc[name])))
        for name in ("k_scale", "v_scale"):
            _close(tc[name], jc[name])
            tc[name].copy_(torch.from_numpy(np.array(jc[name])))
        nxt = toks[:, 16 + t:17 + t]
        jl, jc = JM.decode_step(jeng.params, jcfg, jnp.asarray(nxt), jc)
        tl, tc = M.decode_step(teng.params, tcfg, torch.from_numpy(nxt), tc)
        fl, fc = M.decode_step(teng.params, tcfg, torch.from_numpy(nxt), fc)
        _close(tl, jl)
        rel = float((tl - fl).abs().max() / fl.abs().max())
        assert rel < 0.05, rel


@pytest.mark.parametrize("impl", ["gather", "fused"])
def test_int8_paged_batcher_matches_jax(engines, impl, _no_installed_cache,
                                        monkeypatch):
    """phi3.5-moe's int8 paged batcher gives the JAX package's tokens under
    each int8 read path (``fused`` routed by an installed autotune cache in
    each package, and taken: a spy counts the port's fused reads)."""
    from repro_torch.kernels import ops
    fused = []
    orig = ops._ref.paged_decode_attention_quant_fused
    monkeypatch.setattr(ops._ref, "paged_decode_attention_quant_fused",
                        lambda *a, **k: fused.append(1) or orig(*a, **k))
    jeng, teng = engines
    jq = JaxEngine(jeng.cfg, jeng.params, max_len=96, kv_quant=True)
    tq = InferenceEngine(teng.cfg, teng.params, max_len=96, device="cpu",
                         kv_quant=True)
    if impl == "fused":
        bucket = AT.shape_bucket("paged_decode_quant", b=2, c=96)
        kw = dict(kernel="paged_decode_quant", backend="ref", bucket=bucket,
                  params={"impl": "fused"}, t_s=1.0, t_default_s=1.0,
                  noise_frac=0.0, flops=0.0, bytes=0.0, ctx=0.0)
        AT.install(AT.AutotuneCache("test", "ref",
                                    entries=[AT.TunedEntry(**kw)]))
        JAT.install(JAT.AutotuneCache("test", "ref",
                                      entries=[JAT.TunedEntry(**kw)]))
    prompts = _prompts(teng.cfg.vocab_size)
    outs = []
    for cb, mk in ((PagedContinuousBatcher(tq, slots=2, num_blocks=32,
                                           block_size=8, chunk=8), Request),
                   (JaxPaged(jq, slots=2, num_blocks=32, block_size=8,
                             chunk=8), JaxRequest)):
        reqs = [mk(i, p, 5) for i, p in enumerate(prompts)]
        for r in reqs:
            cb.submit(r)
        cb.run()
        outs.append([list(r.out_tokens) for r in reqs])
    assert outs[0] == outs[1]
    assert (len(fused) > 0) == (impl == "fused")

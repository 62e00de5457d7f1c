"""The port's int8 KV cache against the JAX package.

Quantization is bit for bit the reference's (int8 values and float32
scales, half-way ties to even). The int8 read references and K4's plain
version are held to the JAX references and to the Pallas K4 kernel in
interpret mode (float32 3e-5, the gather-vs-fused tolerance of
tests/test_autotune.py; bfloat16 2e-2). Whole models with ``kv_quant``
(reduced smollm-360m and mistral-7b, weights from the JAX init through
numpy) give logits within 1e-4 of the JAX package's, dense and paged, and
the serving path gives the JAX package's greedy tokens and fleet report,
under both int8 read paths (``gather``, and ``fused`` routed by an
installed autotune cache in each package).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.systems import paper_fleet as jax_paper_fleet
from repro.kernels import autotune as JAT
from repro.kernels import ops as JOPS
from repro.kernels import ref as jref
from repro.kernels.decode_attention import \
    paged_decode_attention_int8 as pallas_int8
from repro.models import attention as JATT
from repro.models import model as JM
from repro.serving.batching import ContinuousBatcher as JaxDense
from repro.serving.batching import PagedContinuousBatcher as JaxPaged
from repro.serving.batching import Request as JaxRequest
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.router import FleetRouter as JaxRouter
from repro_torch.configs import get_config
from repro_torch.core.systems import paper_fleet
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as ATT
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.batching import (ContinuousBatcher,
                                          PagedContinuousBatcher, Request)
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.router import FleetRouter

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODEL_TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_installed_cache():
    """Every test starts and ends with no autotune cache in either package."""
    AT.install(None)
    JAT.install(None)
    yield
    AT.install(None)
    JAT.install(None)


def _install_fused(bucket: str, monkeypatch) -> dict:
    """Route the int8 paged read of ``bucket`` to ``fused`` on the plain
    path of both packages; returns the calls of each package's fused read
    (counted by spies), so a test can show the route was taken."""
    kw = dict(kernel="paged_decode_quant", backend="ref", bucket=bucket,
              params={"impl": "fused"}, t_s=1.0, t_default_s=1.0,
              noise_frac=0.0, flops=0.0, bytes=0.0, ctx=0.0)
    AT.install(AT.AutotuneCache("test", "ref", entries=[AT.TunedEntry(**kw)]))
    JAT.install(JAT.AutotuneCache("test", "ref",
                                  entries=[JAT.TunedEntry(**kw)]))
    calls = {"torch": 0, "jax": 0}
    for name, mod in (("torch", ops._ref), ("jax", JOPS._ref)):
        orig = mod.paged_decode_attention_quant_fused

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, "paged_decode_attention_quant_fused", spy)
    return calls


# ------------------------------------------------------------ quantization
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 4, 32, 64)) * 3.0).astype(np.float32)
    x[0, 1, 5] = 0.0                                   # a zero row
    x[1, 2, 7, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    x[1, 2, 7, 8:] = 0.0                               # scale exactly 1: ties
    xj = jnp.asarray(x, JDT[dtype])
    xt = torch.from_numpy(x).to(TDT[dtype])
    qj, sj = JATT.quantize_kv(xj)
    qt, st = ATT.quantize_kv(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert st.shape == (2, 4, 32, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # half-way values round to even, as jnp.round does
    np.testing.assert_array_equal(qt[1, 2, 7, :8].numpy(),
                                  [127, 0, 2, 2, 0, -2, -2, 4])
    assert torch.all(qt[0, 1, 5] == 0) and torch.isfinite(st).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_kv_matches_jax(dtype):
    rng = np.random.default_rng(1)
    q8 = rng.integers(-127, 128, size=(3, 2, 16, 64)).astype(np.int8)
    sc = rng.uniform(0.005, 0.02, size=(3, 2, 16, 1)).astype(np.float32)
    want = JATT.dequantize_kv(jnp.asarray(q8), jnp.asarray(sc), JDT[dtype])
    got = ATT.dequantize_kv(torch.from_numpy(q8), torch.from_numpy(sc),
                            TDT[dtype])
    assert got.dtype == TDT[dtype]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        ref.dequantize_kv(torch.from_numpy(q8), torch.from_numpy(sc)).numpy(),
        np.asarray(jref.dequantize_kv(jnp.asarray(q8), jnp.asarray(sc))))


# ------------------------------------------------------- int8 read (K4)
def _quant_inputs(seed, dtype, B=2, Hq=4, Hkv=2, D=64, bs=16, mb=8):
    """Pools in shuffled blocks (block 0, the null block, in no table), and
    ragged kv_len; every lane has valid keys."""
    rng = np.random.default_rng(seed)
    nb = 1 + B * mb
    q = rng.normal(size=(B, Hq, 1, D)).astype(np.float32)
    kp = rng.integers(-127, 128, (nb, Hkv, bs, D)).astype(np.int8)
    vp = rng.integers(-127, 128, (nb, Hkv, bs, D)).astype(np.int8)
    ks = rng.uniform(.005, .02, (nb, Hkv, bs, 1)).astype(np.float32)
    vs = rng.uniform(.005, .02, (nb, Hkv, bs, 1)).astype(np.float32)
    tables = (rng.permutation(B * mb) + 1).reshape(B, mb).astype(np.int32)
    kv_len = np.asarray([bs * mb - (37 * i) % 101 for i in range(B)],
                        np.int32)
    arrays = (q, kp, vp, ks, vs, tables, kv_len)
    jx = [jnp.asarray(q, JDT[dtype])] + [jnp.asarray(a) for a in arrays[1:]]
    tx = [torch.from_numpy(q).to(TDT[dtype])] + \
        [torch.from_numpy(a) for a in arrays[1:]]
    return jx, tx


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap,window", [(None, None), (30.0, None),
                                            (None, 48), (20.0, 48)])
def test_int8_references_match_jax_and_pallas(dtype, softcap, window):
    (qj, kpj, vpj, ksj, vsj, tj, lj), tx = _quant_inputs(7, dtype)
    kw = dict(softcap=softcap, window=window)
    tol = TOL[dtype]
    gather = ref.paged_decode_attention_quant(*tx[:6], kv_len=tx[6], **kw)
    fused = ref.paged_decode_attention_quant_fused(*tx[:6], kv_len=tx[6],
                                                   **kw)
    assert gather.dtype == fused.dtype == TDT[dtype]
    _close(gather, jref.paged_decode_attention_quant(
        qj, kpj, vpj, ksj, vsj, tj, kv_len=lj, **kw), tol)
    _close(fused, jref.paged_decode_attention_quant_fused(
        qj, kpj, vpj, ksj, vsj, tj, kv_len=lj, **kw), tol)
    # K4's plain version is the TPU kernel's function
    _close(fused, pallas_int8(qj, kpj, vpj, ksj, vsj, tj, lj, interpret=True,
                              **kw), tol)
    # the wrapper on CPU tensors is its plain version, and fused ~ gather
    assert torch.equal(DA.paged_decode_attention_int8(*tx, **kw), fused)
    torch.testing.assert_close(fused.float(), gather.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 1), (71, 1)])
def test_int8_reads_match_jax_across_groupings(Hq, Hkv):
    """K4's plain version and the gather read at llama2-7b's MHA (G = 1),
    reduced falcon-7b's MQA (4 heads on one KV head) and full falcon-7b's
    (71 on one), D = 64, with a window, against the JAX package and the
    Pallas kernel (interpret mode)."""
    (qj, kpj, vpj, ksj, vsj, tj, lj), tx = _quant_inputs(11, "float32",
                                                         Hq=Hq, Hkv=Hkv)
    kw = dict(window=48)
    fused = ref.paged_decode_attention_quant_fused(*tx[:6], kv_len=tx[6],
                                                   **kw)
    gather = ref.paged_decode_attention_quant(*tx[:6], kv_len=tx[6], **kw)
    tol = TOL["float32"]
    _close(fused, jref.paged_decode_attention_quant_fused(
        qj, kpj, vpj, ksj, vsj, tj, kv_len=lj, **kw), tol)
    _close(fused, pallas_int8(qj, kpj, vpj, ksj, vsj, tj, lj, interpret=True,
                              **kw), tol)
    _close(gather, jref.paged_decode_attention_quant(
        qj, kpj, vpj, ksj, vsj, tj, kv_len=lj, **kw), tol)


def test_int8_wrapper_on_cpu_launches_nothing():
    _, tx = _quant_inputs(3, "float32")
    before = DA.paged_decode_attention_int8.launches
    DA.paged_decode_attention_int8(*tx)
    ops.paged_decode_attention_quant(*tx, impl="fused")
    assert DA.paged_decode_attention_int8.launches == before


# ------------------------------------------------------------ whole models
# llama2-7b holds the int8 reads at G = 1 (MQA: the groupings test above)
@pytest.fixture(scope="module", params=["smollm-360m", "mistral-7b",
                                        "llama2-7b"])
def pair(request):
    jcfg = jax_config(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def _mclose(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=MODEL_TOL,
                               rtol=MODEL_TOL)


def test_int8_dense_logits_match_jax(pair):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 13)).astype(np.int32)
    jc = JM.init_cache(jcfg, 2, 40, kv_quant=True)
    tc = M.init_cache(tcfg, 2, 40, kv_quant=True)
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].shape == \
        tuple(jc["k_scale"].shape)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = M.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tc)
    _mclose(tl, jl)
    for _ in range(4):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = M.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
        _mclose(tl, jl)
    _mclose(tc["k_scale"], jc["k_scale"])
    _mclose(tc["v_scale"], jc["v_scale"])
    # int8 rows agree up to a rounding step at a half-way boundary
    diff = np.abs(tc["k"].numpy().astype(np.int32)
                  - np.asarray(jc["k"]).astype(np.int32))
    assert diff.max() <= 1


@pytest.mark.parametrize("impl", ["gather", "fused"])
def test_int8_paged_logits_match_jax(pair, impl, monkeypatch):
    """Two lanes of one int8 pool: chunked prefill, then batched paged decode
    with one lane dead for a step, under each read path."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(1)
    bs, chunk, lens = 8, 16, (21, 12)
    jc = JM.init_paged_cache(jcfg, 2, 12, bs, max_blocks_per_lane=5,
                             kv_quant=True)
    tc = M.init_paged_cache(tcfg, 2, 12, bs, max_blocks_per_lane=5,
                            kv_quant=True)
    assert tc["kp"].dtype == torch.int8 and "vp_scale" in tc
    calls = None
    if impl == "fused":
        calls = _install_fused(
            AT.shape_bucket("paged_decode_quant", b=2, c=5 * bs), monkeypatch)
    tables = np.asarray([[3, 7, 1, 9, 0], [2, 5, 11, 0, 0]], np.int32)
    jc = dict(jc, block_tables=jnp.asarray(tables))
    tc["block_tables"].copy_(torch.from_numpy(tables))
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    last = []
    for lane, p in enumerate(prompts):
        for s in range(0, len(p), chunk):
            c = min(chunk, len(p) - s)
            buf = np.zeros((1, chunk), np.int32)
            buf[0, :c] = p[s:s + c]
            jl, jc = JM.prefill_paged_chunk(jp, jcfg, jnp.asarray(buf), jc,
                                            lane=lane, n_valid=c)
            tl, tc = M.prefill_paged_chunk(tp, tcfg, torch.from_numpy(buf),
                                           tc, lane=lane, n_valid=c)
            _mclose(tl, jl)
        last.append(np.asarray(jnp.argmax(jl, -1), np.int32))
    toks = np.concatenate(last)[:, None]
    for step in range(3):
        live = np.asarray([True, step != 1])
        jl, jc = JM.decode_step_paged(jp, jcfg, jnp.asarray(toks), jc,
                                      live=jnp.asarray(live))
        tl, tc = M.decode_step_paged(tp, tcfg, torch.from_numpy(toks), tc,
                                     live=torch.from_numpy(live))
        _mclose(tl, jl)
        toks = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _mclose(tc["kp_scale"][:, 1:], jc["kp_scale"][:, 1:])
    if calls is not None:
        # torch: one fused read per layer and decode step; JAX traces its
        # layer scan's body once per step
        assert calls == {"torch": 3 * tcfg.num_layers, "jax": 3}


# ------------------------------------------------------------------ serving
ARCH = "smollm-360m"


@pytest.fixture(scope="module")
def engines():
    """The JAX and torch kv_quant engines on one set of weights (reduced
    smollm-360m, PRNGKey(7), as tests/test_serving.py)."""
    jcfg = jax_config(ARCH).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(7))
    tp = from_jax_params(jax.tree.map(np.asarray, jp),
                         get_config(ARCH).reduced())
    return (JaxEngine(jcfg, jp, max_len=96, kv_quant=True),
            InferenceEngine(get_config(ARCH).reduced(), tp, max_len=96,
                            device="cpu", kv_quant=True))


def test_int8_engine_greedy_matches_jax(engines):
    jeng, teng = engines
    toks = np.random.default_rng(1).integers(
        0, teng.cfg.vocab_size, size=(2, 9)).astype(np.int32)
    want = jeng.generate({"tokens": jnp.asarray(toks)}, 16).tokens
    got = teng.generate({"tokens": torch.from_numpy(toks)}, 16)
    np.testing.assert_array_equal(got.tokens, want)


@pytest.mark.parametrize("slots", [1, 2])
def test_int8_dense_batcher_lane_ops_carry_scales(engines, slots):
    """_splice_lane carries the int8 cache's scale tensors: batched
    generation over a kv_quant cache equals the solo quant engine and the
    JAX dense batcher (the port's analogue of tests/test_serving.py's
    kv_quant lane-ops test)."""
    jeng, teng = engines
    cache = teng.new_cache(2)
    assert cache["k"].dtype == torch.int8 and "v_scale" in cache
    prompts = [np.arange(5 + 2 * i) % teng.cfg.vocab_size for i in range(3)]
    outs = {}
    for name, Batcher, Req, eng in (("torch", ContinuousBatcher, Request, teng),
                                    ("jax", JaxDense, JaxRequest, jeng)):
        reqs = [Req(i, p, max_new_tokens=5) for i, p in enumerate(prompts)]
        cb = Batcher(eng, slots=slots)
        for r in reqs:
            cb.submit(r)
        cb.run()
        assert all(r.done for r in reqs)
        outs[name] = [list(r.out_tokens[:5]) for r in reqs]
    assert outs["torch"] == outs["jax"]
    for got, p in zip(outs["torch"], prompts):
        solo = teng.generate({"tokens": np.asarray(p, np.int32)[None]}, 5)
        assert got == list(solo.tokens[0])


def _shared_prefix_prompts(vocab):
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, size=40)
    out = [np.concatenate([base, rng.integers(0, vocab, size=n)])
           for n in (3, 9, 17)]
    return out + [rng.integers(0, vocab, size=11)]


@pytest.mark.parametrize("impl", ["gather", "fused"])
def test_int8_paged_batcher_matches_jax(engines, impl, monkeypatch):
    """Greedy tokens of the int8 paged batcher equal the JAX paged
    batcher's under each read path, with prefix-block reuse."""
    jeng, teng = engines
    if impl == "fused":
        # a fresh JAX engine: its jitted steps resolve impl when traced
        jeng = JaxEngine(jeng.cfg, jeng.params, max_len=96, kv_quant=True)
    prompts = _shared_prefix_prompts(teng.cfg.vocab_size)

    def run(cb, mk):
        reqs = [mk(i, p, 6) for i, p in enumerate(prompts)]
        for r in reqs:
            cb.submit(r)
        cb.run()
        assert all(r.done for r in reqs)
        return [list(r.out_tokens) for r in reqs]

    tcb = PagedContinuousBatcher(teng, slots=2, num_blocks=32, block_size=8,
                                 chunk=16)
    jcb = JaxPaged(jeng, slots=2, num_blocks=32, block_size=8, chunk=16)
    assert tcb.cache["kp"].dtype == torch.int8 and "kp_scale" in tcb.cache
    calls = None
    if impl == "fused":
        mb = tcb.cache["block_tables"].shape[1]
        assert mb == jcb.cache["block_tables"].shape[1]
        calls = _install_fused(
            AT.shape_bucket("paged_decode_quant", b=2, c=mb * 8), monkeypatch)
    got = run(tcb, Request)
    assert got == run(jcb, JaxRequest)
    assert tcb.stats() == jcb.stats() and tcb.stats()["prefix_hits"] > 0
    if calls is not None:
        assert calls["torch"] > 0 and calls["jax"] > 0


@pytest.mark.parametrize("paged", [False, True])
def test_int8_fleet_report_matches_jax(engines, paged):
    jeng, teng = engines
    prompts = [np.arange(m) % teng.cfg.vocab_size for m in (6, 64, 6, 64)]
    routers = []
    for Router, fleet, eng in ((JaxRouter, jax_paper_fleet, jeng),
                               (FleetRouter, paper_fleet, teng)):
        eff, perf = fleet()
        r = Router(eng.cfg, {"eff": eff, "perf": perf},
                   {"eff": eng, "perf": eng}, policy="capacity_aware",
                   t_in=32, counts={eff.name: 4, perf.name: 1})
        if paged:
            r.attach_batchers(slots=2, paged=True, num_blocks=32,
                              block_size=16)
        routed = [r.submit(p, 4) for p in prompts]
        r.drain() if paged else None
        routers.append((r, routed))
    (jr, jrouted), (tr, trouted) = routers
    assert tr.fleet_report() == jr.fleet_report()
    for a, b in zip(jrouted, trouted):
        ta = a.request.out_tokens if paged else list(a.output)
        tb = b.request.out_tokens if paged else list(b.output)
        assert ta == tb


def test_int8_kernel_source_is_in_the_lazy_build():
    """K4 is the split kernel of csrc/decode_attention.cu with int8 rows
    (K2's and K3's kernel and combine), and names the TPU kernel it
    replaces; the shared-memory int8 tile kernel is gone; its C entry point
    has a ctypes signature with the workspace; importing its wrapper builds
    nothing."""
    from repro_torch.kernels import _build
    assert _build._lib is None
    text = (_build.CSRC_DIR / "decode_attention.cu").read_text()
    assert "_paged_decode_int8_kernel" in text
    assert 'extern "C" int repro_paged_decode_attention_int8(' in text
    assert "launch_split<T, int8_t, D, true>" in text
    assert "decode_kernel(" not in text and "launch_decode_int8" not in text
    assert "load_tile_int8" not in (_build.CSRC_DIR /
                                    "attention_common.cuh").read_text()
    # dtype, head dim, 9 pointers (q, pools, scale pools, tables, kv_len,
    # workspace, out), 6 ints, softcap, scale, block_k, stream
    assert len(_build._SIGNATURES["repro_paged_decode_attention_int8"]) == 21

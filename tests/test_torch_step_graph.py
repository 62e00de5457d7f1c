"""The serve steps as the engine replays them (``serving/step_graph.py`` and
``InferenceEngine(..., graphs=True)``), on the CPU. Here the runner stages
its static buffers, keys, ``clone()`` and counters around an eager call of
the step, so everything but the capture itself is covered; the card's
tests (``tests/test_torch_gpu.py``) hold the captures.

* ``prefill_paged_chunk`` with 0-d int32 tensors for ``lane`` and
  ``n_valid`` against the JAX package's (jitted, its lane and count traced
  as arrays), float and int8 pools, every valid count of a chunk, logits
  within 1e-4 (XLA and torch sum in different orders);
* the engine with ``graphs=True`` against ``graphs=False``, bit for bit in
  logits and tokens: ``decode`` and ``generate`` for one arch of each
  family, both batchers, ``FleetRouter`` with paged batchers and the
  disaggregated policy, with identical ``fleet_report()``;
* the runner's keys (a new cache, batch or tuning makes a new entry, the
  same call none) and its counters (each replay adds what the capture
  counted).
"""
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.core.pricing import CostModel, CostParams
from repro_torch.core.systems import SystemProfile, paper_fleet
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ssm_scan as SS
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params
from repro_torch.serving import step_graph as SGR
from repro_torch.serving.batching import (ContinuousBatcher,
                                          PagedContinuousBatcher, Request)
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.router import FleetRouter

from _torch_handoff import probe_pair

TOL = 1e-4
CHUNK = 8
FAMILIES = {"dense": "smollm-360m", "moe": "phi3.5-moe-42b-a6.6b",
            "vlm": "qwen2-vl-7b", "ssm": "mamba2-130m",
            "hybrid": "zamba2-1.2b", "audio": "whisper-base"}


# --------------------------------------------------- the chunk against JAX
@functools.lru_cache(maxsize=None)
def _chunk_pair(arch):
    jcfg = jax_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    step = jax.jit(functools.partial(JM.prefill_paged_chunk, cfg=jcfg))
    return jcfg, jp, tcfg, tp, step


@pytest.mark.parametrize("n_valid", range(1, CHUNK + 1))
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("arch", ["smollm-360m", "phi3.5-moe-42b-a6.6b"])
def test_chunk_with_tensor_lane_and_count_matches_jax(arch, quant, n_valid):
    """Lane 1 of a two-lane pool: a full chunk, then one of ``n_valid``
    rows (the rest padding, written to the null block), both given as 0-d
    int32 tensors; the logits of each chunk's last valid row, ``pos`` and
    the lane's K/V as JAX's."""
    jcfg, jp, tcfg, tp, jstep = _chunk_pair(arch)
    bs = 4
    jc = JM.init_paged_cache(jcfg, 2, 12, bs, max_blocks_per_lane=5,
                             kv_quant=quant)
    tc = M.init_paged_cache(tcfg, 2, 12, bs, max_blocks_per_lane=5,
                            kv_quant=quant)
    tables = np.asarray([[3, 7, 0, 0, 0], [2, 5, 11, 9, 0]], np.int32)
    jc = dict(jc, block_tables=jnp.asarray(tables))
    tc["block_tables"].copy_(torch.from_numpy(tables))
    rng = np.random.default_rng(n_valid)
    prompt = rng.integers(0, jcfg.vocab_size, size=CHUNK + n_valid)
    lane = torch.tensor(1, dtype=torch.int32)
    for s, c in ((0, CHUNK), (CHUNK, n_valid)):
        buf = np.zeros((1, CHUNK), np.int32)
        buf[0, :c] = prompt[s:s + c]
        jl, jc = jstep(jp, tokens=jnp.asarray(buf), cache=jc,
                       lane=jnp.int32(1), n_valid=jnp.int32(c))
        tl, tc = M.prefill_paged_chunk(tp, tcfg, torch.from_numpy(buf), tc,
                                       lane=lane,
                                       n_valid=torch.tensor(c, dtype=torch.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), [0, CHUNK + n_valid])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    blocks = [2, 5, 11, 9]
    key = "kp_scale" if quant else "kp"
    np.testing.assert_allclose(tc[key][:, blocks].float().numpy(),
                               np.asarray(jc[key][:, blocks], np.float32),
                               atol=TOL, rtol=TOL)


def test_chunk_takes_ints_and_tensors_alike():
    """A Python int is filled into a 0-d tensor: the same bits either way."""
    _, _, tcfg, tp, _ = _chunk_pair("smollm-360m")
    buf = torch.from_numpy(np.arange(CHUNK, dtype=np.int32)[None] % 50)
    out = []
    for lane, n in ((1, 5), (torch.tensor(1, dtype=torch.int32),
                             torch.tensor(5, dtype=torch.int32))):
        tc = M.init_paged_cache(tcfg, 2, 6, 4, max_blocks_per_lane=3)
        tc["block_tables"][1] = torch.tensor([4, 2, 0], dtype=torch.int32)
        logits, tc = M.prefill_paged_chunk(tp, tcfg, buf, tc, lane=lane,
                                           n_valid=n)
        out.append((logits, tc["pos"].clone(), tc["kp"].clone()))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="0-d"):
        M.prefill_paged_chunk(tp, tcfg, buf, tc,
                              lane=torch.tensor([1], dtype=torch.int32),
                              n_valid=5)


# ------------------------------------------- graphs=True against graphs=False
@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = get_config(arch).reduced()
    return cfg, M.init_params(cfg, torch.Generator().manual_seed(3))


def _engines(arch, max_len=64, kv_quant=False):
    cfg, params = _params(arch)
    return {g: InferenceEngine(cfg, params, max_len=max_len, device="cpu",
                               kv_quant=kv_quant, graphs=g)
            for g in (True, False)}


def _batch(cfg, B=2, S=9, seed=0):
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["vision"] = torch.randn((B, cfg.num_vision_tokens, cfg.d_model),
                                      generator=gen)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((B, cfg.encoder_seq_len, cfg.d_model),
                                      generator=gen)
    return batch


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_replays_are_the_eager_steps(family):
    """Prefill, then 5 decode steps on each engine: the same logits, bit for
    bit; one capture, then replays, with the runner's copies of the
    inputs."""
    eng = _engines(FAMILIES[family])
    batch = _batch(eng[True].cfg)
    logits, caches = {}, {}
    for g, e in eng.items():
        logits[g], caches[g] = e.prefill(batch)
    for _ in range(5):
        tok = torch.argmax(logits[False], -1).to(torch.int32)[:, None]
        for g, e in eng.items():
            logits[g], caches[g] = e.decode(tok, caches[g])
        assert torch.equal(logits[True], logits[False])
    for k in caches[False]:
        assert torch.equal(caches[True][k], caches[False][k]), k
    runner = eng[True].graphs
    assert (runner.captures, runner.replays, len(runner)) == (1, 4, 1)
    assert eng[False].graphs is None


@pytest.mark.parametrize("family", FAMILIES)
def test_generate_tokens_are_the_eager_engines(family):
    """``generate`` on each engine gives the same tokens; each call makes
    its own cache, so one capture a call, and the dead cache's entry is
    dropped at the next call."""
    eng = _engines(FAMILIES[family])
    batch = _batch(eng[True].cfg, B=1, seed=1)
    for call in range(2):
        got = {g: e.generate(batch, 6).tokens for g, e in eng.items()}
        np.testing.assert_array_equal(got[True], got[False])
        gc.collect()
    runner = eng[True].graphs
    assert (runner.captures, runner.replays) == (2, 2 * 4)
    assert len(runner) == 1


def _run(batcher, prompts, n=5):
    reqs = [Request(i, p, max_new_tokens=n) for i, p in enumerate(prompts)]
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    return [r.out_tokens for r in reqs]


def _prompts(cfg, lens=(11, 19, 6)):
    rng = np.random.default_rng(4)
    return [rng.integers(0, cfg.vocab_size, size=m).astype(np.int32)
            for m in lens]


@pytest.mark.parametrize("family", ["dense", "moe", "ssm", "hybrid"])
def test_continuous_batcher_tokens_are_the_eager_ones(family):
    eng = _engines(FAMILIES[family])
    prompts = _prompts(eng[True].cfg)
    got = {g: _run(ContinuousBatcher(e, slots=2), prompts)
           for g, e in eng.items()}
    assert got[True] == got[False]
    assert eng[True].graphs.captures == 1 and eng[True].graphs.replays > 0


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_paged_batcher_tokens_are_the_eager_ones(family, kv_quant):
    """Chunked prefill (one capture per chunk shape, replayed for every
    lane and valid count) and paged decode, with prefix sharing."""
    eng = _engines(FAMILIES[family], kv_quant=kv_quant)
    prompts = _prompts(eng[True].cfg, lens=(11, 19, 11, 6))
    prompts[2] = prompts[0].copy()            # a shared prefix
    got, stats = {}, {}
    for g, e in eng.items():
        cb = PagedContinuousBatcher(e, slots=2, num_blocks=24, block_size=4,
                                    chunk=8)
        got[g] = _run(cb, prompts)
        stats[g] = cb.stats()
    assert got[True] == got[False] and stats[True] == stats[False]
    assert stats[True]["prefix_hits"] > 0
    runner = eng[True].graphs
    # one prefill_chunk and one decode_paged capture on one cache
    assert runner.captures == 2 and len(runner) == 2
    assert runner.replays > 10


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_paged_decode_runs_the_live_lanes_padded_to_a_row_count(family,
                                                               kv_quant):
    """40 slots: a decode tick runs its decoding lanes alone, padded with
    -1 to 32 or 40 rows (``DECODE_ROWS``), each count captured once, at
    the first decode tick; ticks of both counts occur. The tokens equal the
    eager engine's and those of the batcher run at 40 rows every tick."""
    eng = _engines(FAMILIES[family], kv_quant=kv_quant)
    prompts = _prompts(eng[True].cfg, lens=(6, 19, 11, 7, 14, 9, 17, 6, 12,
                                            8, 15, 10) * 3)
    got, rows = {}, {}
    for name, e, fixed in (("graphs", eng[True], False),
                           ("eager", eng[False], False),
                           ("all rows", eng[False], True)):
        cb = PagedContinuousBatcher(e, slots=40, num_blocks=240,
                                    block_size=4, chunk=8)
        assert cb._rows == (32, 40)
        if fixed:
            cb._rows = (40,)
        seen = []
        inner = e.decode_paged

        def decode(tokens, cache, live, inner=inner, seen=seen):
            seen.append((live.shape[0], int((live >= 0).sum())))
            return inner(tokens, cache, live)
        e.decode_paged = decode
        try:
            got[name] = _run(cb, prompts)
        finally:
            del e.decode_paged
        rows[name] = seen
    assert got["graphs"] == got["eager"] == got["all rows"]
    # the first decode tick runs every count on padding alone, first
    assert rows["graphs"][:2] == [(32, 0), (40, 0)]
    served = rows["graphs"][2:]
    assert all(n == (32 if k <= 32 else 40) for n, k in served)
    assert {n for n, _ in served} == {32, 40}
    runner = eng[True].graphs
    # one prefill_chunk and one decode_paged capture per row count
    assert runner.captures == 3 and len(runner) == 3


def test_decode_on_listed_lanes_leaves_the_others():
    """``decode_step_paged(lanes=)``: rows for lanes [3, 0] and two of
    padding against the masked step over all four lanes (lanes 1 and 2 not
    live): the same logits rows and K/V; ``pos`` advances on lanes 3 and 0
    alone, and no pool row outside theirs (and the null block) changes."""
    cfg, params = _params(FAMILIES["dense"])
    gen = torch.Generator().manual_seed(5)
    cache = M.init_paged_cache(cfg, 4, 20, 4, max_blocks_per_lane=4)
    tables = torch.tensor([[3, 7, 1, 9], [2, 5, 11, 0], [4, 6, 0, 0],
                           [8, 10, 12, 13]], dtype=torch.int32)
    cache["block_tables"].copy_(tables)
    cache["pos"].copy_(torch.tensor([9, 5, 0, 13], dtype=torch.int32))
    for k in ("kp", "vp"):
        cache[k].copy_(torch.randn(cache[k].shape, generator=gen))
    toks = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                         dtype=torch.int32)
    masked = {k: v.clone() for k, v in cache.items()}
    want, _ = M.decode_step_paged(params, cfg, toks, masked,
                                  live=torch.tensor([True, False, False,
                                                     True]))
    listed = {k: v.clone() for k, v in cache.items()}
    got, _ = M.decode_step_paged(params, cfg, toks, listed,
                                 lanes=torch.tensor([3, 0, -1, -1]))
    assert got.shape == (4, want.shape[1])
    torch.testing.assert_close(got[:2], want[[3, 0]], atol=1e-5, rtol=1e-5)
    assert listed["pos"].tolist() == [10, 5, 0, 14]
    assert torch.equal(listed["pos"], masked["pos"])
    for k in ("kp", "vp"):
        torch.testing.assert_close(listed[k][:, 1:], masked[k][:, 1:],
                                   atol=1e-6, rtol=1e-6)
        # only lane 0's row 9 (block 1, row 1) and lane 3's row 13 (block
        # 13, row 1) were written outside the null block
        diff = (listed[k][:, 1:] != cache[k][:, 1:]).any(-1).any(0)
        assert sorted(map(tuple, diff.nonzero().tolist())) == \
            [(blk - 1, h, 1) for blk in (1, 13)
             for h in range(cfg.num_kv_heads)]
    with pytest.raises(ValueError, match="live or lanes"):
        M.decode_step_paged(params, cfg, toks, listed,
                            live=torch.ones(4, dtype=torch.bool),
                            lanes=torch.tensor([0]))


def _router(eng, policy):
    cfg = eng.cfg
    if policy == "disaggregated":
        eff, perf = probe_pair(SystemProfile)
        r = FleetRouter(cfg, {"eff": eff, "perf": perf},
                        {"eff": eng, "perf": eng}, policy=policy,
                        model=CostModel(get_config("smollm-360m"), None,
                                        CostParams(lam=1.0)))
        r.attach_batchers(slots=2, paged=True, num_blocks=48, block_size=8,
                          chunk=8)
    else:
        eff, perf = paper_fleet()
        r = FleetRouter(cfg, {eff.name: eff, perf.name: perf},
                        {eff.name: eng, perf.name: eng}, policy=policy,
                        t_in=32, counts={eff.name: 4, perf.name: 1})
        r.attach_batchers(slots=2, paged=True, num_blocks=32, block_size=16)
    return r


@pytest.mark.parametrize("policy", ["capacity_aware", "disaggregated"])
def test_router_tokens_and_bookings_are_the_eager_ones(policy):
    eng = _engines("smollm-360m")
    prompts = [np.arange(40 + 7 * i) % eng[True].cfg.vocab_size
               for i in range(3)]
    out = {}
    for g, e in eng.items():
        r = _router(e, policy)
        routed = [r.submit(p, 6) for p in prompts]
        r.drain()
        out[g] = ([rr.request.out_tokens for rr in routed],
                  [(rr.pool, rr.energy_j, rr.runtime_s) for rr in routed],
                  r.fleet_report())
    assert out[True] == out[False]
    if policy == "disaggregated":
        assert out[True][2]["eff"]["tokens"] == 18   # decoded after handoff


# ----------------------------------------------------------- keys, counters
def _toy_step(cache, tokens, lane=0):
    cache["pos"].add_(1)
    return cache["w"][tokens[:, 0].long()] * (lane + 1), cache


def _toy_cache(V=5):
    return {"w": torch.arange(V * 3, dtype=torch.float32).reshape(V, 3),
            "pos": torch.zeros(2, dtype=torch.int32)}


def test_keys_make_an_entry_only_for_a_new_cache_batch_or_tuning():
    runner = SGR.StepGraphs("cpu")
    cache = _toy_cache()
    tok = torch.tensor([[1], [2]], dtype=torch.int32)
    a, _ = runner.run("s", _toy_step, {"tokens": tok}, cache)
    b, _ = runner.run("s", _toy_step, {"tokens": tok.flip(0)}, cache)
    assert (len(runner), runner.captures, runner.replays) == (1, 1, 1)
    assert torch.equal(b, a.flip(0)) and cache["pos"].tolist() == [2, 2]
    other = _toy_cache()                                  # a new cache
    runner.run("s", _toy_step, {"tokens": tok}, other)
    assert len(runner) == 2
    runner.run("s", _toy_step, {"tokens": tok[:1]}, cache)  # another batch
    assert len(runner) == 3
    runner.run("t", _toy_step, {"tokens": tok}, cache)      # another step
    assert len(runner) == 4
    prev = AT.install(AT.AutotuneCache("tests", "cuda", entries=[]))
    try:
        runner.run("s", _toy_step, {"tokens": tok}, cache)  # a new tuning
        assert len(runner) == 5 and runner.captures == 5
        runner.run("s", _toy_step, {"tokens": tok}, cache)
        assert len(runner) == 5 and runner.captures == 5
    finally:
        AT.install(prev)
    runner.run("s", _toy_step, {"tokens": tok}, cache)      # the first again
    assert runner.captures == 5 and runner.replays == 3
    del other
    gc.collect()
    runner.run("s", _toy_step, {"tokens": tok}, cache)
    assert len(runner) == 4                   # the dead cache's entry went


def test_a_new_pool_once_no_graph_is_left(monkeypatch):
    """The allocator releases a graph pool with its last graph, and a
    capture into that pool's handle fails: with every entry dropped, the
    runner takes a new handle; with one left, it keeps the shared one."""
    handles = iter(range(100))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: (0, next(handles)))
    runner = SGR.StepGraphs("cpu")
    runner._cuda = True            # the pool's rule; the steps stay eager
    tok = torch.tensor([[1], [2]], dtype=torch.int32)
    kept, gone = _toy_cache(), _toy_cache()
    runner.run("s", _toy_step, {"tokens": tok}, kept)
    assert runner._pool == (0, 0)                   # made at the first
    runner.run("s", _toy_step, {"tokens": tok}, gone)
    del gone
    gc.collect()
    runner.run("s", _toy_step, {"tokens": tok}, kept)
    assert runner._pool == (0, 0) and len(runner) == 1
    del kept
    gc.collect()
    runner.run("s", _toy_step, {"tokens": tok}, _toy_cache())
    assert runner._pool == (0, 1) and len(runner) == 1


def test_an_int_input_lands_in_a_0d_int32_buffer():
    runner = SGR.StepGraphs("cpu")
    cache = _toy_cache()
    tok = torch.tensor([[1], [2]], dtype=torch.int32)
    first, _ = runner.run("s", _toy_step, {"tokens": tok, "lane": 1}, cache)
    again, _ = runner.run("s", _toy_step, {"tokens": tok, "lane": 2}, cache)
    assert torch.equal(again, first * 3 / 2)
    (entry,) = runner._entries.values()
    assert entry.static["lane"].dtype == torch.int32 \
        and entry.static["lane"].dim() == 0
    with pytest.raises(TypeError, match="not a tensor or an int"):
        runner.run("s", _toy_step, {"tokens": tok, "lane": 1.5}, cache)


def test_the_returned_logits_are_a_copy():
    runner = SGR.StepGraphs("cpu")
    cache = _toy_cache()
    tok = torch.tensor([[1], [2]], dtype=torch.int32)
    runner.run("s", _toy_step, {"tokens": tok}, cache)
    a, _ = runner.run("s", _toy_step, {"tokens": tok}, cache)
    keep = a.clone()
    b, _ = runner.run("s", _toy_step, {"tokens": tok.flip(0)}, cache)
    assert torch.equal(a, keep) and not torch.equal(a, b)


def test_a_step_that_replaces_its_cache_raises():
    def replacing(cache, tokens):
        cache["pos"] = cache["pos"] + 1
        return tokens.float(), cache
    with pytest.raises(RuntimeError, match="in place"):
        SGR.StepGraphs("cpu").run("s", replacing, {"tokens": torch.zeros(
            (2, 1), dtype=torch.int32)}, _toy_cache())


def test_each_replay_adds_what_the_capture_counted():
    """The toy step counts 2 K2 launches and 1 K5 launch the first time and
    5 K2 launches later: the warm-up counts as the eager call it is, and
    each replay adds the 2 and 1 the capture took (a graph replays what was
    captured; no Python runs)."""
    calls = []

    def counting(cache, tokens):
        DA.decode_attention.launches += 2 if not calls else 5
        SS.ssd_scan.launches += 1 if not calls else 0
        calls.append(1)
        return cache["w"][tokens[:, 0].long()], cache
    before = (DA.decode_attention.launches, SS.ssd_scan.launches)
    runner = SGR.StepGraphs("cpu")
    cache = _toy_cache()
    tok = torch.tensor([[1], [2]], dtype=torch.int32)
    runner.run("s", counting, {"tokens": tok}, cache)
    for n in range(1, 4):
        runner.run("s", counting, {"tokens": tok}, cache)
        assert (DA.decode_attention.launches - before[0],
                SS.ssd_scan.launches - before[1]) == (2 + 2 * n, 1 + n)
    (entry,) = runner._entries.values()
    assert dict(zip((fn.__name__ for fn in SGR.COUNTERS), entry.counts)) == {
        "flash_attention": 0, "flash_attention_bwd": 0,
        "decode_attention": 2, "paged_decode_attention": 0,
        "paged_decode_attention_int8": 0, "ssd_scan": 1, "ssd_scan_bwd": 0,
        "paged_chunk_attention": 0, "moe_experts": 0}


def test_every_kernel_wrapper_has_a_counter_in_the_runner():
    from repro_torch.kernels import chunk_attention as CA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import moe_experts as ME
    wrappers = {FA.flash_attention, FA.flash_attention_bwd,
                DA.decode_attention, DA.paged_decode_attention,
                DA.paged_decode_attention_int8, SS.ssd_scan, SS.ssd_scan_bwd,
                CA.paged_chunk_attention, ME.moe_experts}
    assert set(SGR.COUNTERS) == wrappers
    assert all(isinstance(fn.launches, int) for fn in SGR.COUNTERS)


def test_the_cpu_runner_makes_no_cuda_state():
    runner = SGR.StepGraphs("cpu")
    assert runner._pool is None and runner._side is None
    cfg, params = _params("smollm-360m")
    assert InferenceEngine(cfg, params, device="cpu",
                           graphs=False).graphs is None

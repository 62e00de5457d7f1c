"""The port's KV handoff between paged pools against the JAX package.

Counterparts of tests/test_disagg.py's serving half, on the same reduced
smollm-360m (PRNGKey(7), converted to torch through numpy) and the same
probe pool pair priced with the unreduced config: ``migrate_kv_blocks`` on
float and int8 pools, token and ``fleet_report()`` parity of
``FleetRouter(policy="disaggregated")`` across a handoff, prefix-shared
blocks, a block-starved target, and EOS on the first token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.pricing import CostModel as JaxCostModel
from repro.core.pricing import CostParams as JaxCostParams
from repro.core.systems import SystemProfile as JaxSystemProfile
from repro.models import model as JM
from repro.serving.batching import migrate_kv_blocks as jax_migrate
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.router import FleetRouter as JaxRouter
from repro_torch.configs import get_config
from repro_torch.core.pricing import CostModel, CostParams
from repro_torch.core.systems import SystemProfile
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.batching import (PagedContinuousBatcher, Request,
                                          migrate_kv_blocks)
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.router import POLICIES, FleetRouter

from _torch_handoff import probe_pair

ARCH = "smollm-360m"


def _make_engines(kv_quant):
    jcfg = jax_config(ARCH).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(7))
    tp = from_jax_params(jax.tree.map(np.asarray, jp),
                         get_config(ARCH).reduced())
    return (JaxEngine(jcfg, jp, max_len=96, kv_quant=kv_quant),
            InferenceEngine(get_config(ARCH).reduced(), tp, max_len=96,
                            device="cpu", kv_quant=kv_quant))


@pytest.fixture(scope="module")
def engines():
    return _make_engines(False)


@pytest.fixture(scope="module")
def engines_int8():
    return _make_engines(True)


# ------------------------------------------------------------ migration
def _filled_pools(jeng, teng, lanes, num_blocks, block_size, seed):
    """The same random contents in a JAX and a torch paged cache (int8
    pools and float32 scale pools for a kv_quant engine)."""
    jc = jeng.new_paged_cache(lanes, num_blocks, block_size)
    tc = teng.new_paged_cache(lanes, num_blocks, block_size)
    rng = np.random.default_rng(seed)
    for k in ("kp", "vp", "kp_scale", "vp_scale"):
        if k not in jc:
            continue
        shape, dt = jc[k].shape, np.dtype(jc[k].dtype)
        if dt == np.int8:
            a = rng.integers(-127, 128, size=shape).astype(np.int8)
        else:
            a = rng.standard_normal(shape).astype(dt)
        jc[k] = jnp.asarray(a)
        tc[k] = torch.from_numpy(a.copy())
    return jc, tc


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("src_blocks,dst_blocks",
                         [([1, 2], [3, 4]), ([5, 1, 6], [2, 7, 3]),
                          ([7], [1])])
def test_migrate_kv_blocks_matches_jax(engines, engines_int8, quant,
                                       src_blocks, dst_blocks):
    """Copies, never steals: the destination pools equal the JAX package's
    after the same migration, the source pools are unchanged, the other
    destination blocks untouched, and the payload bytes agree."""
    jeng, teng = engines_int8 if quant else engines
    js, ts = _filled_pools(jeng, teng, 2, 8, 4, seed=1)
    jd, td = _filled_pools(jeng, teng, 2, 8, 4, seed=2)
    before_src = {k: v.clone() for k, v in ts.items()}
    before_dst = {k: v.clone() for k, v in td.items()}
    jout, jmoved = jax_migrate(js, src_blocks, jd, dst_blocks)
    tout, tmoved = migrate_kv_blocks(ts, src_blocks, td, dst_blocks)
    assert tout is td                       # in place
    assert tmoved == jmoved
    keys = ("kp", "vp") + (("kp_scale", "vp_scale") if quant else ())
    assert all(k in tout for k in keys)
    cfg = teng.cfg
    per_row = 2 * cfg.resolved_head_dim * (1 if quant else 4) + \
        (2 * 4 if quant else 0)
    assert tmoved == len(src_blocks) * cfg.num_layers * cfg.num_kv_heads * \
        4 * per_row
    others = [b for b in range(8) if b not in dst_blocks]
    for k in keys:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
        np.testing.assert_array_equal(tout[k][:, dst_blocks].numpy(),
                                      before_src[k][:, src_blocks].numpy())
        assert torch.equal(ts[k], before_src[k])
        assert torch.equal(tout[k][:, others], before_dst[k][:, others])


def _raised(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("case", ["length", "block_size", "dtype"])
def test_migrate_kv_blocks_errors_match_jax(engines, engines_int8, case):
    jeng, teng = engines
    jq, tq = engines_int8
    js, ts = jeng.new_paged_cache(2, 8, 4), teng.new_paged_cache(2, 8, 4)
    if case == "length":
        args = ([1, 2], jeng.new_paged_cache(2, 8, 4), [3]), \
            ([1, 2], teng.new_paged_cache(2, 8, 4), [3])
    elif case == "block_size":
        args = ([1], jeng.new_paged_cache(2, 8, 8), [1]), \
            ([1], teng.new_paged_cache(2, 8, 8), [1])
    else:
        args = ([1], jq.new_paged_cache(2, 8, 4), [1]), \
            ([1], tq.new_paged_cache(2, 8, 4), [1])
    want = _raised(lambda: jax_migrate(js, *args[0]))
    got = _raised(lambda: migrate_kv_blocks(ts, *args[1]))
    assert got == want


def test_migrate_kv_blocks_empty_and_two_devices(engines):
    _, teng = engines
    src, dst = teng.new_paged_cache(2, 8, 4), teng.new_paged_cache(2, 8, 4)
    same, zero = migrate_kv_blocks(src, [], dst, [])
    assert same is dst and zero == 0
    meta = {k: torch.empty_like(v, device="meta") for k, v in dst.items()}
    with pytest.raises(ValueError, match="two devices"):
        migrate_kv_blocks(src, [1], meta, [2])


# ---------------------------------------------------------------- router
def _routers(engines, *, paged=True, slots=2, num_blocks=48, block_size=8,
             chunk=8, block_sizes=None):
    """The JAX and the torch router over the probe pair, priced with the
    unreduced config (the reduced model's decode is too small for any
    split to beat migration)."""
    out = []
    for Router, SP, CM, CP, cfgf, eng in (
            (JaxRouter, JaxSystemProfile, JaxCostModel, JaxCostParams,
             jax_config, engines[0]),
            (FleetRouter, SystemProfile, CostModel, CostParams, get_config,
             engines[1])):
        eff, perf = probe_pair(SP)
        r = Router(eng.cfg, {"eff": eff, "perf": perf},
                   {"eff": eng, "perf": eng}, policy="disaggregated",
                   model=CM(cfgf(ARCH), None, CP(lam=1.0)))
        r.attach_batchers(slots=slots, paged=paged, num_blocks=num_blocks,
                          block_size=block_size, chunk=chunk)
        if block_sizes is not None:          # one pool with another size
            for name, bs in block_sizes.items():
                cls = type(r.batchers[name])
                r.batchers[name] = cls(eng, slots=slots,
                                       num_blocks=num_blocks, block_size=bs,
                                       chunk=chunk)
        out.append(r)
    return out


def _all_blocks_back(cb):
    evictable = sum(1 for b in cb.prefix._map.values()
                    if cb.allocator.refcount[b] == 1)
    return cb.allocator.free_blocks + evictable == cb.allocator.total_blocks


def test_disaggregated_is_a_policy():
    assert "disaggregated" in POLICIES


def test_router_token_and_report_parity_across_handoff(engines):
    """Held after submit, handed off in drain; tokens equal to the JAX
    router's and to solo generation; the query booked at its prefill pool
    and its decode tokens at its decode pool; every block returned."""
    jr, tr = _routers(engines)
    prompts = [np.arange(40 + 7 * i) % tr.cfg.vocab_size for i in range(3)]
    jrouted = [jr.submit(p, 6) for p in prompts]
    trouted = [tr.submit(p, 6) for p in prompts]
    assert len(tr._handoffs) == 3
    assert all(rr.request.hold for rr in trouted)
    jr.drain()
    tr.drain()
    assert not tr._handoffs
    assert tr.fleet_report() == jr.fleet_report()
    rep = tr.fleet_report()
    assert rep["perf"]["queries"] == 3 and rep["eff"]["queries"] == 0
    assert rep["eff"]["tokens"] == 18 and rep["eff"]["energy_j"] > 0
    for a, b, p in zip(jrouted, trouted, prompts):
        assert (a.pool, a.energy_j, a.runtime_s) == (b.pool, b.energy_j,
                                                      b.runtime_s)
        assert b.request.done and not b.request.hold
        assert b.request.out_tokens == a.request.out_tokens
        solo = engines[1].generate(
            {"tokens": torch.from_numpy(p.astype(np.int32))[None]}, 6)
        assert b.request.out_tokens == list(solo.tokens[0])
    for cb in tr.batchers.values():
        assert all(r is None for r in cb.active) and not cb.queue
        assert _all_blocks_back(cb)
    assert tr.batchers["eff"].stats() == jr.batchers["eff"].stats()
    assert tr.batchers["perf"].stats() == jr.batchers["perf"].stats()


@pytest.mark.parametrize("backend", ["dense", "block_size"])
def test_unexecutable_split_runs_on_the_prefill_pool(engines, backend):
    """A split plan whose ends cannot hand off (dense batchers, or paged
    pools with different block sizes) runs wholly on the prefill pool and
    keeps the split booking, as the JAX router does."""
    kw = (dict(paged=False) if backend == "dense"
          else dict(block_sizes={"eff": 16}))
    jr, tr = _routers(engines, **kw)
    prompts = [np.arange(40 + 7 * i) % tr.cfg.vocab_size for i in range(2)]
    jrouted = [jr.submit(p, 5) for p in prompts]
    trouted = [tr.submit(p, 5) for p in prompts]
    assert not tr._handoffs and not any(rr.request.hold for rr in trouted)
    jr.drain()
    tr.drain()
    assert tr.fleet_report() == jr.fleet_report()
    for a, b in zip(jrouted, trouted):
        assert b.pool == "perf" and b.request.done
        assert b.request.out_tokens == a.request.out_tokens


def test_engine_only_split_reconciles_both_pools(engines):
    """No batchers: the split request generates at once on the prefill
    pool's engine and each phase is re-booked on its own pool."""
    jr, tr = _routers(engines)
    jr.batchers, tr.batchers = {}, {}
    prompt = np.arange(60) % tr.cfg.vocab_size
    eos = int(engines[1].generate(
        {"tokens": torch.from_numpy(prompt.astype(np.int32))[None]},
        6).tokens[0, 2])
    a = jr.submit(prompt, 6, eos_id=eos)
    b = tr.submit(prompt, 6, eos_id=eos)
    assert list(b.output) == list(a.output) and len(b.output) <= 3
    assert tr.fleet_report() == jr.fleet_report()


def test_eos_on_first_token_undoes_booked_migration(engines):
    """EOS on the first token: the held request is done on its prefill
    pool, nothing is handed off, and the booked migration is taken back
    out of the actual totals as the JAX router does."""
    jr, tr = _routers(engines)
    prompt = np.arange(44) % tr.cfg.vocab_size
    first = int(engines[1].generate(
        {"tokens": torch.from_numpy(prompt.astype(np.int32))[None]},
        1).tokens[0, 0])
    jrr = jr.submit(prompt, 6, eos_id=first)
    trr = tr.submit(prompt, 6, eos_id=first)
    assert trr.request.hold
    jr.drain()
    tr.drain()
    assert trr.request.done and trr.request.out_tokens == [first]
    assert trr.request.out_tokens == jrr.request.out_tokens
    assert not tr._handoffs
    assert tr.fleet_report() == jr.fleet_report()
    rep = tr.fleet_report()
    # the split settlement books the emitted tokens, the first one too, at
    # the decode pool (core.settlement.reconcile_split_deltas)
    assert rep["eff"]["tokens"] == 1
    assert rep["perf"]["energy_j"] < rep["perf"]["expected_energy_j"]
    for cb in tr.batchers.values():
        assert _all_blocks_back(cb)


# -------------------------------------------------------- batcher seam
def _prefill_held(src, held):
    for _ in range(20):
        src.step()
        i = next((j for j, r in enumerate(src.active) if r is held), None)
        if held.out_tokens and i is not None and \
                src._lane[i].prefilled >= len(held.tokens):
            return i
    raise AssertionError("held request did not finish prefill")


def test_held_lane_never_decodes_on_its_prefill_pool(engines):
    """A pool holding only a held, prefilled lane ticks without a decode
    launch; its lane keeps the first token and waits."""
    _, teng = engines
    src = PagedContinuousBatcher(teng, slots=2, num_blocks=32, block_size=8,
                                 chunk=8)
    held = Request(1, np.arange(20) % teng.cfg.vocab_size, 5, hold=True)
    src.submit(held)
    _prefill_held(src, held)
    calls = []
    orig = teng.decode_paged
    teng.decode_paged = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        for _ in range(3):
            src.step()
    finally:
        del teng.decode_paged
    assert not calls and len(held.out_tokens) == 1 and not held.done
    assert src._decode_lanes() == []


def test_adopt_lane_prefix_shared_blocks_survive_handoff(engines):
    """Copy-not-steal: a handed-off lane's prompt blocks may be shared via
    the PrefixBlockCache; migration leaves them serving the source pool,
    and both requests give the JAX engine's solo tokens."""
    jeng, teng = engines
    src = PagedContinuousBatcher(teng, slots=2, num_blocks=32, block_size=8,
                                 chunk=8)
    dst = PagedContinuousBatcher(teng, slots=2, num_blocks=32, block_size=8,
                                 chunk=8)
    prompt = np.arange(24) % teng.cfg.vocab_size
    held = Request(1, prompt, 5, hold=True)
    twin = Request(2, prompt.copy(), 5)
    src.submit(held)
    src.submit(twin)
    src_i = _prefill_held(src, held)
    assert not held.done
    shared_before = src.prefix.hits
    moved = dst.adopt_lane(held, src, src_i)
    assert moved and moved > 0 and not held.hold
    src.release_lane(src_i)
    assert int(src.cache["pos"][src_i]) == 0
    assert bool((src.cache["block_tables"][src_i] == 0).all())
    src.run()
    dst.run()
    assert held.done and twin.done
    solo = jeng.generate({"tokens": jnp.asarray(prompt, jnp.int32)[None]}, 5)
    assert held.out_tokens[:5] == list(np.asarray(solo.tokens[0]))
    assert twin.out_tokens[:5] == list(np.asarray(solo.tokens[0]))
    assert src.prefix.hits >= shared_before
    assert all(_all_blocks_back(cb) for cb in (src, dst))


def test_adopt_lane_block_starved_target_retries(engines):
    """A migration racing admission on a block-starved target waits (no
    partial copy) and succeeds once the target frees blocks."""
    jeng, teng = engines
    src = PagedContinuousBatcher(teng, slots=1, num_blocks=32, block_size=8,
                                 chunk=8, prefix_sharing=False)
    dst = PagedContinuousBatcher(teng, slots=1, num_blocks=8, block_size=8,
                                 chunk=8, prefix_sharing=False)
    hog = Request(9, np.arange(40) % teng.cfg.vocab_size, 3)
    dst.submit(hog)
    dst.step()                                   # hog takes 6 of 7 blocks
    held = Request(1, np.arange(16) % teng.cfg.vocab_size, 4, hold=True)
    src.submit(held)
    src_i = _prefill_held(src, held)
    pools_before = {k: dst.cache[k].clone() for k in ("kp", "vp")}
    free_before = dst.allocator.free_blocks
    assert dst.adopt_lane(held, src, src_i) is None   # starved
    assert src.active[src_i] is held and held.hold    # source untouched
    assert dst.allocator.free_blocks == free_before
    assert all(torch.equal(dst.cache[k], v) for k, v in pools_before.items())
    dst.run()                                         # hog retires
    assert hog.done
    moved = dst.adopt_lane(held, src, src_i)
    assert moved and moved > 0
    src.release_lane(src_i)
    dst.run()
    assert held.done
    solo = jeng.generate(
        {"tokens": jnp.asarray(held.tokens, jnp.int32)[None]}, 4)
    assert held.out_tokens[:4] == list(np.asarray(solo.tokens[0]))


@pytest.mark.parametrize("case", ["before_prefill", "block_size"])
def test_adopt_lane_refuses(engines, case):
    _, teng = engines
    src = PagedContinuousBatcher(teng, slots=1, num_blocks=32, block_size=8,
                                 chunk=8)
    dst = PagedContinuousBatcher(teng, slots=1, num_blocks=32,
                                 block_size=16 if case == "block_size" else 8,
                                 chunk=8)
    held = Request(1, np.arange(30) % teng.cfg.vocab_size, 4, hold=True)
    src.submit(held)
    if case == "before_prefill":
        src.step()                           # one chunk of four
        match = "before its prefill completed"
    else:
        _prefill_held(src, held)
        match = "equal block sizes"
    with pytest.raises(ValueError, match=match):
        dst.adopt_lane(held, src, src.active.index(held))
    assert dst.allocator.free_blocks == dst.allocator.total_blocks


def test_int8_handoff_tokens_match_jax(engines_int8):
    """An int8 KV cache hands off its scale pools with its blocks: the
    router's tokens equal the JAX router's over the same int8 engines."""
    jr, tr = _routers(engines_int8)
    prompts = [np.arange(33 + 9 * i) % tr.cfg.vocab_size for i in range(2)]
    jrouted = [jr.submit(p, 5) for p in prompts]
    trouted = [tr.submit(p, 5) for p in prompts]
    assert len(tr._handoffs) == 2
    jr.drain()
    tr.drain()
    assert tr.fleet_report() == jr.fleet_report()
    for a, b in zip(jrouted, trouted):
        assert b.request.done
        assert b.request.out_tokens == a.request.out_tokens

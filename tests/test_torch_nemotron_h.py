"""Nemotron-H in the port (a ``block_pattern`` hybrid: Mamba2 with grouped
B and C, sigmoid-routed dropless MoE with a shared expert, NoPE attention)
against the benchmark's plain float32 reference
(``serve_bench/reference/nemotron_h.py``, one copy for both), at a tiny
size on the CPU, on the same seeded weights (drawn by the reference, handed
to both)."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from serve_bench.reference import nemotron_h as REF  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig  # noqa: E402
from repro_torch.kernels import moe_experts as ME  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402

TINY = {"family": "hybrid", "num_layers": 6, "d_model": 64, "num_heads": 4,
        "num_kv_heads": 2, "head_dim": 16, "d_ff": 32, "vocab_size": 128,
        "pos_emb": "none", "activation": "relu2", "norm": "rmsnorm",
        "tie_embeddings": False, "block_pattern": "MEM*EM",
        "ssm": {"state_dim": 16, "head_dim": 16, "expand": 2,
                "chunk_size": 8, "conv_width": 4, "n_groups": 2,
                "num_heads": 4},
        "moe": {"num_experts": 8, "num_experts_per_tok": 3,
                "router": "sigmoid", "score_bias": True,
                "norm_topk_prob": True, "routed_scale": 2.5,
                "shared_expert_dim": 48}}
ATOL = 2e-5       # float32 against float32: summation order only


def _cfg(model=TINY) -> ModelConfig:
    return ModelConfig(name="tiny-nemotron", **model)


def _weights(seed: int, dtype=torch.float32, model=TINY):
    w = REF.make_weights(model, torch.Generator().manual_seed(seed), dtype,
                         "cpu")
    # a correction bias that moves choices, so that selecting by it and
    # weighting without it are both exercised
    g = torch.Generator().manual_seed(seed + 1)
    for kind, lp in zip(model["block_pattern"], w["layers"]):
        if kind == "E":
            lp["moe"]["router"]["bias"] = torch.randn(
                (model["moe"]["num_experts"],), generator=g) * 0.3
    return w


def test_config_takes_mappings():
    cfg = _cfg()
    assert isinstance(cfg.moe, MoEConfig) and isinstance(cfg.ssm, SSMConfig)
    assert cfg.moe.router == "sigmoid" and cfg.ssm.n_groups == 2
    assert cfg.d_inner == 64 and cfg.ssm_heads == 4
    assert hash(cfg) == hash(_cfg())
    with pytest.raises(ValueError):
        ModelConfig(name="bad", **dict(TINY, block_pattern="MEX*EM"))
    with pytest.raises(ValueError):
        ModelConfig(name="bad", **dict(TINY, block_pattern="ME"))


def test_param_counts_at_full_size():
    cfg = get_config("nemotron-3-nano-30b-a3b")
    assert cfg.param_count() == 31_577_940_288          # 31.58e9
    # active: 6 of 128 experts a token; 3.23e9 without the input embedding
    assert cfg.active_param_count() == 3_580_076_352
    assert cfg.active_param_count() - cfg.vocab_size * cfg.d_model == \
        pytest.approx(3.23e9, rel=2e-3)
    assert (cfg.blocks("M"), cfg.blocks("E"), cfg.blocks("*")) == (23, 23, 6)
    assert cfg.d_inner == 4096


def test_tiny_param_count_matches_weights():
    cfg = _cfg()
    w = REF.make_weights(TINY, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    assert M.param_count(w) == cfg.param_count()


@pytest.mark.parametrize("S", [5, 19])
def test_forward_train_equals_reference(S):
    w = _weights(1)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, TINY["vocab_size"], (2, S), generator=g)
    got, aux = M.forward_train(w, _cfg(), {"tokens": toks})
    want = REF.forward(w, TINY, [toks[0], toks[1]], [0, 0])
    assert float(aux) == 0.0
    for b in range(2):
        torch.testing.assert_close(got[b], want[b], atol=ATOL, rtol=0)


def test_prefill_then_decode_equals_reference():
    """The engine's prefill, then decode steps through the dense cache,
    against the reference's one pass over the whole sequence."""
    from repro_torch.serving.engine import InferenceEngine
    w = _weights(3)
    eng = InferenceEngine(_cfg(), w, max_len=32, device="cpu")
    toks = torch.randint(0, 128, (1, 11), generator=torch.Generator()
                         .manual_seed(4))
    cache = eng.new_cache(1)
    logits, cache = eng.prefill({"tokens": toks}, cache)
    rows = [logits[0]]
    seq = toks[0].tolist()
    for _ in range(5):
        nxt = int(rows[-1].argmax())
        seq.append(nxt)
        logits, cache = eng.decode(torch.tensor([[nxt]], dtype=torch.int32),
                                   cache)
        rows.append(logits[0])
    want = REF.forward(w, TINY, [torch.tensor(seq)], [10])[0]
    torch.testing.assert_close(torch.stack(rows), want, atol=ATOL, rtol=0)


def test_continuous_batcher_serves_reference_tokens():
    """Requests through ContinuousBatcher (lanes refilled, retired, dead
    lanes in the decode) are served the reference's greedy tokens, and
    every decode tick routes 3 rows a live lane in each E block."""
    from repro_torch.serving import trace
    from repro_torch.serving.batching import ContinuousBatcher, Request
    from repro_torch.serving.engine import InferenceEngine
    w = _weights(5)
    eng = InferenceEngine(_cfg(), w, max_len=48, device="cpu")
    cb = ContinuousBatcher(eng, slots=3)
    rng = np.random.default_rng(6)
    reqs = [Request(i, rng.integers(0, 128, m).astype(np.int32), n)
            for i, (m, n) in enumerate([(7, 6), (3, 2), (12, 5), (5, 7),
                                        (9, 3)])]
    for r in reqs:
        cb.submit(r)
    trace.TICKS.clear()
    cb.run()
    assert all(r.done for r in reqs)
    for r in reqs:
        seq = torch.tensor(np.concatenate([r.tokens, r.out_tokens[:-1]]))
        lg = REF.forward(w, TINY, [seq.long()], [len(r.tokens) - 1])[0]
        served = torch.tensor(r.out_tokens)
        gap = lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]
        assert float(gap.max()) <= 1e-4, (r.rid, gap)
    decoding = [t for t in trace.TICKS if t.decode_lanes]
    assert decoding and any(t.decode_lanes < 3 for t in decoding)
    n_e = TINY["block_pattern"].count("E")
    for t in decoding:
        assert t.routed_rows == n_e * 3 * t.decode_lanes
        assert 0 < t.experts_touched <= n_e * 8
    assert not bool(cb.cache["live"].any())      # every lane retired


@pytest.mark.parametrize("m", [2, 11, 16])
def test_padded_prefill_equals_the_prompts_own(m):
    """A prompt padded to 16 tokens with ``n_valid`` = m, through the
    engine's staged step: the logits, the conv and SSM states, the K/V rows
    and the length of the prefill at length m; pads route to no expert."""
    from repro_torch.serving.engine import InferenceEngine
    w = _weights(11)
    eng = InferenceEngine(_cfg(), w, max_len=32, device="cpu")
    toks = torch.randint(0, 128, (1, m), generator=torch.Generator()
                         .manual_seed(12), dtype=torch.int32)
    want, exact = eng.prefill({"tokens": toks}, eng.new_cache(1))
    padded = torch.zeros((1, 16), dtype=torch.int32)
    padded[:, :m] = toks
    got, cache = eng.prefill({"tokens": padded, "n_valid": m},
                             eng.new_cache(1))
    assert eng.graphs.captures == 1
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    for k in ("conv", "ssm"):
        torch.testing.assert_close(cache[k], exact[k], atol=ATOL, rtol=0)
    for k in ("ak", "av"):
        torch.testing.assert_close(cache[k][:, :, :, :m], exact[k][:, :, :, :m],
                                   atol=ATOL, rtol=0)
    assert int(cache["pos"][0]) == m and bool(cache["live"].all())
    assert int(cache["moe_stats"][0]) == TINY["block_pattern"].count("E") \
        * 3 * m


def test_batcher_captures_each_prefill_length_once():
    """The dense batcher of a block_pattern model captures a padded prefill
    for each bucket up to max_len when it is made; serving replays them,
    and a prompt past the last bucket prefills eagerly at its length."""
    from repro_torch.serving.batching import ContinuousBatcher, Request
    from repro_torch.serving.engine import InferenceEngine
    w = _weights(13)
    eng = InferenceEngine(_cfg(), w, max_len=48, device="cpu")
    cb = ContinuousBatcher(eng, slots=2)
    assert cb._buckets == (16, 32) and eng.graphs.captures == 2
    rng = np.random.default_rng(14)
    reqs = [Request(i, rng.integers(0, 128, m).astype(np.int32), 3)
            for i, m in enumerate([5, 20, 40, 16])]
    for r in reqs:
        cb.submit(r)
    cb.run()
    assert all(r.done for r in reqs)
    assert eng.graphs.captures == 3            # the two buckets and decode
    for r in reqs:
        seq = torch.tensor(np.concatenate([r.tokens, r.out_tokens[:-1]]))
        lg = REF.forward(w, TINY, [seq.long()], [len(r.tokens) - 1])[0]
        served = torch.tensor(r.out_tokens)
        gap = lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]
        assert float(gap.max()) <= 1e-4, (r.rid, gap)


def test_padded_prefill_needs_a_block_pattern():
    cfg = get_config("mamba2-130m")
    cfg = ModelConfig(**{**cfg.__dict__, "num_layers": 1, "d_model": 64,
                         "vocab_size": 64})
    w = M.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="block_pattern"):
        M.prefill(w, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                  M.init_cache(cfg, 1, 8), n_valid=torch.tensor(2))


def _per_token_moe(p, cfg, x):
    """The MoE layer token by token: the chosen experts' weighted outputs
    summed, plus the shared expert."""
    idx, wts = MOE.route_sigmoid(p, cfg, x)
    out = []
    for t in range(x.shape[0]):
        y = torch.zeros(x.shape[1])
        for j in range(idx.shape[1]):
            e = int(idx[t, j])
            h = torch.relu(x[t] @ p["w_up"][e].T).square()
            y = y + wts[t, j] * (h @ p["w_down"][e].T)
        sp = p["shared"]
        y = y + torch.relu(x[t] @ sp["up"]["w"]).square() @ sp["down"]["w"]
        out.append(y)
    return torch.stack(out)


def test_grouped_dropless_equals_per_token_sum():
    w = _weights(7)
    cfg = _cfg()
    p = w["layers"][1]["moe"]
    x = torch.randn(2, 9, 64, generator=torch.Generator().manual_seed(8))
    y, rows, touched = MOE.moe_apply_sigmoid(p, cfg, x)
    want = _per_token_moe(p, cfg, x.reshape(18, 64)).reshape(2, 9, 64)
    torch.testing.assert_close(y, want, atol=ATOL, rtol=0)
    assert int(rows) == 18 * 3
    idx, _ = MOE.route_sigmoid(p, cfg, x.reshape(18, 64))
    assert int(touched) == len(set(idx.flatten().tolist()))


def test_dead_lanes_add_no_routed_rows():
    w = _weights(9)
    cfg = _cfg()
    p = w["layers"][1]["moe"]
    x = torch.randn(4, 1, 64, generator=torch.Generator().manual_seed(10))
    live = torch.tensor([True, False, True, False])
    y, rows, touched = MOE.moe_apply_sigmoid(p, cfg, x, live=live)
    assert int(rows) == 2 * 3
    full, _, _ = MOE.moe_apply_sigmoid(p, cfg, x)
    shared = p["shared"]
    only_shared = torch.relu(x @ shared["up"]["w"]).square() \
        @ shared["down"]["w"]
    torch.testing.assert_close(y[live], full[live], atol=ATOL, rtol=0)
    torch.testing.assert_close(y[~live], only_shared[~live], atol=ATOL,
                               rtol=0)
    idx, gate = MOE.route_sigmoid(p, cfg, x.reshape(4, 64))
    r = ME.route_table(idx, gate, 8, live)
    assert int(r.offsets[-1]) == 6
    assert sorted(r.token[:6].tolist()) == [0, 0, 0, 2, 2, 2]
    # the decode step reads the cache's live mask
    cache = M.init_cache(cfg, 4, 16)
    assert int(cache["moe_stats"].sum()) == 0
    cache["live"].copy_(live)
    M.decode_step(w, cfg, torch.zeros((4, 1), dtype=torch.int32), cache)
    assert int(cache["moe_stats"][0]) == 2 * 3 * 2


def test_route_table_sorts_by_expert():
    idx = torch.tensor([[3, 1], [1, 0], [3, 2]])
    gate = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    r = ME.route_table(idx, gate, 4)
    assert r.offsets.tolist() == [0, 1, 3, 4, 6]
    assert r.slot.tolist() == [3, 1, 2, 5, 0, 4]
    assert r.token.tolist() == [1, 0, 1, 2, 0, 2]
    assert int(ME.experts_touched(r)) == 4
    assert ME.grid_tiles(384, 128) == 134 and ME.grid_tiles(6, 128) == 6


def _scan_inputs(G, S=21, H=4, P=8, N=16, seed=11):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, H, S, P, generator=g)
    dt = torch.rand(2, H, S, generator=g) * 0.5
    A = -torch.linspace(0.5, 2.0, H)
    shape = (2, S, N) if G == 0 else (2, S, G, N)
    return x, dt, A, torch.randn(shape, generator=g), \
        torch.randn(shape, generator=g)


def test_ssd_scan_one_group_is_todays():
    x, dt, A, Bm, Cm = _scan_inputs(0)
    y0, s0 = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    y1, s1 = ops.ssd_scan(x, dt, A, Bm[:, :, None], Cm[:, :, None], chunk=8)
    torch.testing.assert_close(y1, y0, atol=1e-6, rtol=0)
    torch.testing.assert_close(s1, s0, atol=1e-6, rtol=0)
    st = torch.randn(2, 4, 8, 16)
    a = ops.ssd_decode_step(st, x[:, :, 0], dt[:, :, 0], A, Bm[:, 0],
                            Cm[:, 0])
    b = ops.ssd_decode_step(st, x[:, :, 0], dt[:, :, 0], A,
                            Bm[:, 0, None], Cm[:, 0, None])
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, atol=1e-6, rtol=0)


def test_ssd_scan_groups_equal_reference():
    x, dt, A, Bm, Cm = _scan_inputs(2)
    y, state = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    for b in range(2):
        want = REF.ssd(x[b].transpose(0, 1), dt[b].T, A, Bm[b], Cm[b])
        torch.testing.assert_close(y[b].transpose(0, 1), want, atol=ATOL,
                                   rtol=0)
    # the final state carried one token further by the decode step equals
    # the scan over one more token
    x2, dt2, A2, B2, C2 = _scan_inputs(2, S=22)
    y2, _ = ops.ssd_scan(x2, dt2, A2, B2, C2, chunk=8)
    _, s21 = ops.ssd_scan(x2[:, :, :21], dt2[:, :, :21], A2, B2[:, :21],
                          C2[:, :21], chunk=8)
    yd, _ = ops.ssd_decode_step(s21, x2[:, :, 21], dt2[:, :, 21], A2,
                                B2[:, 21], C2[:, 21])
    torch.testing.assert_close(yd, y2[:, :, 21], atol=ATOL, rtol=0)
    # heads of one group share B and C: the grouped scan is the ungrouped
    # scan of each group's heads
    for grp in range(2):
        hs = slice(2 * grp, 2 * grp + 2)
        yg, _ = ref.ssd_scan_chunked(x[:, hs], dt[:, hs], A[hs],
                                     Bm[:, :, grp], Cm[:, :, grp], chunk=8)
        torch.testing.assert_close(y[:, hs], yg, atol=ATOL, rtol=0)


def test_full_config_cache_layout():
    cfg = get_config("nemotron-3-nano-30b-a3b")
    c = M.init_cache(cfg, 2, 64, torch.bfloat16, "meta")
    assert c["conv"].shape == (23, 2, 3, 6144)
    assert c["ssm"].shape == (23, 2, 64, 64, 128)
    assert c["ak"].shape == (6, 2, 2, 64, 128)
    assert c["live"].shape == (2,) and c["moe_stats"].shape == (2,)

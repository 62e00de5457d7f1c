"""The port's dense model against the JAX package on the same weights.

Weights come from ``repro.models.model.init_params(cfg, PRNGKey(0))`` and
cross through numpy (``from_jax_params``). Logits of ``prefill``,
``decode_step``, ``prefill_paged_chunk`` and ``decode_step_paged`` are held
to atol/rtol 1e-4 in float32: XLA and torch sum in different orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params

ARCHS = ["smollm-360m", "mistral-7b"]
TOL = 1e-4


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax cfg, jax params, torch cfg, torch params) of one reduced arch."""
    jcfg = jax_config(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def test_configs_are_copies(pair):
    jcfg, _, tcfg, _ = pair
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)


def test_init_params_shapes_match_reference(pair):
    """The port's own init draws the reference's shapes (the numbers differ:
    torch and JAX generators)."""
    _, _, tcfg, tp = pair
    own = M.init_params(tcfg, torch.Generator().manual_seed(0))
    flat = lambda p: {k: tuple(v.shape) for k, v in _flatten(p)}
    assert flat(own) == flat(tp)
    assert M.param_count(own) == M.param_count(tp)


def _flatten(p, prefix=""):
    if isinstance(p, torch.Tensor):
        yield prefix, p
    elif isinstance(p, dict):
        for k, v in p.items():
            yield from _flatten(v, f"{prefix}/{k}")
    else:
        for i, v in enumerate(p):
            yield from _flatten(v, f"{prefix}/{i}")


def test_prefill_and_decode_logits(pair):
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 13)).astype(np.int32)
    jc = JM.init_cache(jcfg, 2, 40)
    tc = M.init_cache(tcfg, 2, 40)
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = M.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    for _ in range(4):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = M.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
        _close(tl, jl)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _close(tc["v"], jc["v"])


def test_paged_chunk_and_decode_logits(pair):
    """Two lanes of one pool: chunked prefill (the last chunk partial, with
    padded rows sent to the null block), then batched paged decode with one
    lane dead for a step."""
    jcfg, jp, tcfg, tp = pair
    rng = np.random.default_rng(1)
    bs, chunk, lens = 8, 16, (21, 12)
    jc = JM.init_paged_cache(jcfg, 2, 12, bs, max_blocks_per_lane=5)
    tc = M.init_paged_cache(tcfg, 2, 12, bs, max_blocks_per_lane=5)
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
            _close(tl, jl)
        last.append(np.asarray(jnp.argmax(jl, -1), np.int32))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(lens))
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
    # the live blocks hold the same K/V (the null block holds garbage)
    _close(tc["kp"][:, 1:], jc["kp"][:, 1:])


def test_paged_prefill_matches_dense_prefill(pair):
    """One lane chunk-prefilled into the pool ends on the dense prefill's
    logits (the paged path is the dense function, re-addressed)."""
    _, _, tcfg, tp = pair
    p = np.random.default_rng(2).integers(0, tcfg.vocab_size, size=(1, 19))
    dense, _ = M.prefill(tp, tcfg, {"tokens": torch.from_numpy(p)},
                         M.init_cache(tcfg, 1, 32))
    tc = M.init_paged_cache(tcfg, 1, 8, 8, max_blocks_per_lane=4)
    tc["block_tables"][0] = torch.tensor([4, 2, 6, 0], dtype=torch.int32)
    for s in range(0, 19, 8):
        c = min(8, 19 - s)
        buf = torch.zeros((1, 8), dtype=torch.long)
        buf[0, :c] = torch.from_numpy(p[0, s:s + c])
        paged, tc = M.prefill_paged_chunk(tp, tcfg, buf, tc, lane=0, n_valid=c)
    torch.testing.assert_close(paged, dense, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp_and_norms_match_reference(activation):
    """Layer by layer: MLPs (jax.nn.gelu's default is the tanh form), both
    norms, and split-half RoPE, on the same numpy inputs and weights."""
    rng = np.random.default_rng(3)
    jp = JL.mlp_init(jax.random.PRNGKey(1), 32, 64, activation, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    _close(L.mlp_apply(tp, torch.from_numpy(x), activation),
           JL.mlp_apply(jp, jnp.asarray(x), activation))
    s = rng.normal(size=(32,)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)
    _close(L.rmsnorm({"scale": torch.from_numpy(s)}, torch.from_numpy(x)),
           JL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x)))
    _close(L.layernorm({"scale": torch.from_numpy(s),
                        "bias": torch.from_numpy(b)}, torch.from_numpy(x)),
           JL.layernorm({"scale": jnp.asarray(s), "bias": jnp.asarray(b)},
                        jnp.asarray(x)))
    h = rng.normal(size=(2, 3, 5, 64)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    _close(L.apply_rope(torch.from_numpy(h), torch.from_numpy(pos), 10000.0),
           JL.apply_rope(jnp.asarray(h), jnp.asarray(pos), 10000.0))


def test_bf16_weights_cross_through_float32():
    """bf16 JAX arrays convert exactly (every bf16 value is a float32)."""
    cfg = jax_config("smollm-360m").reduced()
    jp = JM.init_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tp = from_jax_params(jax.tree.map(np.asarray, jp),
                         get_config("smollm-360m").reduced(), torch.bfloat16)
    assert tp["embed"]["emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["layers"][1]["attn"]["q"]["w"].float().numpy(),
        np.asarray(jp["layers"]["attn"]["q"]["w"][1], np.float32))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "whisper-base",
                                  "qwen2-vl-7b"])
def test_other_families_raise(arch):
    """The families still to port (ROADMAP Queue 1 item 8) refuse."""
    with pytest.raises(NotImplementedError, match="not ported"):
        M.init_cache(get_config(arch).reduced(), 1, 8)

"""The port's VLM (qwen2-vl) and audio (whisper) families against the JAX
package on the same weights and inputs.

M-RoPE (``apply_mrope``, ``mrope_positions``) and the encoder's sinusoids
are held to the JAX functions; so are the audio encoder (``encode``), the
cross-attention K/V (``encode_kv``) and ``cross_attention`` for a prompt
(the flash path) and for one decode token (the plain score row). Reduced
qwen2-vl-7b and whisper-base (weights from ``repro.models.model.
init_params`` through numpy, vision or frame embeddings from a numpy seed)
give the JAX package's prefill and decode logits and its engine's greedy
tokens. Float32 atol/rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as JATT
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.engine import InferenceEngine

TOL = 1e-4
QWEN, WHISPER = "qwen2-vl-7b", "whisper-base"


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=TOL,
                               rtol=TOL)


# ------------------------------------------------------------ positions
@pytest.mark.parametrize("D", [64, 128])
def test_apply_mrope_matches_jax(D):
    """The three frequency sections of qwen2-vl's split ([8, 12, 12] of 32
    half-dims at D 64, [16, 24, 24] of 64 at D 128), each on its stream."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 11, D)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 11, 3)).astype(np.int32)
    sec = ATT._mrope_sections(D)
    assert sec == JATT._mrope_sections(D)
    _close(L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sec),
           JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sec))


def test_apply_mrope_refuses_sections_of_another_width():
    with pytest.raises(ValueError, match="do not sum"):
        L.apply_mrope(torch.zeros(1, 1, 2, 64),
                      torch.zeros(1, 2, 3, dtype=torch.int32), 1e4,
                      (8, 8, 8))


@pytest.mark.parametrize("seq_len,n_vis,start", [(30, 16, 0), (30, 9, 0),
                                                 (5, 16, 20), (12, 0, 0)])
def test_mrope_positions_match_jax(seq_len, n_vis, start):
    cfg = get_config(QWEN).reduced()
    got = M.mrope_positions(cfg, 2, seq_len, n_vis, start)
    want = JM.mrope_positions(jax_config(QWEN).reduced(), 2, seq_len, n_vis,
                              start)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seq_len,dim", [(64, 256), (1500, 512)])
def test_sinusoidal_positions_match_jax(seq_len, dim):
    _close(L.sinusoidal_positions(seq_len, dim),
           JL.sinusoidal_positions(seq_len, dim))


# ------------------------------------------------------- encoder, cross-attn
@pytest.fixture(scope="module")
def whisper():
    jcfg = jax_config(WHISPER).reduced()
    tcfg = get_config(WHISPER).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    frames = np.random.default_rng(1).normal(
        size=(2, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)
    return jcfg, jp, tcfg, tp, frames


def test_encode_matches_jax(whisper):
    jcfg, jp, tcfg, tp, frames = whisper
    _close(M.encode(tp, tcfg, torch.from_numpy(frames)),
           JM.encode(jp, jcfg, jnp.asarray(frames)))


def test_encode_kv_and_cross_attention_match_jax(whisper):
    """Cross K/V from the encoder output, then cross-attention for a prompt
    of 7 (the flash path, non-causal) and for one token (the plain row)."""
    jcfg, jp, tcfg, tp, frames = whisper
    enc = np.array(JM.encode(jp, jcfg, jnp.asarray(frames)))
    jlp = jax.tree.map(lambda a: a[1], jp["dec_layers"])
    tlp = tp["dec_layers"][1]
    jk, jv = JATT.encode_kv(jlp["cross"], jcfg, jnp.asarray(enc))
    tk, tv = ATT.encode_kv(tlp["cross"], tcfg, torch.from_numpy(enc))
    _close(tk, jk)
    _close(tv, jv)
    x = np.random.default_rng(2).normal(
        size=(2, 7, jcfg.d_model)).astype(np.float32)
    for S in (7, 1):
        _close(ATT.cross_attention(tlp["cross"], tcfg,
                                   torch.from_numpy(x[:, :S]), enc_k=tk,
                                   enc_v=tv),
               JATT.cross_attention(jlp["cross"], jcfg, jnp.asarray(x[:, :S]),
                                    enc_k=jk, enc_v=jv))


def test_audio_cache_and_params_shapes_match_reference(whisper):
    jcfg, jp, tcfg, tp, _ = whisper
    jc = JM.init_cache(jcfg, 2, 40)
    tc = M.init_cache(tcfg, 2, 40)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    own = M.init_params(tcfg, torch.Generator().manual_seed(0),
                        max_positions=300)
    assert own["dec_pos"]["emb"].shape == (300, tcfg.d_model)
    assert len(own["enc_layers"]) == tcfg.encoder_layers
    assert set(own["dec_layers"][0]) == set(tp["dec_layers"][0]) == \
        {"attn_norm", "attn", "mlp_norm", "mlp", "cross_norm", "cross"}
    assert M.param_count(own) - 300 * tcfg.d_model == \
        M.param_count(tp) - tp["dec_pos"]["emb"].shape[0] * tcfg.d_model


# ------------------------------------------------------------ whole models
def _inputs(jcfg, seed):
    """Tokens (2, 11) and the family's embeddings, from a numpy seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 11)).astype(np.int32)
    if jcfg.family == "vlm":
        key, n = "vision", jcfg.num_vision_tokens
    else:
        key, n = "frames", jcfg.encoder_seq_len
    emb = (rng.normal(size=(2, n, jcfg.d_model)) * 0.5).astype(np.float32)
    return ({"tokens": jnp.asarray(toks), key: jnp.asarray(emb)},
            {"tokens": torch.from_numpy(toks), key: torch.from_numpy(emb)})


@pytest.fixture(scope="module", params=[QWEN, WHISPER])
def pair(request):
    jcfg = jax_config(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def test_prefill_and_decode_logits(pair):
    """VLM: 16 vision embeddings before 11 tokens, M-RoPE, decode positions
    from the config's vision count. Audio: the encoder once, the cross K/V
    in the cache, learned decoder positions."""
    jcfg, jp, tcfg, tp = pair
    jb, tb = _inputs(jcfg, 3)
    jc = JM.init_cache(jcfg, 2, 48)
    tc = M.init_cache(tcfg, 2, 48)
    jl, jc = JM.prefill(jp, jcfg, jb, jc)
    tl, tc = M.prefill(tp, tcfg, tb, tc)
    _close(tl, jl)
    if tcfg.family == "audio":
        _close(tc["ck"], jc["ck"])
    for _ in range(4):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = M.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
        _close(tl, jl)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _close(tc["k"], jc["k"])


def test_generate_tokens_match_jax_engine(pair):
    """``InferenceEngine.generate`` with the family's embeddings in the
    batch: the JAX engine's greedy tokens, 10 steps."""
    jcfg, jp, tcfg, tp = pair
    jb, tb = _inputs(jcfg, 4)
    want = JaxEngine(jcfg, jp, max_len=48).generate(jb, 10).tokens
    got = InferenceEngine(tcfg, tp, max_len=48, device="cpu").generate(tb, 10)
    np.testing.assert_array_equal(got.tokens, want)


def test_audio_engine_refuses_a_context_past_its_positions(whisper):
    _, _, tcfg, tp, _ = whisper
    rows = tp["dec_pos"]["emb"].shape[0]
    with pytest.raises(ValueError, match="learned"):
        InferenceEngine(tcfg, tp, max_len=rows + 1, device="cpu")

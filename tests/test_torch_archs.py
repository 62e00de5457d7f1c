"""Every assigned architecture in the port against the JAX package (the gate
of ROADMAP Queue 1 item 8): the reduced config of each of the ten
``list_archs()``, weights from ``repro.models.model.init_params`` through
numpy, prefill plus 3 decode steps, logits within atol/rtol 1e-4 in
float32. The VLM's vision and the audio family's frame embeddings come from
a numpy seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.configs import list_archs as port_archs
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params

TOL = 1e-4


def test_port_lists_the_reference_archs():
    assert port_archs() == list_archs()
    assert len(list_archs()) == 10
    assert {get_config(a).family for a in list_archs()} == set(M.FAMILIES)


@pytest.mark.parametrize("arch", list_archs())
def test_prefill_and_decode_match_jax(arch):
    jcfg = jax_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, size=(2, 11)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    n = {"vlm": jcfg.num_vision_tokens, "audio": jcfg.encoder_seq_len}
    if jcfg.family in n:
        key = "vision" if jcfg.family == "vlm" else "frames"
        emb = rng.normal(size=(2, n[jcfg.family], jcfg.d_model))
        emb = emb.astype(np.float32)
        jb[key], tb[key] = jnp.asarray(emb), torch.from_numpy(emb)
    jc = JM.init_cache(jcfg, 2, 48, enc_len=jcfg.encoder_seq_len or None)
    tc = M.init_cache(tcfg, 2, 48)
    jl, jc = JM.prefill(jp, jcfg, jb, jc)
    tl, tc = M.prefill(tp, tcfg, tb, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc)
        tl, tc = M.decode_step(tp, tcfg, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))

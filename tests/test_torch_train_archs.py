"""``forward_train`` of every assigned architecture against the JAX
package's: all ten reduced ``list_archs()`` models, same weights (crossed
through numpy), same seeded batch, logits and the aux loss within 1e-4 in
float32. VLM logits keep the vision positions; MoE layers route with
capacity (dropless in effect at the reduced configs' C = T). With
``remat`` the port's logits are the same bits as without.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.configs import list_archs
from repro.models import model as JM
from repro.training import data as JD
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.convert import from_jax_params
from repro_torch.training import data as D

TOL = 1e-4


@pytest.mark.parametrize("arch", list_archs())
def test_forward_train_logits_match_jax(arch):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1), max_positions=256)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    jb = next(JD.uniform_stream(jcfg, 2, 16, 1, seed=9))
    tb = next(D.uniform_stream(tcfg, 2, 16, 1, seed=9))
    jl, jaux = JM.forward_train(jp, jcfg, jb)
    tl, taux = M.forward_train(tp, tcfg, tb)
    n_vis = tcfg.num_vision_tokens if tcfg.family == "vlm" else 0
    assert tuple(tl.shape) == (2, 16 + n_vis, tcfg.vocab_size)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=TOL, rtol=TOL)
    assert abs(float(taux) - float(jaux)) < TOL
    rl, raux = M.forward_train(tp, tcfg, tb, remat=True)
    assert np.array_equal(rl.detach().numpy(), tl.detach().numpy())
    assert float(raux) == float(taux)

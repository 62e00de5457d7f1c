"""The port's sharding rules on real process groups (CPU, gloo).

Reduced smollm-360m's params, distributed as DTensors with the placements
of ``params_shardings`` on a 1x1, a (1, 2) and a (2, 1) ("data", "model")
mesh of spawned gloo ranks, come back bit for bit, and each rank's local
shapes equal JAX's ``NamedSharding(AbstractMesh, spec).shard_shape`` of
the stacked counterpart (layer axis dropped). Each group runs in its own
processes under a 120 s limit, so a hung group fails the test instead of
holding the suite.
"""
import json
import multiprocessing as mp

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.sharding import specs as JSH
from repro_torch.models import convert

from _torch_mesh import gloo_worker

TIMEOUT_S = 120


def _jax_local_shapes(data, model):
    mesh = AbstractMesh((data, model), ("data", "model"))
    params = jax.eval_shape(
        lambda k: JM.init_params(jax_config("smollm-360m").reduced(), k,
                                 dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    shardings = JSH.params_shardings(mesh, params)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    local, full = {}, {}
    for (path, leaf), sh in zip(flat, jax.tree_util.tree_leaves(shardings)):
        key = "/".join(str(getattr(p, "key", "")) for p in path)
        local[key] = list(sh.shard_shape(leaf.shape))
        full[key] = list(leaf.shape)
    return local, full


def _run_group(tmp_path, data, model):
    world = data * model
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=gloo_worker,
                         args=(r, world, str(tmp_path / "init"),
                               str(tmp_path), data, model))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT_S)
        hung = [p.pid for p in procs if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert not hung, f"ranks {hung} still running after {TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * world
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.mark.parametrize("data,model", [(1, 1), (1, 2), (2, 1)])
def test_params_round_trip_as_dtensors(tmp_path, data, model):
    ranks = _run_group(tmp_path, data, model)
    want, full = _jax_local_shapes(data, model)
    stacked = set(convert.STACKED)
    for rank in ranks:
        assert rank["same"], "a leaf did not come back bit for bit"
        assert len(rank["local"]) > len(want)
        for path, shape in rank["local"].items():
            parts = path.split("/")
            if parts[0] in stacked:
                assert shape == want["/".join([parts[0]] + parts[2:])][1:]
            else:
                assert shape == want[path], path
    assert sorted(tuple(r["coordinate"]) for r in ranks) == sorted(
        (d, m) for d in range(data) for m in range(model))
    split = [k for k in want if want[k] != full[k]]
    assert bool(split) == (model > 1), split   # the weights shard on "model"

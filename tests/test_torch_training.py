"""The port's training against the JAX package's, on the CPU.

Weights come from ``repro.models.model.init_params`` and cross through
numpy (``from_jax_params``); batches come from each package's own data
streams with the same seed. The JAX side runs its ``ref`` path: its Pallas
K1 and K5 have no gradient (``jax.grad`` through ``pallas_call`` raises),
so ``jax.grad`` of the plain path is the target.

Tolerances: the loss within 1e-5 and every gradient leaf within
1e-4·max(1, ‖g‖∞) in float32 (XLA and torch sum in different orders), for
every family. The SSM and hybrid ones share it: the port's plain chunked
SSD sums its decay exponents in float64 (kernels/ref.py
``ssd_scan_chunked``) and JAX's in float32, yet their worst gradient leaf
differs by about 1e-6 of max(1, ‖g‖∞), as the dense ones do. MoE layers
run capacity dispatch here, as the training forward routes; the reduced configs' capacity (C = T) never
binds, so it is dropless in effect and both packages keep every token.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as JM
from repro.training import checkpoint as JCKPT
from repro.training import data as JD
from repro.training import optimizer as JOPT
from repro.training import train as JT
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models.convert import (from_jax_params, opt_state_from_jax,
                                        opt_state_to_jax, to_jax_params)
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import data as D
from repro_torch.training import optimizer as OPT
from repro_torch.training import train as T

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(3)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4

# one reduced model of each family
FAMILY_ARCHS = ["smollm-360m", "phi3.5-moe-42b-a6.6b", "qwen2-vl-7b",
                "whisper-base", "mamba2-130m", "zamba2-1.2b"]


def _pair(arch, key=KEY):
    jcfg = jax_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    jp = JM.init_params(jcfg, key, max_positions=256)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, jp, tcfg, tp


def _batches(jcfg, tcfg, B=2, S=16, seed=1, stream="uniform"):
    js = getattr(JD, f"{stream}_stream")(jcfg, B, S, 1, seed=seed)
    ts = getattr(D, f"{stream}_stream")(tcfg, B, S, 1, seed=seed)
    return next(js), next(ts)


def _assert_trees_close(got, want, tol, path=""):
    """``got``: the port's tree as numpy (``to_jax_params``), ``want``: the
    reference's; each leaf within tol·max(1, ‖want‖∞)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], tol, f"{path}/{k}")
        return
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, path
    lim = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{path}: max err {err:.3e} > {lim:.3e}"


def _jax_loss_and_grads(jcfg, jp, batch, **kw):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JT.lm_loss(p, jcfg, b, **kw)[0]))
    return fn(jp, batch)


# ----------------------------------------------------------- optimizer
def test_lr_schedule_matches_reference():
    cfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    jcfg = JOPT.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                            min_lr_frac=0.1)
    assert float(OPT.lr_at(cfg, 0)) == 0.0
    assert float(OPT.lr_at(cfg, 10)) == pytest.approx(1e-3, rel=1e-3)
    assert float(OPT.lr_at(cfg, 100)) == pytest.approx(1e-4, rel=1e-2)
    assert float(OPT.lr_at(cfg, 55)) < 1e-3
    for step in (0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 150):
        got = OPT.lr_at(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        want = float(JOPT.lr_at(jcfg, jnp.int32(step)))
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_adamw_converges_quadratic_as_the_reference():
    """AdamW drives a toy quadratic to its minimum, step for step with the
    reference's updates."""
    cfg = OPT.AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0,
                          total_steps=200, min_lr_frac=1.0)
    jcfg = JOPT.AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0,
                            total_steps=200, min_lr_frac=1.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    jparams = {"w": jnp.asarray([5.0, -3.0])}
    state, jstate = OPT.init_state(params), JOPT.init_state(jparams)
    for i in range(150):
        params, state, _ = OPT.apply_updates(cfg, params,
                                             {"w": 2 * params["w"]}, state)
        jparams, jstate, _ = JOPT.apply_updates(jcfg, jparams,
                                                {"w": 2 * jparams["w"]},
                                                jstate)
        if i < 20:
            np.testing.assert_allclose(params["w"].numpy(),
                                       np.asarray(jparams["w"]), rtol=1e-5,
                                       atol=1e-6)
    assert float(params["w"].abs().max()) < 0.05
    assert int(state["step"]) == 150 and state["step"].dtype == torch.int32


def test_grad_clip_applied():
    params = {"w": torch.ones((4,))}
    cfg = OPT.AdamWConfig(grad_clip=0.1)
    state = OPT.init_state(params)
    _, _, m = OPT.apply_updates(cfg, params, {"w": torch.full((4,), 100.0)},
                                state)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_apply_updates_matches_reference_on_a_nested_tree():
    """Weight decay on every leaf, clipping, bias corrections and the
    state's structure, on a tree with a per-layer list (stacked in JAX)."""
    rng = np.random.default_rng(0)
    layers = [{"a": rng.normal(size=(3, 4)), "b": rng.normal(size=(4,))}
              for _ in range(2)]
    top = rng.normal(size=(5,))
    grads_np = [{"a": rng.normal(size=(3, 4)) * 3,
                 "b": rng.normal(size=(4,)) * 3} for _ in range(2)]
    gtop = rng.normal(size=(5,)) * 3
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    params = {"layers": [{k: f32(v) for k, v in lp.items()} for lp in layers],
              "top": f32(top)}
    grads = {"layers": [{k: f32(v) for k, v in g.items()} for g in grads_np],
             "top": f32(gtop)}
    stack = lambda ls, k: jnp.asarray(np.stack([l[k] for l in ls]),
                                      jnp.float32)
    jparams = {"layers": {k: stack(layers, k) for k in ("a", "b")},
               "top": jnp.asarray(top, jnp.float32)}
    jgrads = {"layers": {k: stack(grads_np, k) for k in ("a", "b")},
              "top": jnp.asarray(gtop, jnp.float32)}
    cfg = OPT.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jcfg = JOPT.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    state, jstate = OPT.init_state(params), JOPT.init_state(jparams)
    for _ in range(3):
        params, state, m = OPT.apply_updates(cfg, params, grads, state)
        jparams, jstate, jm = JOPT.apply_updates(jcfg, jparams, jgrads,
                                                 jstate)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-6)
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    for ours, theirs in ((params, jparams), (state["mu"], jstate["mu"]),
                         (state["nu"], jstate["nu"])):
        _assert_trees_close(to_jax_params(ours), jax.tree.map(np.asarray,
                                                              theirs), 1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3


# ------------------------------------------------------- loss and grads
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    """lm_loss (with the MoE aux loss) and the gradient of every params
    leaf, on one reduced model of each family."""
    jcfg, jp, tcfg, tp = _pair(arch)
    jb, tb = _batches(jcfg, tcfg)
    jloss, jgrads = _jax_loss_and_grads(jcfg, jp, jb)
    loss, parts, grads = T.loss_and_grads(tp, tcfg, tb)
    assert abs(float(loss) - float(jloss)) < LOSS_TOL
    if tcfg.family == "moe":
        _, jparts = JT.lm_loss(jp, jcfg, jb)
        assert float(parts["aux"]) > 0
        assert abs(float(parts["aux"]) - float(jparts["aux"])) < LOSS_TOL
    _assert_trees_close(to_jax_params(grads), jax.tree.map(np.asarray, jgrads),
                        GRAD_TOL)


@pytest.mark.parametrize("impl", ["softmax", "logsumexp"])
def test_both_loss_levers_match_jax(impl, monkeypatch):
    monkeypatch.setenv("REPRO_LOSS_IMPL", impl)
    jcfg, jp, tcfg, tp = _pair("smollm-360m")
    jb, tb = _batches(jcfg, tcfg, S=24, seed=4)
    jloss, jgrads = _jax_loss_and_grads(jcfg, jp, jb)
    loss, _, grads = T.loss_and_grads(tp, tcfg, tb)
    assert abs(float(loss) - float(jloss)) < LOSS_TOL
    _assert_trees_close(to_jax_params(grads), jax.tree.map(np.asarray, jgrads),
                        GRAD_TOL)


def test_loss_levers_agree_and_an_unknown_one_raises(monkeypatch):
    _, _, tcfg, tp = _pair("smollm-360m")
    batch = next(D.uniform_stream(tcfg, 2, 24, 1, seed=4))
    out = {}
    for impl in ("softmax", "logsumexp"):
        monkeypatch.setenv("REPRO_LOSS_IMPL", impl)
        out[impl] = T.loss_and_grads(tp, tcfg, batch)
    assert abs(float(out["softmax"][0] - out["logsumexp"][0])) < 1e-5
    _assert_trees_close(to_jax_params(out["logsumexp"][2]),
                        to_jax_params(out["softmax"][2]), 1e-5)
    monkeypatch.setenv("REPRO_LOSS_IMPL", "bogus")
    with pytest.raises(ValueError, match="REPRO_LOSS_IMPL"):
        T.lm_loss(tp, tcfg, batch)


def test_remat_matches_no_remat():
    """torch.utils.checkpoint per layer recomputes the same function."""
    _, _, tcfg, tp = _pair("qwen2.5-3b")
    batch = next(D.uniform_stream(tcfg, 2, 16, 1, seed=1))
    l1, _, g1 = T.loss_and_grads(tp, tcfg, batch, remat=False)
    l2, _, g2 = T.loss_and_grads(tp, tcfg, batch, remat=True)
    assert abs(float(l1 - l2)) < 1e-5
    _assert_trees_close(to_jax_params(g2), to_jax_params(g1), 1e-4)


def test_loss_mask_matches_jax():
    jcfg, jp, tcfg, tp = _pair("smollm-360m")
    jb, tb = _batches(jcfg, tcfg, seed=2)
    full, _ = T.lm_loss(tp, tcfg, tb)
    mask = torch.zeros_like(tb["tokens"])
    mask[:, :8] = 1
    masked, _ = T.lm_loss(tp, tcfg, dict(tb, loss_mask=mask))
    jmasked, _ = JT.lm_loss(jp, jcfg, dict(
        jb, loss_mask=jnp.zeros_like(jb["tokens"]).at[:, :8].set(1)))
    assert float(full) != pytest.approx(float(masked))
    assert abs(float(masked) - float(jmasked)) < LOSS_TOL


def test_every_leaf_gets_a_gradient():
    """No leaf is left without a gradient (the silent-gradient fault K1's
    autograd Function guards against on the card): tied embeddings get
    the lookup's part plus the unembedding's."""
    _, _, tcfg, tp = _pair("smollm-360m")
    assert tcfg.tie_embeddings
    batch = next(D.arithmetic_stream(tcfg, 2, 16, 1, seed=0))
    _, _, grads = T.loss_and_grads(tp, tcfg, batch)
    for g in OPT.tree_leaves(grads):
        assert g is not None and bool(g.abs().sum() > 0)


# ---------------------------------------------------------- the loop
def test_five_steps_match_jax_train_loop():
    """ROADMAP item 9's gate: 5 steps of reduced smollm-360m from converted
    params, each step's loss within 1e-5 of repro.training.train.train_loop,
    and the final params within the gradient tolerance."""
    jcfg, jp, tcfg, tp = _pair("smollm-360m", jax.random.PRNGKey(0))
    jopt = JOPT.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=5)
    topt = OPT.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=5)
    jp2, js, jh = JT.train_loop(jcfg, jp, JD.arithmetic_stream(
        jcfg, 4, 32, 5, seed=0), jopt, log_every=1, log=lambda *_: None)
    lines = []
    tp2, ts, th = T.train_loop(tcfg, tp, D.arithmetic_stream(
        tcfg, 4, 32, 5, seed=0), topt, log_every=1, log=lines.append)
    assert [i for i, _ in th] == [i for i, _ in jh] == list(range(5))
    for (_, a), (_, b) in zip(th, jh):
        assert abs(a - b) < LOSS_TOL, (th, jh)
    assert th[-1][1] < th[0][1]
    assert all("loss" in l and "lr" in l and "gnorm" in l for l in lines)
    _assert_trees_close(to_jax_params(tp2), jax.tree.map(np.asarray, jp2),
                        GRAD_TOL)
    assert int(ts["step"]) == int(js["step"]) == 5


def test_train_step_does_not_touch_its_inputs():
    _, _, tcfg, tp = _pair("smollm-360m")
    before = [t.clone() for t in OPT.tree_leaves(tp)]
    step = T.make_train_step(tcfg, OPT.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                   total_steps=4))
    state = OPT.init_state(tp)
    p2, s2, m = step(tp, state, next(D.uniform_stream(tcfg, 2, 16, 1)))
    assert all(torch.equal(a, b) for a, b in zip(before, OPT.tree_leaves(tp)))
    assert int(state["step"]) == 0 and int(s2["step"]) == 1
    assert any(not torch.equal(a, b) for a, b in
               zip(OPT.tree_leaves(tp), OPT.tree_leaves(p2)))
    assert not any(t.requires_grad for t in OPT.tree_leaves(p2))
    assert float(m["grad_norm"]) > 0


# ---------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2-vl-7b",
                                  "whisper-base"])
@pytest.mark.parametrize("stream", ["arithmetic", "uniform"])
def test_data_streams_are_the_references(arch, stream):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    js = getattr(JD, f"{stream}_stream")(jcfg, 3, 12, 3, seed=7)
    ts = getattr(D, f"{stream}_stream")(tcfg, 3, 12, 3, seed=7)
    n = 0
    for jb, tb in zip(js, ts):
        assert set(jb) == set(tb)
        assert tb["tokens"].dtype == torch.int64
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        n += 1
    assert n == 3


# ---------------------------------------------------------- checkpoints
def _leaves_equal(a, b):
    fa, fb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("arch", ["mamba2-130m", "whisper-base",
                                  "phi3.5-moe-42b-a6.6b"])
def test_checkpoints_cross_load_bit_for_bit(arch, tmp_path):
    """A checkpoint written by either package restores in the other, params
    and AdamW state, bit for bit."""
    jcfg, jp, tcfg, tp = _pair(arch)
    # one AdamW step on seeded gradients: a non-zero state, moved params
    leaves, tdef = jax.tree.flatten(jp)
    rng = np.random.default_rng(5)
    grads = jax.tree.unflatten(tdef, [
        jnp.asarray(rng.normal(size=x.shape), x.dtype) for x in leaves])
    jp, jstate, _ = JOPT.apply_updates(
        JOPT.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4), jp, grads,
        JOPT.init_state(jp))
    tstate = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg)
    # JAX writes, the port restores into its own templates
    p1 = str(tmp_path / "jax.npz")
    JCKPT.save(p1, jp, jstate, {"arch": jcfg.name})
    zeros = OPT.tree_map(torch.zeros_like, tp)
    rp, rs, meta = CKPT.restore(p1, zeros, OPT.init_state(zeros))
    assert meta["arch"] == jcfg.name
    assert all(torch.equal(a, b) for a, b in
               zip(OPT.tree_leaves(rp), OPT.tree_leaves(tp)))
    assert all(torch.equal(a, b) for a, b in
               zip(OPT.tree_leaves(rs), OPT.tree_leaves(tstate)))
    # the port writes, JAX restores
    p2 = str(tmp_path / "torch.npz")
    CKPT.save(p2, tp, tstate, {"arch": tcfg.name, "step": 1})
    jrp, jrs, meta = JCKPT.restore(p2, jp, jstate)
    assert meta == {"arch": tcfg.name, "step": 1}
    _leaves_equal(jrp, jp)
    _leaves_equal(jrs, jstate)
    # the two files hold the same keys, shapes and bytes
    a, b = np.load(p1), np.load(p2)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_param_and_state_conversions_round_trip():
    jcfg, jp, tcfg, tp = _pair("zamba2-1.2b")
    back = to_jax_params(tp)
    _leaves_equal(back, jax.tree.map(np.asarray, jp))
    jstate = jax.tree.map(np.asarray, JOPT.init_state(jp))
    _leaves_equal(opt_state_to_jax(opt_state_from_jax(jstate, tcfg)), jstate)


# ---------------------------------------------------------- entry point
def test_train_entry_point_on_the_host(tmp_path):
    """``python -m repro_torch.launch.train --device cpu``: logs, tok/s, and
    a checkpoint that the JAX package restores."""
    ck = str(tmp_path / "ck.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--device", "cpu", "--steps", "6", "--seq-len", "16",
         "--batch-size", "2", "--checkpoint", ck],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("loss") >= 6 and "tok/s" in out.stdout
    assert "gnorm" in out.stdout and " lr " in out.stdout
    cfg = jax_config("smollm-360m").reduced()
    jp = JM.init_params(cfg, KEY, max_positions=256)
    rp, rs, meta = JCKPT.restore(ck, jp, JOPT.init_state(jp))
    assert meta["steps"] == 6 and int(rs["step"]) == 6
    assert all(bool(jnp.all(jnp.isfinite(x))) for x in jax.tree.leaves(rp))
    with open(ck + ".meta.json") as f:
        assert json.load(f)["arch"] == "smollm-360m"


def test_train_entry_point_without_a_card_refuses():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--steps", "1"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr

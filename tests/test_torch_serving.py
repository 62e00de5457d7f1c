"""The port's serving path against the JAX package, and the port's hygiene.

Same model as tests/test_serving.py (reduced smollm-360m, PRNGKey(7)),
converted to torch through numpy. Greedy tokens must be identical: the
engine over 32 steps, the dense and paged batchers (with prefix-block
reuse), and FleetRouter's fleet_report() under two policies.
"""
import ast
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
from repro.core.systems import paper_fleet as jax_paper_fleet
from repro.models import model as JM
from repro.serving.batching import PagedContinuousBatcher as JaxPaged
from repro.serving.batching import Request as JaxRequest
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.router import FleetRouter as JaxRouter
from repro_torch.configs import get_config
from repro_torch.core.systems import paper_fleet
from repro_torch.models.convert import from_jax_params
from repro_torch.serving.batching import (ContinuousBatcher,
                                          PagedContinuousBatcher, Request)
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.router import FleetRouter

ROOT = Path(__file__).resolve().parents[1]
ARCH = "smollm-360m"


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_config(ARCH).reduced()
    jp = JM.init_params(jcfg, jax.random.PRNGKey(7))
    tp = from_jax_params(jax.tree.map(np.asarray, jp),
                         get_config(ARCH).reduced())
    return (JaxEngine(jcfg, jp, max_len=96),
            InferenceEngine(get_config(ARCH).reduced(), tp, max_len=96,
                            device="cpu"))


def _prompts(vocab):
    """Three prompts sharing a 40-token prefix (prefix-block reuse), one
    unrelated."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, vocab, size=40)
    out = [np.concatenate([base, rng.integers(0, vocab, size=n)])
           for n in (3, 9, 17)]
    return out + [rng.integers(0, vocab, size=11)]


def test_engine_greedy_matches_jax_over_32_steps(engines):
    jeng, teng = engines
    rng = np.random.default_rng(1)
    toks = rng.integers(0, teng.cfg.vocab_size, size=(2, 9)).astype(np.int32)
    want = jeng.generate({"tokens": jnp.asarray(toks)}, 32).tokens
    got = teng.generate({"tokens": torch.from_numpy(toks)}, 32)
    assert got.tokens.shape == (2, 32) and got.steps == 32
    np.testing.assert_array_equal(got.tokens, want)


def test_engine_eos_and_sampling(engines):
    _, teng = engines
    prompt = {"tokens": np.arange(8, dtype=np.int32)[None]}
    free = teng.generate(prompt, 8).tokens
    stop = teng.generate(prompt, 8, eos_id=int(free[0, 2])).tokens
    np.testing.assert_array_equal(stop[0], free[0, :stop.shape[1]])
    assert stop.shape[1] <= 3
    a = teng.generate(prompt, 5, temperature=0.8).tokens
    b = teng.generate(prompt, 5, temperature=0.8).tokens
    c = teng.generate(prompt, 5, temperature=0.8,
                      generator=torch.Generator().manual_seed(3)).tokens
    np.testing.assert_array_equal(a, b)
    assert c.shape == a.shape


def test_batchers_token_parity_and_prefix_reuse(engines):
    """Paged tokens == the torch dense batcher's == the JAX paged batcher's,
    and the shared prefix is served from shared blocks."""
    jeng, teng = engines
    prompts = _prompts(teng.cfg.vocab_size)
    n = 6

    def run(cb, mk):
        reqs = [mk(i, p, n) for i, p in enumerate(prompts)]
        for r in reqs:
            cb.submit(r)
        cb.run()
        assert all(r.done for r in reqs)
        return [list(r.out_tokens) for r in reqs]

    dense = run(ContinuousBatcher(teng, slots=2), Request)
    paged_cb = PagedContinuousBatcher(teng, slots=2, num_blocks=32,
                                      block_size=8, chunk=16)
    paged = run(paged_cb, Request)
    jax_cb = JaxPaged(jeng, slots=2, num_blocks=32, block_size=8, chunk=16)
    jax_paged = run(jax_cb, JaxRequest)
    assert paged == dense
    assert paged == jax_paged
    assert paged_cb.stats() == jax_cb.stats()
    assert paged_cb.stats()["prefix_hits"] > 0
    solo = teng.generate({"tokens": prompts[3][None].astype(np.int32)}, n)
    assert paged[3] == list(solo.tokens[0])


def test_paged_batcher_rejects_oversized_request(engines):
    _, teng = engines
    cb = PagedContinuousBatcher(teng, slots=1, num_blocks=8, block_size=8)
    with pytest.raises(ValueError, match="worst-case context"):
        cb.submit(Request(0, np.arange(60), max_new_tokens=30))


@pytest.mark.parametrize("policy", ["threshold", "capacity_aware"])
@pytest.mark.parametrize("paged", [False, True])
def test_router_fleet_report_matches_jax(engines, policy, paged):
    jeng, teng = engines
    prompts = [np.arange(m) % teng.cfg.vocab_size for m in (6, 64, 6, 64)]
    routers = []
    for Router, fleet, eng in ((JaxRouter, jax_paper_fleet, jeng),
                               (FleetRouter, paper_fleet, teng)):
        eff, perf = fleet()
        r = Router(eng.cfg, {"eff": eff, "perf": perf},
                   {"eff": eng, "perf": eng}, policy=policy, t_in=32,
                   counts={eff.name: 4, perf.name: 1})
        if paged:
            r.attach_batchers(slots=2, paged=True, num_blocks=32,
                              block_size=16)
        routed = [r.submit(p, 4) for p in prompts]
        r.drain() if paged else None
        routers.append((r, routed))
    (jr, jrouted), (tr, trouted) = routers
    assert tr.fleet_report() == jr.fleet_report()
    for a, b in zip(jrouted, trouted):
        assert (a.pool, a.energy_j, a.runtime_s) == (b.pool, b.energy_j,
                                                      b.runtime_s)
        ta = a.request.out_tokens if paged else list(a.output)
        tb = b.request.out_tokens if paged else list(b.output)
        assert ta == tb


# ------------------------------------------------------------------ hygiene
def _port_files():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_reference_package():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert len(_port_files()) > 30
    # training joined the port: its modules and entry point are held too
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {f"src/repro_torch/training/{m}.py" for m in
            ("optimizer", "data", "checkpoint", "train")} <= names
    assert "src/repro_torch/launch/train.py" in names
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch, repro_torch.kernels.ops, "
            "repro_torch.serving.router, repro_torch.launch.serve, "
            "repro_torch.core, repro_torch.core.simulator, "
            "repro_torch.core.fleet, repro_torch.core.fleet_vec, "
            "repro_torch.core.carbon, repro_torch.core.region, "
            "repro_torch.training.train, repro_torch.training.checkpoint, "
            "repro_torch.training.data, repro_torch.launch.train; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_engine_without_device_needs_a_card(engines):
    """No device means the card; without one the engine raises rather than
    falling back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, teng = engines
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(teng.cfg, teng.params)
    with pytest.raises(ValueError, match="params live on"):
        InferenceEngine(teng.cfg, teng.params, device="meta")


def test_serve_entry_point_on_the_host():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "3", "--max-new-tokens", "3", "--fleet", "paper"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("req") == 3 and "fleet report" in out.stdout


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or without a card, the smoke prints no result
    and exits non-zero."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and '"ok": true' not in out.stdout
    if not torch.cuda.is_available():
        out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and '"ok": true' not in out.stdout

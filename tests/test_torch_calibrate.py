"""The port's measure -> fit -> price loop against the JAX package's
(``benchmarks/microbench.py kernel_phase_samples``, ``benchmarks/calibrate.py``,
``benchmarks/autotune_sweep.py _oracle_refresh``, ``repro.core.pricing``):

  * ``kernel_phase_samples`` on the plain path gives the reference's cells
    and work counts in the reference's order, pins each cell's tuned winner,
    and counts bf16 cells in two-byte elements where the rule says so;
  * the synthetic artifacts equal a fresh JAX run's, and the committed
    ones on their calibrations and fit error;
  * ``fit_calibration``, ``CalibratedOracle``, ``TableOracle.from_autotune``
    and ``oracle_refresh`` equal JAX's on the same samples;
  * the JAX package's five committed calibrations price llama2-7b bit for
    bit through both packages;
  * ``price_fleet`` equals JAX's ``headline`` and ``threshold_sweep`` on an
    identical profile built in JAX from ``H100_SXM``'s fields;
  * the CLI on the CPU writes an artifact that loads back, and without a
    card and without ``--device cpu`` exits non-zero.

Everything here runs on the CPU (backend "ref"); the "cuda" backend is
timed on the card by chip_smoke.py phase 14.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import benchmarks.calibrate as JCAL
import benchmarks.microbench as JMB
from repro.configs import get_config as jget_config
from repro.core import pricing as JP
from repro.core import simulator as JSIM
from repro.core import systems as JSYS
from repro.core.workload import alpaca_like as jalpaca_like
from repro.kernels import autotune as JAT
from repro_torch.configs import get_config
from repro_torch.core import pricing as P
from repro_torch.core.systems import PROFILES
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import ops, timing
from repro_torch.launch import calibrate as C

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(prefill_lens=(32, 64), decode_ctxs=(32, 64), paged_ctxs=(32,),
             migrate_blocks=(2,), ssm_lens=(64,), iters=1)


def _counts(samples):
    return [(s.kernel, s.flops, s.bytes, s.ctx) for s in samples]


def _jax_profile(p):
    """An identical JAX SystemProfile built from a port profile's fields."""
    return JSYS.SystemProfile(**{f.name: getattr(p, f.name)
                                 for f in dataclasses.fields(p)})


def _jax_samples(samples):
    return [JP.KernelSample(**dataclasses.asdict(s)) for s in samples]


# ------------------------------------------------------------ the samples
def test_phase_samples_are_the_reference_cells_in_its_order():
    got = timing.kernel_phase_samples(backend="ref", **SMALL)
    want = JMB.kernel_phase_samples(backend="ref", **SMALL)
    assert _counts(got) == _counts(want)
    assert [s.kernel for s in got] == [
        "flash_attention", "flash_attention", "decode_attention",
        "decode_attention", "paged_decode_quant", "kv_migrate", "ssm_scan"]
    assert all(s.t_s > 0 and s.noise_frac >= 0.0 for s in got)


def _tuned_caches():
    """The same winners in a port cache and a JAX cache, "ref" key."""
    rows = [("flash_attention", "s64", {"block_q": 128}),
            ("decode_attention", "b1c32", {}),
            ("paged_decode_quant", "b1c32", {"impl": "fused"}),
            ("ssm_scan", "s64", {"chunk": 32})]
    mk = dict(t_s=1e-3, t_default_s=2e-3, noise_frac=0.0, flops=1.0,
              bytes=1.0, ctx=0.0)
    port = AT.AutotuneCache("t", "ref", entries=[
        AT.TunedEntry(kernel=k, backend="ref", bucket=b, params=p, **mk)
        for k, b, p in rows])
    jax_cache = JAT.AutotuneCache("t", "ref", entries=[
        JAT.TunedEntry(kernel=k, backend="ref", bucket=b, params=p, **mk)
        for k, b, p in rows])
    return port, jax_cache


def test_tuned_cells_run_with_their_buckets_winners_pinned(monkeypatch):
    seen = []

    def spy(name):
        orig = getattr(ops, name)

        def f(*a, **kw):
            seen.append((name, {k: v for k, v in kw.items()
                                if k not in ("backend", "causal")}))
            return orig(*a, **kw)
        return f

    for name in ("flash_attention", "decode_attention",
                 "paged_decode_attention_quant", "ssd_scan"):
        monkeypatch.setattr(timing.ops, name, spy(name))
    port, jax_cache = _tuned_caches()
    kw = dict(prefill_lens=(64,), decode_ctxs=(32,), paged_ctxs=(32,),
              migrate_blocks=(2,), ssm_lens=(64,), iters=1)
    got = timing.kernel_phase_samples(backend="ref", tuned=port, **kw)
    # every call of a cell (two warm-ups, one timed) carries its winner
    assert seen == [("flash_attention", {"block_q": 128})] * 3 \
        + [("decode_attention", {})] * 3 \
        + [("paged_decode_attention_quant", {"impl": "fused"})] * 3 \
        + [("ssd_scan", {"chunk": 32})] * 3
    want = JMB.kernel_phase_samples(backend="ref", tuned=jax_cache, **kw)
    assert _counts(got) == _counts(want)
    # a cache under the other lookup key pins nothing
    seen.clear()
    cuda = AT.AutotuneCache("t", "cuda", entries=[dataclasses.replace(
        e, backend="cuda") for e in port.entries.values()])
    timing.kernel_phase_samples(backend="ref", tuned=cuda, **kw)
    assert seen[-1] == ("ssd_scan", {"chunk": 128})


@pytest.mark.parametrize("kernel,shape,params", [
    ("flash_attention", {"s": 32}, None),
    ("decode_attention", {"b": 2, "c": 32}, None),
    ("paged_decode_quant", {"b": 2, "c": 32}, {"impl": "gather"}),
    ("paged_decode_quant", {"b": 2, "c": 32}, {"impl": "fused"}),
    ("kv_migrate", {"blocks": 3}, None),
    ("ssm_scan", {"s": 32}, {"chunk": 16})])
def test_bf16_counts_follow_the_element_size_rule(kernel, shape, params):
    """q, k, v, x, B, C, the outputs and the gathered copies at two bytes;
    int8 pools at one; scale columns, dt, A and the plain path's float32
    scores at four. FLOPs do not change."""
    f32 = timing.time_kernel(kernel, shape, params=params, backend="ref",
                             iters=1)
    bf = timing.time_kernel(kernel, shape, params=params, backend="ref",
                            iters=1, dtype=torch.bfloat16)
    hq, hkv, dh, P_, N, blk = 4, 2, 64, 64, 64, 16
    if kernel == "flash_attention":
        S = shape["s"]
        elems = 2 * hq * S * dh + 2 * hkv * S * dh
        four = 3 * hq * S * S
        one = 0
    elif kernel == "decode_attention":
        B, c = shape["b"], shape["c"]
        elems = 2 * B * hkv * c * dh + 2 * B * hq * dh
        four, one = 3 * B * hq * c, 0
    elif kernel == "paged_decode_quant":
        B, c = shape["b"], shape["c"]
        elems = 2 * B * hq * dh + (4 * B * hkv * c * dh
                                   if params["impl"] == "gather" else 0)
        four = 2 * B * hkv * c + 3 * B * hq * c
        one = 2 * B * hkv * c * dh
    elif kernel == "kv_migrate":
        elems, four, one = 2 * 2 * shape["blocks"] * hkv * blk * dh, 0, 0
    else:
        S = shape["s"]
        elems, four, one = 2 * hq * S * P_ + 2 * S * N, hq * S, 0
    assert f32.bytes == 4 * elems + 4 * four + one
    assert bf.bytes == 2 * elems + 4 * four + one
    assert (bf.kernel, bf.flops, bf.ctx) == (f32.kernel, f32.flops, f32.ctx)


def test_cuda_phase_samples_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.kernel_phase_samples(**SMALL)


# ------------------------------------------------------------ the fits
def test_synthetic_artifacts_equal_a_fresh_jax_run(tmp_path):
    names = ["m1-pro", "swing-a100", "tpu-v5e-perf", "tpu-v5lite-eff"]
    assert C.run_synthetic(names, out_dir=str(tmp_path / "port"))
    assert JCAL.run_synthetic(names, out_dir=str(tmp_path / "jax"))
    for name in names:
        port = json.loads((tmp_path / "port" / f"{name}.json").read_text())
        fresh = json.loads((tmp_path / "jax" / f"{name}.json").read_text())
        assert port == fresh
        # the committed files predate KernelSample.noise_frac
        committed = json.loads(
            (ROOT / "experiments" / "calibration" / f"{name}.json")
            .read_text())
        assert port["calibrations"] == committed["calibrations"]
        assert port["fit_rel_rmse"] == committed["fit_rel_rmse"]
    m1 = json.loads((tmp_path / "port" / "m1-pro.json").read_text())
    assert m1["calibrations"][0]["compute_eff"] == 0.3897632574287153


def _measured_samples():
    """Seeded timings with noise off the roofline: the fit has work to do."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(14):
        f = float(10 ** rng.uniform(6, 10))
        b = float(10 ** rng.uniform(5, 8))
        t = float(10 ** rng.uniform(-4.5, -2.0))
        out.append(P.KernelSample(("flash_attention", "decode_attention")[i % 2],
                                  f, b, float(rng.integers(0, 4096)), t,
                                  float(rng.uniform(0.0, 0.3))))
    return out


@pytest.mark.parametrize("profile", [C.H100_SXM, C.HOST_CPU])
def test_fit_and_calibrated_oracle_equal_jax(profile):
    samples = _measured_samples()
    cal = P.fit_calibration(profile, samples)
    jcal = JP.fit_calibration(_jax_profile(profile), _jax_samples(samples))
    assert dataclasses.asdict(cal) == dataclasses.asdict(jcal)
    cfg, jcfg = get_config("llama2-7b"), jget_config("llama2-7b")
    o, jo = P.CalibratedOracle([cal]), JP.CalibratedOracle([jcal])
    for m, n in ((1, 1), (32, 32), (300, 77), (4096, 512)):
        assert dataclasses.asdict(o.phases(cfg, m, n, profile)) == \
            dataclasses.asdict(jo.phases(jcfg, m, n, _jax_profile(profile)))


def test_from_autotune_equals_jax():
    samples = _measured_samples()[:6]
    kinds = ("flash_attention", "decode_attention", "paged_decode_quant",
             "ssm_scan", "flash_attention", "ssm_scan")
    rows = [dict(kernel=k, backend="cuda", bucket=f"s{64 << i}",
                 params={}, t_s=s.t_s, t_default_s=s.t_s * 1.2,
                 noise_frac=s.noise_frac, flops=s.flops, bytes=s.bytes,
                 ctx=s.ctx) for i, (k, s) in enumerate(zip(kinds, samples))]
    port = AT.AutotuneCache("h100", "cuda",
                            entries=[AT.TunedEntry(**r) for r in rows])
    jax_cache = JAT.AutotuneCache("h100", "cuda",
                                  entries=[JAT.TunedEntry(**r) for r in rows])
    p, jp = C.H100_SXM, _jax_profile(C.H100_SXM)
    o = P.TableOracle.from_autotune(get_config("llama2-7b"), p, port)
    jo = JP.TableOracle.from_autotune(jget_config("llama2-7b"), jp, jax_cache)
    assert dataclasses.asdict(o.calibration) == \
        dataclasses.asdict(jo.calibration)
    t, jt = o._tables[(p, 1)], jo._tables[(jp, 1)]
    for f in dataclasses.fields(t):
        np.testing.assert_array_equal(getattr(t, f.name),
                                      getattr(jt, f.name), strict=True)


def test_oracle_refresh_is_the_references(monkeypatch):
    """Every entry re-measured at seed + 1 with its winner pinned (and its
    own heads where ``dims`` says), the rel-RMSE JAX's predictor gives."""
    calls = []

    def timer(kernel, shape, *, params, backend, iters, seed, **kw):
        calls.append((kernel, dict(shape), params, backend, iters, seed, kw))
        r = sum(shape.values())
        return P.KernelSample(kernel, 1e9 * r, 1e7 * r, float(r),
                              2e-5 + 1e-7 * r * (1.1 if seed % 2 else 0.9),
                              0.05)

    shapes = {"flash_attention": [{"s": 1024}], "ssm_scan": [{"s": 512}],
              "paged_decode_quant": [{"b": 8, "c": 1024}, {"b": 4, "c": 544}]}
    cache = AT.autotune(shapes, profile="h100", backend="cuda",
                        timer=timer, iters=3)
    calls.clear()
    key = AT.cache_key("paged_decode_quant", "cuda", "b4c1024")
    out = C.oracle_refresh(cache, C.H100_SXM, iters=3, seed=0, timer=timer,
                           dims={key: {"heads": 32, "kv_heads": 8}})
    entries = sorted(cache.entries.values(), key=lambda e: e.key())
    assert [c[:6] for c in calls] == [
        (e.kernel, e.shape, e.params, "cuda", 3, 1) for e in entries]
    assert [c[6] for c in calls] == [
        {"heads": 32, "kv_heads": 8} if e.key() == key else {}
        for e in entries]
    jp = _jax_profile(C.H100_SXM)
    jcache = JAT.AutotuneCache("h100", "cuda", entries=[
        JAT.TunedEntry(**dataclasses.asdict(e)) for e in entries])
    jcal = JP.TableOracle.from_autotune(jget_config("llama2-7b"), jp,
                                        jcache).calibration
    again = [timer(e.kernel, e.shape, params=e.params, backend="cuda",
                   iters=3, seed=1) for e in entries]
    pred = JP._predict(_jax_samples(again), jp, jcal.compute_eff,
                       jcal.mem_eff, jcal.sat_ctx, jcal.overhead_s)
    assert out["remeasured_rel_rmse"] == JP._rel_rmse(
        pred, np.array([s.t_s for s in again]))
    assert (out["fit_rel_rmse"], out["compute_eff"], out["mem_eff"],
            out["sat_ctx"], out["overhead_s"], out["n_samples"]) == (
        jcal.fit_rel_rmse, jcal.compute_eff, jcal.mem_eff, jcal.sat_ctx,
        jcal.overhead_s, jcal.n_samples)
    assert out["bound"] == JCAL.MEASURED_REL_RMSE_BOUND
    assert [r["key"] for r in out["remeasured"]] == [e.key() for e in entries]


# ---------------------------------------------------------------- pricing
@pytest.mark.parametrize("name", sorted(
    p.stem for p in (ROOT / "experiments" / "calibration").glob("*.json")))
def test_committed_calibrations_price_bit_for_bit(name):
    """The JAX package's five artifacts load through both packages and price
    llama2-7b on a grid of (m, n) identically."""
    path = str(ROOT / "experiments" / "calibration" / f"{name}.json")
    o, jo = P.CalibratedOracle.load(path), JP.CalibratedOracle.load(path)
    assert {k: dataclasses.asdict(v) for k, v in o.calibrations.items()} == \
        {k: dataclasses.asdict(v) for k, v in jo.calibrations.items()}
    profile = C.HOST_CPU if name == "host-cpu" else PROFILES[name]
    jprofile = JCAL.HOST_CPU if name == "host-cpu" else JSYS.PROFILES[name]
    assert _jax_profile(profile) == jprofile
    cm = P.CostModel(get_config("llama2-7b"), o)
    jcm = JP.CostModel(jget_config("llama2-7b"), jo)
    grid = [1, 7, 32, 128, 513, 2048]
    for m in grid:
        for n in grid:
            assert (cm.cost(m, n, profile), cm.energy(m, n, profile),
                    cm.runtime(m, n, profile)) == \
                (jcm.cost(m, n, jprofile), jcm.energy(m, n, jprofile),
                 jcm.runtime(m, n, jprofile))
    mm, nn = np.meshgrid(grid, grid)
    for f in ("cost_batch", "energy_batch", "runtime_batch"):
        np.testing.assert_array_equal(
            getattr(cm, f)(mm.ravel(), nn.ravel(), profile),
            getattr(jcm, f)(mm.ravel(), nn.ravel(), jprofile), strict=True)
    assert len(o.calibrations) == 1 and \
        o.resolve(profile) != profile


def test_price_fleet_is_the_references_headline_and_sweeps():
    cal = P.Calibration("h100-sxm", compute_eff=0.21, mem_eff=0.47,
                        sat_ctx=5000.0, overhead_s=3.1e-5, fit_rel_rmse=0.1,
                        n_samples=18)
    got = C.price_fleet(cal, n_queries=1500)
    jcfg = jget_config("llama2-7b")
    qs = jalpaca_like(1500, seed=0)
    jh100 = _jax_profile(C.H100_SXM)
    jcm = JP.CostModel(jcfg, JP.CalibratedOracle(
        [JP.Calibration(**dataclasses.asdict(cal))]))
    want = [(JSYS.M1_PRO, jh100, jcm), (*JSYS.paper_fleet(), None)]
    assert [g.pricing for g in got] == ["calibrated h100-sxm", "hand-tuned"]
    assert [g.fleet for g in got] == ["m1-pro+h100-sxm", "m1-pro+swing-a100"]
    for g, (eff, perf, model) in zip(got, want):
        hd = JSIM.headline(jcfg, qs, eff, perf, t_in=32, axis="in",
                           model=model)
        hd2 = JSIM.headline(jcfg, qs, eff, perf, t_in=32, axis="both",
                            paper_faithful=False, model=model)
        assert dataclasses.asdict(g.headline_in) == dataclasses.asdict(hd)
        assert dataclasses.asdict(g.headline_both) == dataclasses.asdict(hd2)
        for axis in ("in", "out"):
            sweep = JSIM.threshold_sweep(jcfg, qs, eff, perf, axis=axis,
                                         model=model)
            assert [dataclasses.asdict(p) for p in g.sweeps[axis]] == \
                [dataclasses.asdict(p) for p in sweep]
            assert dataclasses.asdict(g.optimal[axis]) == \
                dataclasses.asdict(JSIM.optimal_threshold(sweep))
        assert len(g.lines()) == 4
    # the calibration, not the hand-tuned seeds, priced the card
    assert got[0].headline_in.hybrid != JSIM.headline(
        jcfg, qs, JSYS.M1_PRO, jh100, t_in=32, axis="in").hybrid
    with pytest.raises(ValueError, match="calibration for"):
        C.price_fleet(dataclasses.replace(cal, profile="host-cpu"))


def test_h100_profile_is_one_card_with_no_link():
    p = C.H100_SXM
    assert (p.name, p.kind, p.chips, p.peak_flops, p.hbm_bw, p.ici_bw,
            p.link_bw_gbps, p.power_peak_w) == (
        "h100-sxm", "perf", 1, 989e12, 3.35e12, 0.0, 0.0, 700.0)
    assert 0.0 < p.power_idle_w < p.power_peak_w
    assert _jax_profile(C.HOST_CPU) == JCAL.HOST_CPU
    assert (C.SYNTH_REL_RMSE_BOUND, C.MEASURED_REL_RMSE_BOUND) == \
        (JCAL.SYNTH_REL_RMSE_BOUND, JCAL.MEASURED_REL_RMSE_BOUND)


# -------------------------------------------------------------------- CLI
def test_cli_cpu_smoke_writes_an_artifact_that_loads_back(capsys):
    rc = C.main(["--device", "cpu", "--smoke"])
    out = capsys.readouterr().out
    path = out.split("-> ")[1].split()[0]
    try:
        assert os.path.basename(path) == "host-cpu.json"
        data = json.loads(Path(path).read_text())
        cal = P.CalibratedOracle.load(path).calibrations["host-cpu"]
        assert dataclasses.asdict(cal) == data["calibrations"][0]
        assert [s["kernel"] for s in data["samples"]] == [
            "flash_attention", "flash_attention", "decode_attention",
            "decode_attention", "ssm_scan"]
        assert data["mode"] == "measured"
        # the exit code is the fit's bound on the host's noisy clock
        assert rc == (0 if cal.fit_rel_rmse <
                      C.MEASURED_REL_RMSE_BOUND else 1)
    finally:
        shutil.rmtree(os.path.dirname(path))


def test_cli_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.calibrate"],
                       capture_output=True, text=True, env=env, timeout=120,
                       cwd=str(ROOT))
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert "[measured]" not in r.stdout

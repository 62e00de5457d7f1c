"""The port's fleet layer against the JAX package, bit for bit.

``repro_torch.core``'s simulator, fleet engines, carbon extension and region
layer are copies of ``repro.core``'s with only their imports rewritten. Here
each copy is held to its original twice: its syntax tree equals the
original's once ``repro.`` module names read ``repro_torch.``, and every
configuration of tests/test_fleet.py, test_fleet_vec.py, test_autoscale.py,
test_carbon.py, test_region.py, test_energy_model.py and the fleet half of
test_disagg.py gives the same results through both packages: summaries,
records, per-pool accounting and percentiles under both fleet engines, and
``simulate``, ``threshold_sweep`` and ``headline``. Floats are compared by
their exact hex form, so equality is bit for bit (and NaN equals NaN).
"""
import ast
import dataclasses
import importlib
import math
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
COPIES = ("carbon", "simulator", "fleet", "fleet_vec", "region", "pricing",
          "scheduler", "perf_model", "plan", "systems", "workload")
ENGINES = ("event", "vectorized")


# ------------------------------------------------------------ the copies
class _Rename(ast.NodeTransformer):
    def _name(self, name):
        return "repro_torch" + name[5:] if name == "repro" or \
            name.startswith("repro.") else name

    def visit_ImportFrom(self, node):
        node.module = self._name(node.module or "")
        return node

    def visit_Import(self, node):
        for a in node.names:
            a.name = self._name(a.name)
        return node


@pytest.mark.parametrize("module", COPIES)
def test_core_copy_is_the_original_with_imports_renamed(module):
    orig = ast.parse((ROOT / "src/repro/core" / f"{module}.py").read_text())
    copy = ast.parse((ROOT / "src/repro_torch/core" / f"{module}.py")
                     .read_text())
    assert ast.dump(_Rename().visit(orig)) == ast.dump(copy)


def test_core_exports_match():
    jc = importlib.import_module("repro.core")
    tc = importlib.import_module("repro_torch.core")
    names = {n for n in dir(jc) if not n.startswith("_")}
    assert names <= set(dir(tc))


# ---------------------------------------------------------- the packages
def _pkg(root):
    mods = {n: importlib.import_module(f"{root}.{p}") for n, p in (
        ("core", "core"), ("fleet", "core.fleet"), ("carbon", "core.carbon"),
        ("pricing", "core.pricing"), ("region", "core.region"),
        ("plan", "core.plan"), ("configs", "configs"))}
    return SimpleNamespace(**mods)


@pytest.fixture(scope="module")
def pkgs():
    return _pkg("repro"), _pkg("repro_torch")


PCTS = (0.0, 10.0, 50.0, 90.0, 99.0, 100.0)


def canon(x):
    """A package-free, exactly comparable form of a result."""
    if type(x).__name__ == "FleetSimResult":
        return ("FleetSimResult", x.policy, canon(x.summary()),
                canon(x.records), canon(x.per_pool), canon(x.horizon_s),
                canon([x.latency_percentile(p) for p in PCTS]),
                canon([x.ttft_percentile(p) for p in PCTS]),
                canon([x.tpot_percentile(p) for p in PCTS]),
                canon([x.slo_attainment(s) for s in (1.0, 30.0)]),
                canon([x.fleet_j_per_token, x.j_per_token, x.mig_bytes,
                       x.fleet_energy_j, x.idle_energy_j]))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, canon(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return ("dict",) + tuple((canon(k), canon(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, np.ndarray):
        return ("array", str(x.dtype), x.shape, canon(x.tolist()))
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    if isinstance(x, (float, np.floating)):
        return ("f", float(x).hex())
    if x is None or isinstance(x, str):
        return x
    raise TypeError(f"no canonical form for {type(x).__name__}")


def _same(fn, pkgs, *args):
    want, got = (canon(fn(P, *args)) for P in pkgs)
    assert got == want


# ---------------------------------------- fleet scenarios, both engines
# tests/test_fleet.py, test_autoscale.py, test_carbon.py: deepseek-7b over
# paper_fleet()
def _paper(P):
    return P.configs.get_config("deepseek-7b"), *P.core.paper_fleet()


def _spec(P, **kw):
    return P.core.WorkloadSpec(**kw)


def _pools2(P, eff, perf, n_eff=2, n_perf=2, s_eff=1, s_perf=1):
    return {"eff": P.core.PoolSpec(eff, n_eff, s_eff),
            "perf": P.core.PoolSpec(perf, n_perf, s_perf)}


def _diurnal(P, n=120, seed=5, rate=1.0):
    return P.core.sample_workload(n, seed=seed, spec=_spec(P, rate_qps=rate),
                                  arrival_process="diurnal", period_s=240.0,
                                  amplitude=0.9)


def sc_zero_load(P, engine):
    cfg, eff, perf = _paper(P)
    C = P.core
    qs = C.sample_workload(40, seed=3, spec=_spec(P, rate_qps=1e-3))
    sched = C.ThresholdScheduler(cfg, eff, perf, t_in=32)
    blocks = {n: C.PoolSpec(s, len(qs), 1, kv_blocks=4096, block_size=16)
              for n, s in (("eff", eff), ("perf", perf))}
    return [C.simulate(cfg, qs, sched),
            C.simulate_fleet(cfg, qs, _pools2(P, eff, perf, 40, 40), sched,
                             engine=engine),
            C.simulate_fleet(cfg, qs, blocks, sched, engine=engine)]


def sc_mmpp_threshold(P, engine):
    cfg, eff, perf = _paper(P)
    C = P.core
    qs = C.sample_workload(120, seed=7, spec=_spec(P, rate_qps=3.0),
                           arrival_process="mmpp")
    return C.simulate_fleet(cfg, qs, _pools2(P, eff, perf, 2, 1, 2, 4),
                            C.ThresholdScheduler(cfg, eff, perf, t_in=32),
                            engine=engine)


def sc_cost_optimal_mmpp(P, engine):
    cfg, eff, perf = _paper(P)
    C = P.core
    qs = C.sample_workload(100, seed=5, spec=_spec(P, rate_qps=5.0),
                           arrival_process="mmpp")
    return C.simulate_fleet(cfg, qs, _pools2(P, eff, perf, 2, 1, 2, 2),
                            C.CostOptimalScheduler(cfg, [eff, perf]),
                            engine=engine)


def sc_single_pool_capacity(P, engine):
    """Finite capacity, batching slots and both queue disciplines."""
    cfg, eff, perf = _paper(P)
    C = P.core
    sched = C.SingleSystemScheduler(cfg, perf)
    out = []
    for seed, rate, n, shapes in ((2, 8.0, 60, ((1, 1), (60, 1))),
                                  (9, 6.0, 60, ((1, 1), (1, 8)))):
        qs = C.sample_workload(n, seed=seed, spec=_spec(P, rate_qps=rate))
        out += [C.simulate_fleet(cfg, qs, {"perf": C.PoolSpec(perf, i, s)},
                                 sched, engine=engine) for i, s in shapes]
    qs = C.sample_workload(80, seed=11, spec=_spec(P, rate_qps=6.0))
    out += [C.simulate_fleet(cfg, qs, {"perf": C.PoolSpec(perf, 1, 1)}, sched,
                             queue_discipline=d, engine=engine)
            for d in ("fifo", "sjf")]
    return out


def sc_every_policy(P, engine):
    cfg, eff, perf = _paper(P)
    C = P.core
    cp = P.pricing.normalized_cost_params(cfg, perf, lam=0.5)
    scheds = [C.ThresholdScheduler(cfg, eff, perf, t_in=32),
              C.CostOptimalScheduler(cfg, [eff, perf]),
              C.CapacityAwareScheduler(cfg, [eff, perf],
                                       {eff.name: 2, perf.name: 1}, cp),
              C.RoundRobinScheduler(cfg, [eff, perf]),
              C.SingleSystemScheduler(cfg, perf)]
    qs = C.sample_workload(30, seed=1, spec=_spec(P, rate_qps=4.0))
    return [C.simulate_fleet(cfg, qs, _pools2(P, eff, perf), s, engine=engine)
            for s in scheds]


def sc_burst(P, engine):
    cfg, eff, perf = _paper(P)
    C = P.core
    qs = C.sample_workload(150, seed=7, spec=_spec(P, rate_qps=3.0),
                           arrival_process="mmpp")
    pools = {"eff": C.PoolSpec(eff, 4, 2), "perf": C.PoolSpec(perf, 2, 4)}
    cp = P.pricing.normalized_cost_params(cfg, perf, lam=0.9)
    return [C.simulate_fleet(cfg, qs, pools,
                             C.ThresholdScheduler(cfg, eff, perf, t_in=32),
                             engine=engine),
            C.simulate_fleet(cfg, qs, pools, C.CapacityAwareScheduler(
                cfg, [eff, perf], {eff.name: 4, perf.name: 2}, cp),
                engine=engine)]


def sc_block_capacity(P, engine):
    cfg, eff, perf = _paper(P)
    C = P.core
    qs = [C.Query(64, 64, i * 0.01) for i in range(20)]
    tight = [C.Query(64, 64, float(i // 4)) for i in range(24)]
    return [C.simulate_fleet(cfg, qs, {"perf": C.PoolSpec(
                perf, 1, 8, kv_blocks=16, block_size=16)},
                C.SingleSystemScheduler(cfg, perf), engine=engine),
            C.simulate_fleet(cfg, qs, {"perf": C.PoolSpec(perf, 1, 8)},
                             C.SingleSystemScheduler(cfg, perf),
                             engine=engine),
            C.simulate_fleet(cfg, tight, {"perf": C.PoolSpec(
                perf, 2, 4, kv_blocks=16, block_size=16)},
                C.SingleSystemScheduler(cfg, perf), engine=engine)]


def sc_power_states_armed(P, engine):
    cfg, eff, perf = _paper(P)
    C = P.core
    qs = C.sample_workload(80, seed=7, spec=_spec(P, rate_qps=3.0),
                           arrival_process="mmpp")
    eff_t = replace(eff, power_states=C.default_power_states(eff))
    perf_t = replace(perf, power_states=C.default_power_states(perf))
    return [C.simulate_fleet(cfg, qs, {"eff": C.PoolSpec(eff, 3, 2),
                                       "perf": C.PoolSpec(perf, 2, 4)},
                             C.ThresholdScheduler(cfg, eff, perf, t_in=32),
                             engine=engine),
            C.simulate_fleet(cfg, qs, {
                "eff": C.PoolSpec(eff_t, 3, 2, linger_s=math.inf),
                "perf": C.PoolSpec(perf_t, 2, 4, linger_s=math.inf)},
                C.ThresholdScheduler(cfg, eff_t, perf_t, t_in=32),
                engine=engine)]


def sc_sleep_and_wake(P, engine):
    """Linger descent, the off state, a demand wake on a block-bound stall
    and the power machine at a large clock."""
    cfg, eff, perf = _paper(P)
    C = P.core
    Q = C.Query
    out = []
    for gap, state in ((200.0, "sleep"), (400.0, "off")):
        out.append(C.simulate_fleet(
            cfg, [Q(32, 32, 0.0), Q(32, 32, gap)],
            {"perf": C.PoolSpec(perf, 1, 1, linger_s=10.0,
                                sleep_state=state)},
            C.SingleSystemScheduler(cfg, perf), engine=engine))
    out.append(C.simulate_fleet(
        cfg, [Q(32, 32, 0.0), Q(32, 32, 200.0)],
        {"perf": C.PoolSpec(perf, 1, 1)}, C.SingleSystemScheduler(cfg, perf),
        engine=engine))
    out.append(C.simulate_fleet(
        cfg, [Q(64, 512, 0.0), Q(8, 8, 20.0)],
        {"eff": C.PoolSpec(eff, 2, 2, kv_blocks=36, block_size=16,
                           linger_s=10.0)},
        C.SingleSystemScheduler(cfg, eff), engine=engine))
    off = 2.0e5
    out.append(C.simulate_fleet(
        cfg, [Q(32, 32, off), Q(32, 32, off + 300.0)],
        {"perf": C.PoolSpec(perf, 1, 1, linger_s=10.0)},
        C.SingleSystemScheduler(cfg, perf), engine=engine))
    qs = C.sample_workload(100, seed=2, spec=_spec(P, rate_qps=4.0),
                           arrival_process="mmpp")
    out.append(C.simulate_fleet(
        cfg, qs, {"eff": C.PoolSpec(eff, 3, 2, linger_s=5.0),
                  "perf": C.PoolSpec(perf, 2, 4, linger_s=5.0)},
        C.ThresholdScheduler(cfg, eff, perf, t_in=32), engine=engine))
    return out


def sc_autoscalers(P, engine):
    cfg, eff, perf = _paper(P)
    C = P.core
    single = C.SingleSystemScheduler(cfg, perf)
    out = [C.simulate_fleet(cfg, _diurnal(P), {"perf": C.PoolSpec(perf, 4, 2)},
                            single, engine=engine),
           C.simulate_fleet(cfg, _diurnal(P), {"perf": C.PoolSpec(
               perf, 4, 2, linger_s=20.0)}, single,
               autoscaler=C.TargetUtilizationAutoscaler(
                   period_s=10.0, min_instances=1, target_util=0.6),
               engine=engine),
           C.simulate_fleet(cfg, _diurnal(P, 100, 9),
                            {"perf": C.PoolSpec(perf, 4, 2)}, single,
                            autoscaler=C.QueueDepthAutoscaler(
                                period_s=10.0, min_instances=1),
                            engine=engine),
           C.simulate_fleet(cfg, _diurnal(P, 60, 3),
                            {"perf": C.PoolSpec(perf, 3, 2)}, single,
                            autoscaler=C.TargetUtilizationAutoscaler(
                                period_s=10.0, min_instances=3,
                                target_util=0.6),
                            engine=engine),
           C.simulate_fleet(cfg, [C.Query(32, 32, 0.0),
                                  C.Query(32, 32, 5.0e4)],
                            {"perf": C.PoolSpec(perf, 2, 1, linger_s=10.0)},
                            single, autoscaler=C.QueueDepthAutoscaler(
                                period_s=10.0, min_instances=0),
                            engine=engine)]
    return out


def sc_accounting(P, engine):
    """Idle-inclusive J/token, an overprovisioned fleet, the flat summary
    and a workload shifted to a diurnal horizon."""
    cfg, eff, perf = _paper(P)
    C = P.core
    single = C.SingleSystemScheduler(cfg, perf)
    out = [C.simulate_fleet(cfg, C.sample_workload(
        40, seed=11, spec=_spec(P, rate_qps=2.0)),
        {"perf": C.PoolSpec(perf, 2, 2)}, single, engine=engine)]
    qs = C.sample_workload(30, seed=1, spec=_spec(P, rate_qps=0.5))
    out += [C.simulate_fleet(cfg, qs, {"perf": C.PoolSpec(perf, i, 2)},
                             single, engine=engine) for i in (2, 30)]
    out.append(C.simulate_fleet(
        cfg, C.sample_workload(20, seed=4, spec=_spec(P, rate_qps=2.0)),
        _pools2(P, eff, perf), C.ThresholdScheduler(cfg, eff, perf, t_in=32),
        engine=engine))
    base = C.sample_workload(60, seed=13, spec=_spec(P, rate_qps=2.0),
                             arrival_process="mmpp")
    for off in (0.0, 3.0e5):
        qs = [C.Query(q.m, q.n, q.arrival_s + off) for q in base]
        out.append(C.simulate_fleet(
            cfg, qs, {"eff": C.PoolSpec(eff, 2, 2),
                      "perf": C.PoolSpec(perf, 1, 4)},
            C.ThresholdScheduler(cfg, eff, perf, t_in=32), engine=engine))
    return out


def sc_carbon_fleet(P, engine):
    cfg, eff, perf = _paper(P)
    C = P.core
    qs = [C.Query(16, 16, float(i)) for i in range(5)] + \
        [C.Query(64, 512, float(i)) for i in range(5)]
    return C.simulate_fleet(cfg, qs, _pools2(P, eff, perf),
                            P.carbon.CarbonAwareScheduler(cfg, [eff, perf]),
                            engine=engine)


# tests/test_region.py: qwen2.5-3b over two regions of TPU profiles
def _regions(P):
    C = P.core
    eff = C.get_profile("tpu-v5lite-eff")
    perf = C.get_profile("tpu-v5e-perf")
    west = C.Region("us-west", {"eff": C.PoolSpec(eff, instances=2, slots=4)},
                    carbon=P.carbon.CarbonProfile(mean_g_per_kwh=300.0,
                                                  trough_hour=13.0))
    east = C.Region("eu-north",
                    {"perf": C.PoolSpec(perf, instances=2, slots=4)},
                    carbon=P.carbon.CarbonProfile(mean_g_per_kwh=120.0,
                                                  trough_hour=2.0))
    return P.configs.get_config("qwen2.5-3b"), west, east


def sc_regions(P, engine):
    cfg, west, east = _regions(P)
    C = P.core
    t0 = 18 * 3600.0
    qs = sorted([C.Query(256, 512, t0), C.Query(64, 16, t0 + 1.0),
                 C.Query(200, 400, t0 + 2.0)], key=lambda q: q.arrival_s)
    flat_perf = C.flatten_regions([west, east])["eu-north/perf"].system
    return [C.simulate_fleet(cfg, qs, regions=[west, east],
                             scheduler=C.GlobalDispatcher(cfg, [west, east]),
                             engine=engine),
            C.simulate_fleet(cfg, [C.Query(256, 512, t0)],
                             regions=[west, east],
                             scheduler=C.GlobalDispatcher(cfg, [west, east]),
                             engine=engine),
            C.simulate_fleet(cfg, C.sample_workload(
                20, seed=1, spec=_spec(P, rate_qps=2.0)),
                regions=[west, east],
                scheduler=C.SingleSystemScheduler(cfg, flat_perf),
                engine=engine)]


# tests/test_disagg.py's fleet half: qwen2.5-3b over the probe pair
def _disagg_systems(P, link=100.0):
    SP = P.core.SystemProfile
    eff = SP(name="eff", kind="eff", chips=1, peak_flops=90e12,
             hbm_bw=0.8e12, ici_bw=50e9, power_peak_w=220.0,
             power_idle_w=8.0, overhead_s=0.02, sat_ctx=2048.0,
             link_bw_gbps=link)
    perf = SP(name="perf", kind="perf", chips=2, peak_flops=200e12,
              hbm_bw=1.25e12, ici_bw=100e9, power_peak_w=350.0,
              power_idle_w=60.0, overhead_s=0.01, sat_ctx=None,
              link_bw_gbps=link)
    return P.configs.get_config("qwen2.5-3b"), eff, perf


def _disagg_pools(P, eff, perf):
    return {"eff": P.core.PoolSpec(eff, instances=4, slots=4, kv_blocks=4096),
            "perf": P.core.PoolSpec(perf, instances=4, slots=4,
                                    kv_blocks=4096)}


def sc_disagg_splits(P, engine):
    cfg, eff, perf = _disagg_systems(P)
    C = P.core
    spec = _spec(P, mu_in=5.5, sigma_in=0.7, mu_out=4.0, sigma_out=0.8,
                 rate_qps=20.0)
    out = []
    for seed, disc in ((0, "fifo"), (1, "sjf")):
        qs = C.sample_workload(160, seed=seed, spec=spec,
                               arrival_process="diurnal")
        out.append(C.simulate_fleet(
            cfg, qs, _disagg_pools(P, eff, perf),
            C.DisaggregatedScheduler(cfg, [eff, perf]),
            queue_discipline=disc, engine=engine))
    qs = C.sample_workload(80, seed=2, spec=_spec(P, mu_in=5.5, mu_out=4.0,
                                                  rate_qps=20.0))
    out.append(C.simulate_fleet(cfg, qs, _disagg_pools(P, eff, perf),
                                C.DisaggregatedScheduler(cfg, [eff, perf]),
                                engine=engine))
    return out


def sc_disagg_no_link(P, engine):
    cfg, eff, perf = _disagg_systems(P, link=0.0)
    C = P.core
    qs = C.sample_workload(60, seed=0, spec=_spec(P, mu_in=5.5, mu_out=4.0,
                                                  rate_qps=20.0))
    return C.simulate_fleet(cfg, qs, _disagg_pools(P, eff, perf),
                            C.DisaggregatedScheduler(cfg, [eff, perf]),
                            engine=engine)


def sc_disagg_zero_decode_pair(P, engine):
    """A legacy policy returning a raw (prefill, decode) profile tuple for
    queries with no output: single-pool prefill, no handoff."""
    cfg, eff, perf = _disagg_systems(P)
    C = P.core

    class AlwaysPair(C.Scheduler):
        def choose(self, q):
            return self.systems[0]

        def dispatch(self, q, fleet=None):
            return (self.systems[1], self.systems[0])

    qs = [C.Query(64, 0, 0.0), C.Query(32, 0, 0.1)]
    return C.simulate_fleet(cfg, qs, _disagg_pools(P, eff, perf),
                            AlwaysPair(cfg, [eff, perf]), engine=engine)


# tests/test_fleet_vec.py: qwen2.5-3b, the engines' equivalence grid
def sc_vec_grid(P, engine, seed, disc, autoscale, kv):
    C = P.core
    SP = C.SystemProfile
    cfg = P.configs.get_config("qwen2.5-3b")
    eff = SP(name="eff", kind="eff", chips=1, peak_flops=90e12,
             hbm_bw=0.8e12, ici_bw=50e9, power_peak_w=220.0,
             power_idle_w=60.0, overhead_s=0.02, sat_ctx=4096.0)
    perf = SP(name="perf", kind="perf", chips=2, peak_flops=200e12,
              hbm_bw=1.25e12, ici_bw=100e9, power_peak_w=350.0,
              power_idle_w=60.0, overhead_s=0.01, sat_ctx=None)
    qs = C.sample_workload(220, seed=seed, spec=_spec(P, rate_qps=6.0),
                           arrival_process="mmpp" if seed % 2 else "diurnal")
    pools = {
        "eff": C.PoolSpec(eff, instances=3, slots=4,
                          kv_blocks=512 if kv else 0, block_size=16,
                          linger_s=20.0 if autoscale else math.inf),
        "perf": C.PoolSpec(perf, instances=2, slots=4,
                           kv_blocks=512 if kv else 0, block_size=16)}
    autos = ({"eff": C.TargetUtilizationAutoscaler(period_s=15.0,
                                                   min_instances=1)}
             if autoscale else None)
    sched = (C.CapacityAwareScheduler(cfg, [eff, perf],
                                      {"eff": 3, "perf": 2})
             if seed % 2 else C.CostOptimalScheduler(cfg, [eff, perf]))
    return C.simulate_fleet(cfg, qs, pools, sched, queue_discipline=disc,
                            autoscaler=autos, engine=engine)


FLEET_SCENARIOS = (sc_zero_load, sc_mmpp_threshold, sc_cost_optimal_mmpp,
                   sc_single_pool_capacity, sc_every_policy, sc_burst,
                   sc_block_capacity, sc_power_states_armed,
                   sc_sleep_and_wake, sc_autoscalers, sc_accounting,
                   sc_carbon_fleet, sc_regions, sc_disagg_splits,
                   sc_disagg_no_link, sc_disagg_zero_decode_pair)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("scenario", FLEET_SCENARIOS,
                         ids=[f.__name__[3:] for f in FLEET_SCENARIOS])
def test_fleet_results_equal_jax(pkgs, scenario, engine):
    _same(scenario, pkgs, engine)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("autoscale,kv", [(False, False), (True, False),
                                          (False, True), (True, True)])
@pytest.mark.parametrize("disc", ["fifo", "sjf"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_engine_grid_equals_jax(pkgs, seed, disc, autoscale, kv, engine):
    _same(sc_vec_grid, pkgs, engine, seed, disc, autoscale, kv)


def test_disaggregated_fleet_still_splits(pkgs):
    """The probe pair keeps splitting in the port, so the disaggregated
    scenarios above compare handoffs and not only single-pool runs."""
    res = sc_disagg_splits(pkgs[1], "vectorized")
    assert all(any(r.pool_decode for r in x.records) for x in res)
    assert all(x.mig_bytes > 0 for x in res)


# ------------------------------------------------- static scenarios
def st_threshold_sweeps(P):
    cfg, eff, perf = _paper(P)
    C = P.core
    qs = C.alpaca_like(2000, seed=0)
    out = []
    for axis in ("in", "out"):
        sweep = C.threshold_sweep(cfg, qs, eff, perf, axis=axis)
        out += [sweep, C.optimal_threshold(sweep)]
    few = [C.Query(16, 700), C.Query(32, 40)]
    out += [C.threshold_sweep(cfg, few, eff, perf, axis=a)
            for a in ("in", "out")]
    return out


def st_simulate(P):
    cfg, eff, perf = _paper(P)
    C = P.core
    qs = C.alpaca_like(1000, seed=2)
    return [C.simulate(cfg, qs, s) for s in (
        C.ThresholdScheduler(cfg, eff, perf, t_in=32),
        C.CostOptimalScheduler(cfg, [eff, perf]),
        C.SingleSystemScheduler(cfg, eff),
        C.RoundRobinScheduler(cfg, [eff, perf]))]


def st_carbon(P):
    cfg, eff, perf = _paper(P)
    C, K = P.core, P.carbon
    cp = K.CarbonProfile()
    qs = [C.Query(64, 512, arrival_s=20 * 3600.0 + i) for i in range(20)]
    base = C.ThresholdScheduler(cfg, eff, perf, t_in=32).assign(qs)
    green = K.CarbonAwareScheduler(cfg, [eff, perf], cp,
                                   defer_out_threshold=256).assign(qs)
    sched = K.CarbonAwareScheduler(cfg, [eff, perf], cp,
                                   defer_out_threshold=256)
    peak = 1 * 3600.0
    shifted = K.CarbonProfile(trough_hour=2.0)
    adopt = K.CarbonAwareScheduler(cfg, [eff, perf],
                                   model=C.CostModel(cfg, carbon=shifted))
    return [[cp.intensity(h * 3600.0) for h in range(25)],
            base, green, K.total_grams(cfg, base, cp),
            K.total_grams(cfg, green, cp),
            K.CarbonAwareScheduler(cfg, [eff, perf]).assign(
                [C.Query(16, 16, arrival_s=20 * 3600.0)]),
            K.CarbonAwareScheduler(cfg, [eff, perf], max_defer_s=3600.0)
            .assign([C.Query(64, 512, arrival_s=20 * 3600.0)]),
            sched.dispatch(C.Query(64, 512, 0.0), C.FleetState(time_s=peak)),
            sched.dispatch(C.Query(16, 16, 0.0), C.FleetState(time_s=peak)),
            sched.dispatch(C.Query(16, 16, 0.0)),
            adopt._next_green_window(22 * 3600.0),
            K.next_green_window(cp, 20 * 3600.0)]


def st_region_dispatch(P):
    cfg, west, east = _regions(P)
    C = P.core
    t0 = 18 * 3600.0
    sched = C.GlobalDispatcher(cfg, [west, east])
    pricey = C.Region(west.name, west.pools, carbon=west.carbon,
                      price=C.PriceProfile(mean_usd_per_kwh=1e6))
    weighted = C.GlobalDispatcher(cfg, [pricey, east], price_weight=1.0)
    q = C.Query(64, 16, 2 * 3600.0)
    return [C.flatten_regions([west, east]),
            sched.dispatch(C.Query(64, 16, t0), None),
            sched.dispatch(C.Query(256, 512, t0), None),
            sched.dispatch(q, None), weighted.dispatch(q, None)]


def st_disagg_dispatch(P):
    cfg, eff, perf = _disagg_systems(P)
    C = P.core
    fleet = C.FleetState(pools={s.name: C.PoolSnapshot(system=s,
                                                       block_size=16)
                                for s in (eff, perf)})
    sched = C.DisaggregatedScheduler(cfg, [eff, perf])
    model = C.CostModel(cfg)
    qs = C.sample_workload(60, seed=3,
                           spec=_spec(P, mu_in=5.0, mu_out=3.5))
    return [sched.dispatch(C.Query(250, 50, 0.0), fleet),
            sched.dispatch(C.Query(250, 50, 0.0), None),
            sched.dispatch(C.Query(250, 0, 0.0), fleet),
            [sched.dispatch(q, fleet) for q in qs],
            model.migration_terms(250, perf, eff, block_size=16),
            model.migration_terms(250, perf, eff, block_size=0)]


def st_fleet_snapshots(P):
    """The simulators' observable state: block occupancy per instance and
    the awake/asleep view with a wake pending."""
    cfg, eff, perf = _paper(P)
    C, F = P.core, P.fleet
    sim = C.FleetSimulator(cfg, {"perf": C.PoolSpec(perf, 2, 2, kv_blocks=64,
                                                    block_size=16)},
                           C.SingleSystemScheduler(cfg, perf))
    out = [sim._fleet_state(0.0)]
    sim = C.FleetSimulator(cfg, {"perf": C.PoolSpec(perf, 2, 1,
                                                    linger_s=5.0)},
                           C.SingleSystemScheduler(cfg, perf))
    pool = sim.pools["perf"]
    out.append(pool.snapshot(sim.model, 0.0))
    pool.instances[0].go_sleep(0.0, F.SLEEP)
    out.append(pool.snapshot(sim.model, 0.0))
    pool.instances[1].go_sleep(0.0, F.SLEEP)
    out.append(pool.snapshot(sim.model, 0.0))
    pool.instances[0].begin_wake(0.0)
    out.append(pool.snapshot(sim.model, 2.0))
    return out


STATIC_SCENARIOS = (st_threshold_sweeps, st_simulate, st_carbon,
                    st_region_dispatch, st_disagg_dispatch,
                    st_fleet_snapshots)


@pytest.mark.parametrize("scenario", STATIC_SCENARIOS,
                         ids=[f.__name__[3:] for f in STATIC_SCENARIOS])
def test_static_results_equal_jax(pkgs, scenario):
    _same(scenario, pkgs)


@pytest.mark.parametrize("fleet", ["paper", "tpu"])
@pytest.mark.parametrize("axis,faithful", [("in", True), ("out", True),
                                           ("both", False)])
def test_headline_equals_jax(pkgs, fleet, axis, faithful):
    """The paper's headline figure, hybrid threshold policy against the
    workload-unaware baselines, exactly as the JAX package computes it."""
    def run(P):
        cfg = P.configs.get_config("deepseek-7b")
        eff, perf = getattr(P.core, f"{fleet}_fleet")()
        return P.core.headline(cfg, P.core.alpaca_like(2000, seed=1), eff,
                               perf, t_in=32, axis=axis,
                               paper_faithful=faithful)
    _same(run, pkgs)
    got = run(pkgs[1])
    assert got.savings_vs_all_perf == run(pkgs[0]).savings_vs_all_perf

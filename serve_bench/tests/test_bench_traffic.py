"""The frozen traffic generators: seeded requests reproduce, every seed
offers the same sizes and gaps in another order, the mean rates match,
and the copies equal the served package's originals."""
import numpy as np
import pytest

import _tiny  # noqa: F401  (puts src/ and the repo on sys.path)
from serve_bench import traffic as T
from serve_bench import workload_copy as W

CHAT = {"lengths": {"mu_in": 3.2, "sigma_in": 0.95, "max_in": 2048,
                    "mu_out": 4.1, "sigma_out": 0.85, "max_out": 4096},
        "arrivals": {"process": "poisson", "rate_qps": 8.0},
        "pool": 4000, "pool_seed": 0, "shuffle": 16, "ramp_s": 5,
        "trace_slice_s": 3}
BURST = dict(CHAT, arrivals={"process": "onoff", "rate_qps": 12.0,
                             "calm_s": 5.4, "burst_s": 0.6,
                             "burst_factor": 8})


def _key(reqs):
    return [(r.due, r.m, r.n, r.prompt.tobytes()) for r in reqs]


@pytest.mark.parametrize("mix", [CHAT, BURST], ids=["poisson", "onoff"])
def test_seed_reproduces(mix):
    a = T.make_requests(mix, 2 ** 31 + 5, 32000, 40.0)
    b = T.make_requests(mix, 2 ** 31 + 5, 32000, 40.0)
    c = T.make_requests(mix, 2 ** 31 + 6, 32000, 40.0)
    assert _key(a) == _key(b)
    assert _key(a) != _key(c)
    assert all(len(r.prompt) == r.m and r.prompt.max() < 32000 for r in a)


@pytest.mark.parametrize("mix", [CHAT, BURST], ids=["poisson", "onoff"])
def test_same_work_every_seed(mix):
    """The same arrivals for every seed, and in the ramp and the window
    the same sizes, in another order."""
    runs = [T.make_requests(mix, seed, 100, 35.0) for seed in (1, 2, 2 ** 33)]
    assert [r.due for r in runs[0]] == [r.due for r in runs[1]] \
        == [r.due for r in runs[2]]
    for lo, hi in ((0.0, 5.0), (5.0, 35.0)):
        sizes = [sorted((r.m, r.n) for r in rs if lo <= r.due < hi)
                 for rs in runs]
        assert sizes[0] == sizes[1] == sizes[2]
    assert [r.m for r in runs[0]] != [r.m for r in runs[1]]
    # the shuffle is local: a size moves within its block of 16
    a, b = T.schedule(mix, 7)[1], T.schedule(mix, 8)[1]
    for s in range(0, len(a), 16):
        assert sorted(a[s:s + 16]) == sorted(b[s:s + 16])


@pytest.mark.parametrize("mix,rate", [(CHAT, 8.0), (BURST, 12.0)],
                         ids=["poisson", "onoff"])
def test_mean_rate(mix, rate):
    reqs = T.make_requests(mix, 9, 100, 300.0)
    assert len(reqs) / 300.0 == pytest.approx(rate, rel=0.06)


def test_onoff_phases():
    """A tenth of the time at 8x the calm rate: 8 / 13.4 of the arrivals
    land in the bursts, all of them in [5.4, 6.0) of a 6 s period."""
    reqs = T.make_requests(BURST, 4, 100, 300.0)
    phase = np.array([r.due % 6.0 for r in reqs])
    share = np.mean(phase >= 5.4)
    assert share == pytest.approx(0.6 * 8 / (5.4 + 0.6 * 8), abs=0.03)


def test_onoff_time_inverts_intensity():
    u = np.linspace(0.0, 500.0, 2001)
    t = W.onoff_time(u, 10.0, 5.4, 0.6, 8.0)
    calm = 10.0 * 6.0 / (5.4 + 8 * 0.6)
    tau = t % 6.0
    k = np.floor(t / 6.0)
    lam = np.where(tau <= 5.4, calm * tau, calm * 5.4 + 8 * calm * (tau - 5.4))
    assert np.allclose(k * 60.0 + lam, u)


def test_copies_equal_the_originals():
    from repro_torch.core import workload as P
    spec = P.WorkloadSpec()
    got = W.sample_lengths(500, 3, W.WorkloadSpec())
    ref = P.sample_workload(500, seed=3, spec=spec)
    assert got[0].tolist() == [q.m for q in ref]
    assert got[1].tolist() == [q.n for q in ref]
    assert np.array_equal(W.poisson_arrivals(100, 2.5, 4),
                          P.poisson_arrivals(100, 2.5, 4))


def test_refuses_a_short_pool():
    with pytest.raises(ValueError, match="before the horizon"):
        T.make_requests(dict(CHAT, pool=10), 1, 100, 60.0)


def test_each_phase_keeps_its_sizes():
    """Every calm spell and every burst offers the same sizes for every
    seed, so no seed loads a burst more than another."""
    runs = [T.make_requests(BURST, seed, 100, 57.0)
            for seed in (3, 4, 2 ** 33 + 1)]
    edges = [0.0, *T.phase_edges(BURST["arrivals"], 57.0), 57.0]
    assert edges[1:5] == [5.4, 6.0, 11.4, 12.0]
    for lo, hi in zip(edges, edges[1:]):
        sizes = [sorted((r.m, r.n) for r in rs if lo <= r.due < hi)
                 for rs in runs]
        assert sizes[0] == sizes[1] == sizes[2]
    assert [r.m for r in runs[0]] != [r.m for r in runs[1]]
    assert T.phase_edges(CHAT["arrivals"], 57.0) == []

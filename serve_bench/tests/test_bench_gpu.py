"""On the card only (marked ``gpu``; skipped without one): the energy
meter reads the card's counter, and a short run of each cell is
correct."""
import json

import pytest
import torch

import _tiny


@pytest.mark.gpu
def test_energy_meter_reads_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    import time
    from serve_bench.energy import EnergyMeter
    uuid = str(torch.cuda.get_device_properties(0).uuid)
    m = EnergyMeter(uuid)
    m.start()
    x = torch.randn(4096, 4096, device="cuda")
    t = time.time()
    while time.time() - t < 1.0:
        x = x @ x
        x = x / x.norm()
    torch.cuda.synchronize()
    assert m.stop() > 50.0          # over 50 W for a second of matmuls


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["mistral7b.chat", "zamba2.burst"])
def test_short_run_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    from serve_bench import run as R
    from serve_bench.bench import find_cell
    from serve_bench.harness import clock
    bench = json.loads((_tiny.REPO / "BENCHMARK.json").read_text())
    res = R.run(find_cell(bench, cell, _tiny.REPO), seed=5, seconds=8,
                trace=False, device=torch.device("cuda", 0),
                t_start=clock())
    assert res["correct"], res["checks"]

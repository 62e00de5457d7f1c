"""On the card only (marked ``gpu``; skipped without one): the
nemotron3nano.chat cell at full size, run by the harness for a short
window on one seed, with its sigmoid-routed experts broken underneath
(``moe_faults``): ``correct`` comes out false for each fault, and true
with nothing broken. Each run prints its checks (``-s``)."""
import gc
import json

import pytest
import torch

import _tiny
from moe_faults import MOE_FAULTS

CELL = "nemotron3nano.chat"
SEED = 2147483647


@pytest.mark.gpu
@pytest.mark.parametrize("fault", [None, *MOE_FAULTS.values()],
                         ids=["sound", *MOE_FAULTS])
def test_moe_fault_fails_correct_at_full_size(fault, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    from serve_bench import run as R
    from serve_bench.bench import find_cell
    from serve_bench.harness import clock
    gc.collect()
    torch.cuda.empty_cache()
    bench = json.loads((_tiny.REPO / "BENCHMARK.json").read_text())
    hook = None if fault is None else (lambda prog: fault(prog, monkeypatch))
    res = R.run(find_cell(bench, CELL, _tiny.REPO), seed=SEED, seconds=10,
                trace=False, device=torch.device("cuda", 0),
                t_start=clock(), hook=hook)
    assert res["attempted"] > 0
    assert res["correct"] is (fault is None), res["checks"]

"""The correctness control: the reference in int8 put in the program's
place (at each position of the served prompts and tokens, the gap of the
token that int8 puts first) has to read as not correct.

On the CPU at a tiny size, where bfloat16 and int8 lie closer than at
the cells' widths: over five seeds the control's widest gaps add up to
well above the sound program's on the same samples. On the card (marked
``gpu``), at each cell's own size: the control fails the cell's limit,
so the harness's own verdict on it is not correct, and the program passes
it, on three seeds."""
import json

import pytest
import torch

import _tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("cell", ["tiny.dense", "tiny.hybrid"])
def test_control_reads_above_the_program(root, cell):
    sound = control = 0.0
    for seed in (3, 4, 2 ** 31 + 11, 5, 6):
        res = _tiny.run(root, cell, seed=seed, seconds=3.0, control=True)
        c = res["checks"]
        assert res["correct"], c
        within = c["control_gap"]["value"] <= c["logit_gap"]["limit"]
        if cell == "tiny.dense":        # also held by its mean gap
            assert c["mean_logit_gap"]["value"] <= c["logit_gap"]["value"]
            within = within and (c["control_mean_gap"]["value"]
                                 <= c["mean_logit_gap"]["limit"])
        assert res["control_correct"] == within
        sound += c["logit_gap"]["value"]
        control += c["control_gap"]["value"]
    assert control > 2 * sound, (control, sound)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["mistral7b.chat", "zamba2.burst"])
def test_control_fails_the_cell_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's size")
    from serve_bench import run as R
    from serve_bench.bench import find_cell
    from serve_bench.harness import clock
    bench = json.loads((_tiny.REPO / "BENCHMARK.json").read_text())
    c = find_cell(bench, cell, _tiny.REPO)
    for seed in (1001, 1002, 1003):
        res = R.run(c, seed=seed, seconds=15, trace=False,
                    device=torch.device("cuda", 0), t_start=clock(),
                    control=True)
        chk = res["checks"]
        assert chk["logit_gap"]["value"] <= chk["logit_gap"]["limit"]
        assert chk["control_gap"]["value"] > chk["logit_gap"]["limit"], chk
        assert res["correct"] and res["control_correct"] is False, chk

"""The nemotron-3-nano-30b-a3b cell at a tiny size on the CPU, run by the
harness as the benchmark runs it, with the timed path broken underneath:
``correct`` has to come out false for each fault, and true with nothing
broken. The cell's layout (block pattern, grouped Mamba2, sigmoid-routed
experts and a shared one, dense pools) at widths a CPU run holds."""
import json
import shutil

import pytest

import _tiny
from test_bench_faults import half_batch, state_unchanged, token_altered
from moe_faults import MOE_FAULTS

CELL = "nemotron3nano.chat"
NANO = {"family": "hybrid", "num_layers": 6, "d_model": 64, "num_heads": 4,
        "num_kv_heads": 2, "head_dim": 16, "d_ff": 64, "vocab_size": 256,
        "pos_emb": "none", "activation": "relu2", "norm": "rmsnorm",
        "tie_embeddings": False, "block_pattern": "MEM*EM",
        "ssm": {"state_dim": 16, "head_dim": 16, "expand": 2,
                "chunk_size": 32, "conv_width": 4, "n_groups": 2,
                "num_heads": 4},
        "moe": {"num_experts": 8, "num_experts_per_tok": 3,
                "router": "sigmoid", "score_bias": True,
                "norm_topk_prob": True, "routed_scale": 2.5,
                "shared_expert_dim": 64}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The benchmark's files with the cell's configuration cut to NANO,
    its mix to _tiny's, and BENCHMARK.json holding that cell alone."""
    root = tmp_path_factory.mktemp("nano") / "bench"
    shutil.copytree(_tiny.HERE, root / "serve_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((_tiny.REPO / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    path = root / entry["file"]
    cfg = json.loads(path.read_text())
    cfg["model"] = NANO
    cfg["serving"].update(slots=2, max_len=128)
    cfg["correct"] = {"max_logit_gap": _tiny.LIMIT,
                      "max_mean_gap": _tiny.MEAN_LIMIT, "sample_requests": 8}
    path.write_text(json.dumps(cfg))
    (root / "serve_bench" / "traffic" / f"{cell['traffic']}.json") \
        .write_text(json.dumps(_tiny.MIX))
    bench["workloads"] = [cell]
    for group in ("end_to_end", "per_layer"):
        bench[group] = [m for m in bench[group]
                        if CELL in m.get("workloads", [CELL])]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("fault", [None, state_unchanged, half_batch,
                                   token_altered],
                         ids=["sound", "state_unchanged", "half_batch",
                              "token_altered"])
def test_fault_fails_correct(root, fault):
    res = _tiny.run(root, CELL, seconds=3.0, hook=fault)
    assert res["attempted"] > 0
    assert res["correct"] is (fault is None), res["checks"]


@pytest.mark.parametrize("fault", list(MOE_FAULTS.values()),
                         ids=list(MOE_FAULTS))
def test_moe_fault_fails_correct(root, fault, monkeypatch):
    """The sigmoid-routed experts broken underneath (``moe_faults``): the
    live mask cleared or inverted, the sixth choice's slot dropped, the
    gate left unnormalised; ``correct`` comes out false for each."""
    res = _tiny.run(root, CELL, seconds=3.0,
                    hook=lambda prog: fault(prog, monkeypatch))
    assert res["attempted"] > 0
    assert res["correct"] is False, res["checks"]


def test_a_traced_tiny_run_reads_the_moe_counts(root):
    """The tick log's routed rows and experts touched reach the reader."""
    res = _tiny.run(root, CELL, seconds=3.0, trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["experts_touched"]["value"] > 0

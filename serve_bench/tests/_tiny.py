"""A benchmark at a size a CPU test run holds: a copy of the harness's
folder with two tiny configurations (dense and hybrid, the cells'
layouts), a slow mix, and a BENCHMARK.json naming them."""
from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

DENSE = {"family": "dense", "num_layers": 2, "d_model": 64, "num_heads": 4,
         "num_kv_heads": 2, "d_ff": 128, "vocab_size": 256, "pos_emb": "rope",
         "rope_theta": 10000.0, "activation": "swiglu", "norm": "rmsnorm",
         "sliding_window": 48, "tie_embeddings": False, "qkv_bias": False}
HYBRID = {"family": "hybrid", "num_layers": 3, "d_model": 64,
          "num_heads": 4, "num_kv_heads": 4, "d_ff": 128, "vocab_size": 256,
          "pos_emb": "rope", "rope_theta": 10000.0, "activation": "gelu",
          "norm": "rmsnorm", "sliding_window": 96, "tie_embeddings": False,
          "qkv_bias": False, "hybrid_attn_every": 2,
          "ssm": {"state_dim": 16, "head_dim": 16, "expand": 2,
                  "chunk_size": 32, "conv_width": 4}}
ROUTER = {"fleet": "paper_fleet", "policy": "threshold", "t_in": 32,
          "axis": "in"}
MIX = {"lengths": {"mu_in": 3.2, "sigma_in": 0.95, "max_in": 80,
                   "mu_out": 2.5, "sigma_out": 0.5, "max_out": 32},
       "arrivals": {"process": "poisson", "rate_qps": 12.0},
       "pool": 400, "pool_seed": 0, "shuffle": 16, "ramp_s": 0.5,
       "trace_slice_s": 1.0}
# bf16 against the float32 reference at this size reads well under 0.2
LIMIT = 0.2
# ... and a mean gap under 0.0004 (the paged cell is held by it too, as
# mistral-7b is)
MEAN_LIMIT = 0.01


def config(name, model, ref, batcher):
    serving = {"router": ROUTER, "batcher": batcher, "slots": 2,
               "max_len": 128}
    correct = {"max_logit_gap": LIMIT, "sample_requests": 8}
    if batcher == "paged":
        serving.update(block_size=16, chunk=32, num_blocks=64)
        correct["max_mean_gap"] = MEAN_LIMIT
    return {"name": name, "source": "test", "reduced": [],
            "reference": ref, "dtype": "bfloat16", "model": model,
            "serving": serving, "correct": correct}


def make_root(tmp: Path) -> Path:
    """tmp/BENCHMARK.json and tmp/serve_bench (a copy) with cells
    ``tiny.dense`` and ``tiny.hybrid`` in the real cells' metrics."""
    root = tmp / "bench"
    shutil.copytree(HERE, root / "serve_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    sb = root / "serve_bench"
    (sb / "configs" / "tiny-dense.json").write_text(json.dumps(
        config("tiny-dense", DENSE, "reference/dense.py", "paged")))
    (sb / "configs" / "tiny-hybrid.json").write_text(json.dumps(
        config("tiny-hybrid", HYBRID, "reference/hybrid.py", "dense")))
    (sb / "traffic" / "tiny.json").write_text(json.dumps(MIX))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(bench)
    bench["configs"] = [
        {"name": "tiny-dense", "source": "test",
         "file": "serve_bench/configs/tiny-dense.json", "reduced": [],
         "why": "test"},
        {"name": "tiny-hybrid", "source": "test",
         "file": "serve_bench/configs/tiny-hybrid.json", "reduced": [],
         "why": "test"}]
    bench["workloads"] = [
        {"name": "tiny.dense", "config": "tiny-dense", "traffic": "tiny",
         "chips": 1, "why": "test"},
        {"name": "tiny.hybrid", "config": "tiny-hybrid", "traffic": "tiny",
         "chips": 1, "why": "test"}]
    cells = {"mistral7b.chat": "tiny.dense", "zamba2.burst": "tiny.hybrid"}
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = [cells[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def cell(root: Path, name: str):
    from serve_bench.bench import find_cell
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return find_cell(bench, name, root)


def run(root: Path, name: str, *, seed=7, seconds=2.0, trace=False,
        hook=None, control=False):
    import torch
    from serve_bench import run as R
    from serve_bench.harness import clock
    return R.run(cell(root, name), seed=seed, seconds=seconds, trace=trace,
                 device=torch.device("cpu"), t_start=clock(), hook=hook,
                 control=control)

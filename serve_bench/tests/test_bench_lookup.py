"""The harness finds a cell from its files alone: in a copy, a new
configuration, mix and metric are added as files and entries, editing no
file that is there, and the lookup and validation take them."""
import hashlib
import json

import pytest

import _tiny
from serve_bench.bench import find_cell, validate


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_the_repository_benchmark_validates():
    bench = json.loads((_tiny.REPO / "BENCHMARK.json").read_text())
    assert validate(bench, _tiny.REPO) == ["mistral7b.chat", "zamba2.burst"]


def test_add_a_cell_by_files(tmp_path):
    root = _tiny.make_root(tmp_path)
    bench_path = root / "BENCHMARK.json"
    before = {p: d for p, d in _digests(root).items() if p != bench_path}
    sb = root / "serve_bench"
    cfg = _tiny.config("new-model", dict(_tiny.DENSE, num_layers=3),
                       "reference/dense.py", "paged")
    (sb / "configs" / "new-model.json").write_text(json.dumps(cfg))
    (sb / "traffic" / "steady.json").write_text(json.dumps(
        dict(_tiny.MIX, arrivals={"process": "poisson", "rate_qps": 2.0})))
    (sb / "metrics" / "lanes_live.py").write_text(
        "def read(t):\n    return 1.0\n")
    bench = json.loads(bench_path.read_text())
    bench["configs"].append({"name": "new-model", "source": "test",
                             "file": "serve_bench/configs/new-model.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "new.steady", "config": "new-model",
                               "traffic": "steady", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "itl_p95_ms":
            m["workloads"].append("new.steady")
    bench["per_layer"].append({"name": "lanes_live", "unit": "lanes",
                               "better": "higher", "source": "program_span",
                               "layer": "batching", "moves": "itl_p95_ms",
                               "workloads": ["new.steady"]})
    # a quantity split by the metric it moves is read by the quantity's file
    bench["per_layer"].append({"name": "tick_ms.steady", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "batching", "moves": "itl_p95_ms",
                               "workloads": ["new.steady"]})
    bench_path.write_text(json.dumps(bench))
    assert validate(bench, root) == ["tiny.dense", "tiny.hybrid",
                                     "new.steady"]
    cell = find_cell(bench, "new.steady", root)
    assert cell.config["model"]["num_layers"] == 3
    assert cell.traffic["arrivals"]["rate_qps"] == 2.0
    assert "lanes_live" in cell.readers
    assert cell.readers["tick_ms.steady"].__module__ == \
        "serve_bench_metric_tick_ms_steady"
    assert cell.readers["tick_ms.steady"].__code__.co_filename == \
        str(sb / "metrics" / "tick_ms.py")
    assert "lanes_live" not in find_cell(bench, "tiny.dense", root).readers
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())


def test_unknown_cell_and_missing_reader(tmp_path):
    root = _tiny.make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    with pytest.raises(KeyError):
        find_cell(bench, "nope", root)
    bench["per_layer"].append({"name": "absent_metric", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "batching", "moves": "itl_p95_ms"})
    with pytest.raises(FileNotFoundError):
        find_cell(bench, "tiny.dense", root)
    (root / "serve_bench" / "metrics" / "absent_metric.py").write_text(
        "def read(t):\n    return 1.0\n")
    with pytest.raises(ValueError, match="which it moves"):
        validate(bench, root)           # tiny.hybrid reports no itl_p95_ms

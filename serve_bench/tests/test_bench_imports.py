"""Nothing the benchmark runs imports JAX or the JAX package: a whole run
(at a tiny size, on the CPU) in a fresh process, then the top-level name
of every module it loaded, compared whole (``repro_torch`` is the port;
``repro`` is the JAX package)."""
import ast
import json
import subprocess
import sys

import _tiny

BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_a_run_loads_no_banned_module(tmp_path):
    root = _tiny.make_root(tmp_path)
    code = f"""
import sys, json
sys.path[:0] = [{str(_tiny.HERE / 'tests')!r}]
import _tiny
from pathlib import Path
res = _tiny.run(Path({str(root)!r}), "tiny.dense", seconds=3.0, trace=True)
tops = sorted({{k.split('.')[0] for k in sys.modules}})
print(json.dumps({{"correct": res is not None and res["correct"],
                   "tops": tops}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "repro_torch" in got["tops"]
    assert not BANNED & set(got["tops"]), sorted(BANNED & set(got["tops"]))


def test_no_source_names_a_banned_module():
    """The harness's own files import none of them either (the run above
    covers only the paths a tiny run takes)."""
    for path in _tiny.HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in BANNED, (path, n)


def test_refuses_a_banned_module_loaded(tmp_path, monkeypatch):
    """A run that finds one loaded prints no result."""
    import types
    root = _tiny.make_root(tmp_path)
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    assert _tiny.run(root, "tiny.dense", seconds=0.5) is None

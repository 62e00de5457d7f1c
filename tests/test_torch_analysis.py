"""The port's static checker, ``repro_torch.analysis``, against the JAX
package's ``repro.analysis``.

* ``findings``, ``framework``, ``baseline``, ``cli``, ``units`` and
  ``purity`` are copies: each syntax tree equals its original's once
  ``repro.`` module names read ``repro_torch.``, except
  ``framework.default_checkers``, which lists ``TorchHotPathChecker`` in
  the place of ``JaxHotPathChecker``;
* ``torch_hotpath`` flags ``torch-host-sync`` and ``torch-traced-branch``
  on a corpus of true and false positives, in the manner of
  tests/test_analysis.py;
* the units and purity copies find what the originals find on seeded
  sources;
* ``python -m repro_torch.analysis --fail-on warning src/repro_torch``
  exits 0, and each of the port's marked syncs is a finding without its
  mark.
"""
import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import analyze_source as jax_analyze_source
from repro.analysis.purity import SchedulerPurityChecker as JaxPurity
from repro.analysis.units import UnitsChecker as JaxUnits
from repro_torch.analysis import analyze_paths, analyze_source
from repro_torch.analysis.framework import all_rules, default_checkers
from repro_torch.analysis.purity import SchedulerPurityChecker
from repro_torch.analysis.torch_hotpath import TorchHotPathChecker
from repro_torch.analysis.units import UnitsChecker

ROOT = Path(__file__).resolve().parents[1]
COPIES = ("findings", "framework", "baseline", "cli", "units", "purity")
MARK = "# repro-lint: allow[torch-host-sync]"


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


class _DropDefaultCheckers(ast.NodeTransformer):
    def visit_FunctionDef(self, node):
        return None if node.name == "default_checkers" else node


def lint(snippet):
    return analyze_source(textwrap.dedent(snippet), path="snippet.py")


def rules_of(findings):
    return {f.rule for f in findings}


# ------------------------------------------------------------ the copies
@pytest.mark.parametrize("module", COPIES)
def test_copy_is_the_original_with_imports_renamed(module):
    orig = ast.parse((ROOT / "src/repro/analysis" / f"{module}.py")
                     .read_text())
    copy = ast.parse((ROOT / "src/repro_torch/analysis" / f"{module}.py")
                     .read_text())
    orig = _Rename().visit(orig)
    if module == "framework":           # the stated exception
        orig = _DropDefaultCheckers().visit(orig)
        copy = _DropDefaultCheckers().visit(copy)
    assert ast.dump(orig) == ast.dump(copy)


def test_default_checkers_swap_the_hot_path_checker_only():
    assert [type(c) for c in default_checkers()] == \
        [UnitsChecker, TorchHotPathChecker, SchedulerPurityChecker]
    rules = all_rules()
    assert {"torch-host-sync", "torch-traced-branch"} <= set(rules)
    assert not any(r.startswith("jax-") for r in rules)
    assert json.loads((ROOT / "src/repro_torch/analysis/baseline.json")
                      .read_text()) == {"findings": [], "version": 1}


# ------------------------------------------------- torch-hot-path: positives
FLAGGED = {
    # sync methods on a torch value in a Batcher method
    "item-in-batcher": ("""
     class MicroBatcher:
         def step(self):
             y = torch.argmax(self.logits, dim=-1)
             return y.item()
     """, "torch-host-sync"),
    "tolist-in-batcher": ("""
     class MicroBatcher:
         def step(self, logits):
             return torch.argmax(logits, dim=-1).tolist()
     """, "torch-host-sync"),
    # float() on a torch value in a loop
    "float-in-loop": ("""
     def drain(xs):
         out = []
         for x in xs:
             y = torch.sum(x)
             out.append(float(y))
         return out
     """, "torch-host-sync"),
    # .cpu() and .numpy() per iteration
    "cpu-in-loop": ("""
     def per_lane(t, lanes):
         for i in lanes:
             row = torch.index_select(t, 0, torch.tensor([i])).cpu()
     """, "torch-host-sync"),
    "numpy-in-loop": ("""
     def per_lane(lanes):
         for i in lanes:
             v = torch.zeros(3).numpy()
     """, "torch-host-sync"),
    # np.asarray / np.array on a torch value in a loop
    "np-asarray-in-loop": ("""
     import numpy as np
     def per_step(steps):
         for s in steps:
             t = torch.ones(4) * s
             a = np.asarray(t)
     """, "torch-host-sync"),
    "np-array-in-batcher": ("""
     import numpy as np
     class MicroBatcher:
         def step(self):
             return np.array(F.softmax(self.logits, dim=-1))
     """, "torch-host-sync"),
    # an attribute assigned a torch value anywhere in the class
    "class-attribute": ("""
     class MicroBatcher:
         def __init__(self):
             self.pos = torch.zeros(8, dtype=torch.int32)

         def step(self):
             return int(self.pos[0])
     """, "torch-host-sync"),
    # an engine step method's result
    "engine-step-result": ("""
     class MicroBatcher:
         def step(self):
             logits, self.cache = self.engine.decode(self.last, self.cache)
             return bool(logits.isnan().any())
     """, "torch-host-sync"),
    # control flow on a torch value
    "if-in-loop": ("""
     def stop_early(steps, tok):
         for _ in steps:
             done = torch.all(tok == 2)
             if done:
                 break
     """, "torch-traced-branch"),
    "if-any-in-loop": ("""
     def loop(steps, mask):
         for _ in steps:
             m = torch.ones(2) > mask
             if m.any():
                 break
     """, "torch-traced-branch"),
    "while-anywhere": ("""
     def settle(x):
         r = torch.abs(x)
         while r.max() > 1e-3:
             r = r / 2
     """, "torch-traced-branch"),
    "ternary-in-batcher": ("""
     class MicroBatcher:
         def step(self, a):
             t = torch.sum(a)
             return 1 if t > 0 else 0
     """, "torch-traced-branch"),
    "assert-in-loop": ("""
     def check(xs):
         for x in xs:
             t = torch.isfinite(x)
             assert t.all()
     """, "torch-traced-branch"),
}


@pytest.mark.parametrize("case", FLAGGED)
def test_torch_hotpath_flags(case):
    body, rule = FLAGGED[case]
    assert rule in rules_of(lint("import torch\n" + textwrap.dedent(body)))


# ------------------------------------------------- torch-hot-path: negatives
CLEAN = {
    # one sync outside any hot scope
    "outside-hot-scope": """
    def finish(out):
        toks = torch.stack(out, dim=1)
        return toks.cpu().numpy(), toks[0, 0].item()
    """,
    # a host value after .cpu().numpy() (the transfer itself marked)
    "host-after-cpu-numpy": """
    class MicroBatcher:
        def _emit(self, logits, live):
            tok_dev = torch.argmax(logits, dim=-1)
            # repro-lint: allow[torch-host-sync]
            toks = tok_dev.cpu().numpy()
            for i in live:
                self.out[i].append(int(toks[i]))
                if toks[i] == self.eos:
                    self.done.add(i)
    """,
    # metadata is host-side; identity tests read no data
    "metadata-and-identity": """
    def shapes(ts):
        for t in ts:
            x = torch.zeros_like(t)
            n = int(x.shape[0]) + x.size(1) + x.numel() + x.dim()
            if x is None or x.dtype == torch.float32 or x.is_cuda:
                continue
            assert x.device.type == "cpu"
    """,
    # host calls in torch's namespaces
    "torch-host-namespaces": """
    def sample(steps):
        for _ in steps:
            used = float(torch.cuda.memory_allocated())
            dev = torch.device("cpu")
            if torch.is_tensor(dev) or torch.cuda.is_available():
                pass
    """,
    # iterating a tensor makes views without a sync
    "iterating-views": """
    class MicroBatcher:
        def step(self, t):
            rows = torch.split(t, 1)
            for row in rows:
                self.keep.append(row)
    """,
    # the device-resident tick: values stay on the device
    "device-resident-tick": """
    class MicroBatcher:
        def step(self):
            logits, self.cache = self.engine.decode(self.last, self.cache)
            self.last = torch.argmax(logits, dim=-1)
    """,
    # numpy on host values, in a loop
    "numpy-on-host": """
    import numpy as np
    def host(tokens):
        for t in tokens:
            buf = np.asarray(t)
            n = int(buf[0])
    """,
}


@pytest.mark.parametrize("case", CLEAN)
def test_torch_hotpath_accepts(case):
    assert lint("import torch\n" + textwrap.dedent(CLEAN[case])) == []


def test_torch_hotpath_marks_are_rule_specific():
    src = """
        import torch
        class MicroBatcher:
            def step(self, logits):
                t = torch.argmax(logits)
                return t.item()  # repro-lint: allow[unit-add]
    """
    assert rules_of(lint(src)) == {"torch-host-sync"}
    assert lint(src.replace("unit-add", "torch-host-sync")) == []


# ------------------------------------------------ units and purity copies
SEEDED = [
    "def total(e_j, p_w):\n    return e_j + p_w\n",
    "def draw(p_w, dt_s):\n    total_w = p_w * dt_s\n    return total_w\n",
    "def overhead_j(t_s, p_w):\n    return t_s\n",
    "def report(e_j, tokens):\n    jpt = e_j / tokens\n    return jpt\n",
    "from dataclasses import dataclass\n\n@dataclass\nclass Result:\n"
    "    energy: float\n    runtime: float\n    savings_frac: float\n",
    "def cost(e_j, r_s, e_norm, r_norm, lam):\n"
    "    return lam * e_j / e_norm + (1.0 - lam) * r_s / r_norm\n",
    "class GreedyScheduler:\n    def choose(self, q):\n"
    "        self.count += 1\n        return 'eff'\n",
    "class SneakyScheduler:\n    def choose(self, q):\n"
    "        return self._pick(q)\n\n    def _pick(self, q):\n"
    "        self.memo[q.m] = 'eff'\n        heapq.heappush(self.h, 1)\n"
    "        return self.memo[q.m]\n",
    "class FairScheduler:\n    def choose(self, q):\n        return 'eff'\n\n"
    "    def observe(self, q, name):\n        self.history.append(q)\n",
]


def _as_tuples(findings):
    return [(f.line, f.col, f.rule, f.severity, f.message) for f in findings]


@pytest.mark.parametrize("source", SEEDED, ids=range(len(SEEDED)))
def test_units_and_purity_copies_find_what_the_originals_find(source):
    ours = analyze_source(source, "seeded.py",
                          [UnitsChecker(), SchedulerPurityChecker()])
    theirs = jax_analyze_source(source, "seeded.py",
                                [JaxUnits(), JaxPurity()])
    assert _as_tuples(ours) == _as_tuples(theirs)


def test_units_and_purity_copies_agree_over_the_fleet_layer():
    for path in sorted((ROOT / "src/repro/core").glob("*.py")):
        src = path.read_text() + SEEDED[0] + SEEDED[6]
        ours = analyze_source(src, "x.py", [UnitsChecker(),
                                            SchedulerPurityChecker()])
        theirs = jax_analyze_source(src, "x.py", [JaxUnits(), JaxPurity()])
        assert _as_tuples(ours) == _as_tuples(theirs) != [], path.name


# ------------------------------------------------------------ the gate
def test_cli_clean_over_the_port():
    """The merge gate: ``src/repro_torch`` lints clean at --fail-on
    warning."""
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--fail-on",
         "warning", "src/repro_torch"], cwd=ROOT, capture_output=True,
        text=True, env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 finding(s)" in res.stderr


def test_cli_fails_on_a_seeded_sync(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import torch\nclass B:\n    def f(self, xs):\n"
                   "        for x in xs:\n"
                   "            print(torch.sum(x).item())\n")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", str(bad)], cwd=ROOT,
        capture_output=True, text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"})
    assert res.returncode == 1
    assert "[torch-host-sync]" in res.stdout


def test_each_mark_in_the_port_suppresses_a_real_sync():
    """The port's marks: two in the batchers (one sync per admission and
    per tick), one in the engine (the early-EOS check); without its mark
    each is a torch-host-sync finding on the statement below it."""
    marked = {}
    for path in sorted((ROOT / "src/repro_torch").rglob("*.py")):
        lines = path.read_text().splitlines()
        hits = [i for i, l in enumerate(lines, 1) if MARK in l]
        if hits and path.parent.name != "analysis":
            marked[path] = hits
    assert {str(p.relative_to(ROOT)): len(h) for p, h in marked.items()} == {
        "src/repro_torch/serving/batching.py": 2,
        "src/repro_torch/serving/engine.py": 1}
    for path, hits in marked.items():
        src = path.read_text().replace(MARK, "")
        found = [f for f in analyze_source(src, str(path))]
        assert sorted(f.line for f in found) == [h + 1 for h in hits]
        assert rules_of(found) == {"torch-host-sync"}
    assert analyze_paths([str(ROOT / "src/repro_torch")]) == []

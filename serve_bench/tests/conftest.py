"""``_tiny.make_root`` maps the benchmark's first two cells to its tiny
ones (``mistral7b.chat`` to ``tiny.dense``, ``zamba2.burst`` to
``tiny.hybrid``) in every metric's ``workloads``. Cells added since have
no tiny stand-in: this drops their names from those lists before the map
(and a metric left with no cell), so the tiny benchmark is the one the
first two cells define."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import _tiny

TINY_CELLS = ("mistral7b.chat", "zamba2.burst")
_make_root = _tiny.make_root


def make_root(tmp: Path) -> Path:
    bench = json.loads((_tiny.REPO / "BENCHMARK.json").read_text())
    for group in ("end_to_end", "per_layer"):
        kept = []
        for m in bench[group]:
            if "workloads" in m:
                m["workloads"] = [w for w in m["workloads"]
                                  if w in TINY_CELLS]
                if not m["workloads"]:
                    continue
            kept.append(m)
        bench[group] = kept
    src = tmp / "repository"
    src.mkdir()
    (src / "BENCHMARK.json").write_text(json.dumps(bench))
    repo, _tiny.REPO = _tiny.REPO, src
    try:
        return _make_root(tmp)
    finally:
        _tiny.REPO = repo
        shutil.rmtree(src)


_tiny.make_root = make_root

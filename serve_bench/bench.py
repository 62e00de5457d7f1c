"""Finding a cell from its files: ``BENCHMARK.json`` names a cell; the cell
names a configuration and a traffic mix; each is a file the harness finds
by that name, and each per-layer metric is a reader file found by the
metric's name. Adding a cell, a configuration, a mix or a metric adds
files and entries and edits none. Under the first directory of
``paths``:

  configs/<file>            the configuration (``file`` in BENCHMARK.json)
  reference/<name>.py       its plain reference (the config's ``reference``)
  traffic/<traffic>.json    the mix
  metrics/<metric>.py       the reader of a per-layer metric: read(trace);
                            a metric ``<q>.<suffix>`` (one quantity split
                            by the end-to-end metric it moves) is read by
                            metrics/<q>.py unless it has a file of its own
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclass
class Cell:
    name: str
    config: Dict                # the configuration file's contents
    traffic_name: str
    traffic: Dict               # the mix file's contents
    chips: int
    end_to_end: List[Dict]      # the metrics this cell reports, trace 0
    per_layer: List[Dict]       # ... and with trace 1
    reference: object           # the reference module
    readers: Dict[str, Callable]


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader_path(base: Path, metric: str) -> Path:
    own = base / "metrics" / f"{metric}.py"
    if own.exists() or "." not in metric:
        return own
    return base / "metrics" / f"{metric.split('.')[0]}.py"


def find_cell(bench: Dict, workload: str, root: Path) -> Cell:
    """The cell ``workload`` of ``bench`` with every file it names loaded
    and checked; ``root`` is the checkout (where BENCHMARK.json lies)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    base = root / bench["paths"][0]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    cfg_path = root / entry["file"]
    config = json.loads(cfg_path.read_text())
    if config["name"] != entry["name"]:
        raise ValueError(f"{cfg_path} names {config['name']!r}, "
                         f"BENCHMARK.json {entry['name']!r}")
    for k in ("model", "dtype", "serving", "correct", "reference"):
        if k not in config:
            raise ValueError(f"{cfg_path} lacks {k!r}")
    ref = load_module(base / config["reference"],
                      f"serve_bench_ref_{config['name'].replace('-', '_')}")
    for fn in ("make_weights", "forward"):
        if not callable(getattr(ref, fn, None)):
            raise ValueError(f"reference {config['reference']} lacks {fn}()")
    if not NAME.match(w["traffic"]):
        raise ValueError(f"traffic name {w['traffic']!r}")
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    from serve_bench import traffic as T
    T.validate(traffic)
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    layers = [m for m in bench["per_layer"] if _applies(m, workload)]
    readers = {}
    for m in layers:
        path = reader_path(base, m["name"])
        mod = load_module(path, "serve_bench_metric_"
                          + re.sub(r"\W", "_", m["name"]))
        if not callable(getattr(mod, "read", None)):
            raise ValueError(f"{path} defines no read(trace)")
        readers[m["name"]] = mod.read
    return Cell(workload, config, w["traffic"], traffic, w["chips"],
                e2e, layers, ref, readers)


def validate(bench: Dict, root: Path) -> List[str]:
    """Every cell found and loaded; names and the cross references checked.
    Returns the cells' names."""
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in bench[group]]
        bad = [n for n in names if not NAME.match(n)]
        if bad or len(set(names)) != len(names):
            raise ValueError(f"{group}: bad or repeated names {names}")
    e2e = {m["name"] for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        raise ValueError("end_to_end lacks setup_s")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            raise ValueError(f"{m['name']} moves unknown {m['moves']!r}")
    for p in bench["paths"]:
        if not (root / p).is_dir():
            raise ValueError(f"path {p} is not a directory")
    cells = []
    for w in bench["workloads"]:
        cell = find_cell(bench, w["name"], root)
        if len(cell.end_to_end) < 2 or not cell.per_layer:
            raise ValueError(f"{w['name']}: needs setup_s, another end-to-end "
                             f"metric and a per-layer metric")
        reported = {m["name"] for m in cell.end_to_end}
        for m in cell.per_layer:
            if m["moves"] not in reported:
                raise ValueError(f"{w['name']} reports {m['name']} but not "
                                 f"{m['moves']}, which it moves")
        cells.append(cell.name)
    return cells

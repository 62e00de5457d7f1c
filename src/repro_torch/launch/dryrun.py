"""The dry run: what every (arch x input shape) puts on each device of the
production mesh, with no device and no allocation (counterpart of
``repro/launch/dryrun.py``, as far as torch goes without XLA).

    python -m repro_torch.launch.dryrun --arch <a> --shape <s> [--multi-pod]

For each combination it builds the step's arguments on the meta device
(``input_specs``), gives every leaf its spec on the 16x16 (or 2x16x16)
``MeshSpec`` (``sharding.specs``) and sums one device's block of each:
the per-device bytes of params, optimizer state, batch and cache, and
their total, ``argument_size_in_bytes`` (the quantity XLA's
``memory_analysis()`` reports under that name for the reference's
compiled step). One JSON record per combination lands in ``RESULTS_DIR``.

What has no counterpart here, and why:

* the reference's ``XLA_FLAGS`` line (512 forced host devices),
  ``lower_and_compile``, ``analyze``, ``parse_collective_bytes`` and
  ``unrolled`` need XLA's compile and its HLO: temp bytes, FLOPs and
  collective bytes are what the compiled program reports, and torch has no
  such program to ask;
* ``make_step`` only builds the function that is lowered;
* ``_component_cfgs``, ``_combine`` and ``component_analysis`` exist only
  to undo XLA's counting of a ``while`` body once (the reference's
  docstring says so). There is no compile to feed them, and the port's
  layers are a Python list, so like ``models/scan_util.py`` they need no
  counterpart; ``--no-components`` goes with them.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import (INPUT_SHAPES, get_config, get_shape,
                                 list_archs, supports_shape)
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import input_specs as ISPEC
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding import specs as SH

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")


def shardings_for(mesh, cfg: ModelConfig, shape: InputShape, abstract_args):
    """The spec trees of the step's arguments, in their order (the
    reference's ``in_shardings``; its ``out_shardings`` only feed jit)."""
    seq_shard = (shape.kind == "decode"
                 and shape.global_batch % SH.axis_sizes(mesh)["data"] != 0)
    p_sh = SH.params_shardings(mesh, abstract_args[0])
    if shape.kind == "train":
        # optimizer state: mu/nu shard like params (+ ZeRO-1 under REPRO_ZERO=1)
        o_sh = {"mu": SH.opt_state_shardings(mesh, abstract_args[1]["mu"]),
                "nu": SH.opt_state_shardings(mesh, abstract_args[1]["nu"]),
                "step": ()}
        return p_sh, o_sh, SH.batch_shardings(mesh, abstract_args[2])
    if shape.kind == "prefill":
        return (p_sh, SH.batch_shardings(mesh, abstract_args[1]),
                SH.cache_shardings(mesh, abstract_args[2], seq_shard=False))
    return (p_sh, SH.batch_shardings(mesh, abstract_args[1]),
            SH.cache_shardings(mesh, abstract_args[2], seq_shard=seq_shard))


def _bytes(mesh, tree, specs, by_layer: bool = False) -> int:
    """One device's bytes of ``tree`` under ``specs`` (trees of one
    structure). ``by_layer``: a list of per-layer subtrees that ZeRO-1
    splits by layer (``zero_layer_axis``) counts ``1 / data`` of its
    layers."""
    if isinstance(tree, torch.Tensor):
        return math.prod(SH.shard_shape(mesh, tuple(tree.shape), specs)) \
            * tree.element_size()
    if isinstance(tree, dict):
        return sum(_bytes(mesh, v, specs[k], by_layer)
                   for k, v in tree.items())
    total = sum(_bytes(mesh, v, s, by_layer) for v, s in zip(tree, specs))
    if by_layer and SH.zero_layer_axis(mesh, len(tree)):
        return total // SH.axis_sizes(mesh)["data"]
    return total


def argument_bytes(mesh, cfg: ModelConfig, shape: InputShape,
                   args=None) -> Dict[str, int]:
    """Per-device bytes of params, opt_state, batch and cache (0 where the
    step takes none) and their sum, ``argument_size_in_bytes``; ``args``
    defaults to ``input_specs``'s meta tensors."""
    cfg = ISPEC.adapt_config(cfg, shape)
    if args is None:
        args = ISPEC.input_specs(cfg, shape)
    specs = shardings_for(mesh, cfg, shape, args)
    names = (("params", "opt_state", "batch") if shape.kind == "train"
             else ("params", "batch", "cache"))
    out = {"params": 0, "opt_state": 0, "batch": 0, "cache": 0}
    for name, tree, spec in zip(names, args, specs):
        out[name] = _bytes(mesh, tree, spec, by_layer=name == "opt_state")
    out["argument_size_in_bytes"] = sum(out.values())
    return out


# --------------------------------------------------------------------- CLI
def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            out_dir: Optional[str] = None,
            force: bool = False) -> Optional[Dict[str, Any]]:
    out_dir = RESULTS_DIR if out_dir is None else out_dir
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = supports_shape(cfg, shape)
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_tag = mesh.tag()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_tag}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "status": "SKIP", "reason": reason}
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        print(f"[dryrun] SKIP {arch} x {shape_name}: {reason}")
        return rec

    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                           "status": "OK"}
    try:
        t0 = time.perf_counter()
        rec["per_device_bytes"] = argument_bytes(mesh, cfg, shape)
        rec["specs_s"] = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 — failures are the experiment result
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    flag = rec["status"]
    extra = ""
    if flag == "OK":
        mb = rec["per_device_bytes"]["argument_size_in_bytes"] / 2**20
        extra = f" specs={rec['specs_s']:.1f}s args/dev={mb:.0f}MiB"
    print(f"[dryrun] {flag} {arch} x {shape_name} ({mesh_tag}){extra}")
    return rec


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                run_one(arch, shape, multi_pod=mp, force=args.force)


if __name__ == "__main__":
    main()

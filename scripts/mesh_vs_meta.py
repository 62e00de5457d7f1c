#!/usr/bin/env python3
"""Compare the dry run's step analysis on a 1x1 mesh of DTensors with the
same step on plain meta tensors, under this process's torch, for
``chip_smoke.py``'s phase-11a cases (reduced first, then at full width).

    PYTHONPATH=src python3 scripts/mesh_vs_meta.py [--full-only]

Under a torch that ``launch.dryrun.analyze`` holds the mesh path on, the
two give the same numbers. This script skips ``analyze``'s version check
(``check_mesh_torch``) so that it can show, on an older torch, how they
part: for each case it prints both records, DTensor's refused ops
(``reshards``), the first op where the two op logs differ and the op at
each peak; a mesh run that raises prints its traceback. It needs no card.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as DR
from repro_torch.launch import step_cost as SC

CASES = (("mistral-7b", "decode", 8, 4096, True),
         ("mistral-7b", "decode", 8, 4096, False),
         ("zamba2-1.2b", "train", 2, 512, False),
         ("whisper-base", "prefill", 4, 448, False))
KEYS = ("flops", "bytes_accessed", "peak_bytes", "temp_size_in_bytes",
        "output_size_in_bytes", "held_argument_bytes")


class LoggedCost(SC.StepCost):
    """``StepCost`` that keeps (op, live bytes after it, result shapes)."""
    made: list = []

    def __init__(self):
        super().__init__()
        self.log = []
        LoggedCost.made.append(self)

    def _count(self, func, args, kwargs, out):
        super()._count(func, args, kwargs, out)
        self.log.append((str(func), self.current,
                         [tuple(t.shape) for t in SC._tensors(out)]))


def _run(cfg, shape, mesh):
    LoggedCost.made.clear()
    return DR.analyze(cfg, shape, mesh), LoggedCost.made[-1].log


def _parting(plain_log, mesh_log) -> None:
    i = 0
    while i < min(len(plain_log), len(mesh_log)) \
            and plain_log[i] == mesh_log[i]:
        i += 1
    print(f"   op logs: plain {len(plain_log)}, mesh {len(mesh_log)}; "
          f"first difference at op {i}")
    for j in range(max(0, i - 3), min(i + 6, max(len(plain_log),
                                                  len(mesh_log)))):
        print(f"   {j} plain {plain_log[j] if j < len(plain_log) else None}")
        print(f"   {j} mesh  {mesh_log[j] if j < len(mesh_log) else None}")
    for name, log in (("plain", plain_log), ("mesh", mesh_log)):
        k = max(range(len(log)), key=lambda n: log[n][1])
        print(f"   {name} peak at op {k}: {log[k]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-only", action="store_true")
    args = ap.parse_args()
    print(sys.version.split()[0], torch.__version__, flush=True)
    SC.StepCost = LoggedCost
    DR.check_mesh_torch = lambda version=None: None
    for reduced in ((False,) if args.full_only else (True, False)):
        for arch, kind, B, S, quant in CASES:
            if reduced:
                B, S = 2, 64
            cfg = get_config(arch)
            cfg = cfg.reduced() if reduced else cfg
            shape = InputShape(f"{kind}_{S}", S, B, kind)
            os.environ.pop("REPRO_KV_QUANT", None)
            if quant:
                os.environ["REPRO_KV_QUANT"] = "1"
            label = (f"{'reduced ' if reduced else ''}{arch} {kind} B {B} "
                     f"S {S}{' int8 KV' if quant else ''}")
            t0 = time.perf_counter()
            plain, plain_log = _run(cfg, shape, None)
            try:
                mesh, mesh_log = _run(cfg, shape, DR.ONE_DEVICE)
            except Exception:        # noqa: BLE001 — the finding to print
                print(f"[{label}] the 1x1 mesh raised:", flush=True)
                traceback.print_exc(limit=30, file=sys.stdout)
                continue
            same = all(plain[k] == mesh[k] for k in KEYS)
            print(f"[{label}] {time.perf_counter() - t0:.1f} s, equal "
                  f"{same}; plain {({k: plain[k] for k in KEYS})}; mesh "
                  f"{({k: mesh[k] for k in KEYS})}; reshards "
                  f"{mesh['reshards']}", flush=True)
            if not same:
                _parting(plain_log, mesh_log)
    os.environ.pop("REPRO_KV_QUANT", None)


if __name__ == "__main__":
    main()

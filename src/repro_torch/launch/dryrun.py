"""The dry run: what every (arch x input shape) puts on, and does on, each
device of the production mesh, with no device and no allocation
(counterpart of ``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch <a> --shape <s> [--multi-pod]
    python -m repro_torch.launch.dryrun --both-meshes [--force]   # all 80

For each combination it builds the step's arguments on the meta device
(``input_specs``) and gives every leaf its spec on the 16x16 (or 2x16x16)
``MeshSpec`` (``sharding.specs``). ``argument_bytes`` sums one device's
block of each: params, optimizer state, batch, cache and their total,
``argument_size_in_bytes``. ``analyze`` then runs the step itself
(``make_step``: the reference's three steps on the ``ref`` path, so no
kernel is called) once on that device's meta shards, as DTensors on a
``DeviceMesh`` over a fake process group of the mesh's size, and counts
what one device does (``step_cost.StepCost``):

* ``flops``: matmul, bmm, einsum and convolution FLOPs (2·M·N·K),
  forward and backward, the recompute under remat included
  (the reference's ``hlo_flops_raw``);
* ``bytes_accessed``: operand and result bytes of every op, unfused, an
  upper bound on what a fusing compiler moves (the reference's
  ``hlo_bytes_raw`` is fused and not comparable);
* ``argument_size_in_bytes``, ``output_size_in_bytes``;
* ``peak_bytes``: the most live bytes during the step, the arguments the
  caller holds included, each storage once; ``temp_size_in_bytes`` that
  peak less the held arguments. XLA donates and aliases; the eager step
  does not, so AdamW's old and new state coexist, as on the card;
* ``collectives``: bytes (result shapes, as ``parse_collective_bytes``
  sums them) and ``counts`` of each op of ``COLLECTIVE_OPS``, by XLA's
  names. They are DTensor's plan, chosen op by op (partial sums are
  reduced at once, as one all-reduce), not GSPMD's plan of the whole
  program, so per-op counts and bytes differ from the reference's
  (``tests/test_torch_dryrun_cost.py`` pins the port's and prints the
  gap); do not quote them as GSPMD's;
* ``reshards``: ops DTensor refused, done as a partitioner would
  (``step_cost``'s docstring says how), with their counts;
* ``trace_s``: seconds to build and run the step on meta (the
  reference's ``lower_s`` + ``compile_s``).

The mesh is a "cuda" ``DeviceMesh``: on a "cpu" one DTensor books a
shard-to-shard move as an all-gather (gloo has no all-to-all), on a
"cuda" one it stays an all-to-all; the fake group runs nothing, so no
card is needed. On 2x16x16 the ("pod", "data") pair the batch splits
over is one mesh dim of 32 (``_fold_pods``). A 1x1 mesh gives exactly
the numbers of the same step on plain meta tensors
(``analyze(..., mesh=None)``) under the torch the mesh path is held on
(``MESH_TORCH`` and later); on an older torch ``analyze`` refuses a mesh
and names the version: under 2.11 DTensor refuses the decode's cache
writes and the count of int8 decode's temporaries grows by 268,920,064
bytes on 1x1, and zamba2's train step stops at a spec with one placement
on a two-dim mesh. A step that DTensor still refuses is a FAIL record
carrying the op and DTensor's message. ``measure_step`` runs
the same step on the card, where FlopCounterMode and the allocator's
requested-bytes peak check one device's prediction (``chip_smoke.py``'s
phase 12).

What has no counterpart here, and why: ``unrolled``, ``_component_cfgs``,
``_combine`` and ``component_analysis`` undo XLA's counting of a
``while`` body once, and the reference's ``XLA_FLAGS`` line forces host
devices for its compile. The port's layers are a Python list and its
step runs op by op, so the full-depth count is already exact and a
record has no ``extrapolated`` part; ``--no-components`` goes with them.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import (INPUT_SHAPES, get_config, get_shape,
                                 list_archs, supports_shape)
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import input_specs as ISPEC
from repro_torch.launch import step_cost as SC
from repro_torch.launch.mesh import MeshSpec, make_production_mesh
from repro_torch.models import model as M
from repro_torch.sharding import specs as SH
from repro_torch.training import optimizer as OPT
from repro_torch.training import train as TR

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")
COLLECTIVE_OPS = SC.COLLECTIVE_OPS
ONE_DEVICE = MeshSpec(("data", "model"), (1, 1))
# the oldest torch whose DTensor the mesh path is held on (a 1x1 mesh gives
# the plain-meta numbers exactly: tests/test_torch_dryrun_cost.py)
MESH_TORCH = (2, 13)


def check_mesh_torch(version: Optional[str] = None) -> None:
    """Raises on a torch older than ``MESH_TORCH`` (this one's unless
    ``version`` is given), naming it."""
    version = version or torch.__version__
    got = tuple(int(v) for v in re.match(r"(\d+)\.(\d+)", version).groups())
    if got < MESH_TORCH:
        raise RuntimeError(
            f"analyze on a mesh is held on torch "
            f"{'.'.join(map(str, MESH_TORCH))} and later, not on {version}: "
            f"its DTensor gives other numbers there; use mesh=None (one "
            f"device, plain meta tensors)")


# --------------------------------------------------------------------- steps
def make_step(cfg: ModelConfig, shape: InputShape, backend: str = "ref"):
    """The step the dry run runs for ``shape``'s kind, on the ``ref`` path
    (as the reference's ``make_step`` builds it) unless asked."""
    if shape.kind == "train":
        return TR.make_train_step(cfg, OPT.AdamWConfig(), backend=backend,
                                  remat=True)
    if shape.kind == "prefill":
        def prefill_step(params, batch, cache):
            return M.prefill(params, cfg, batch, cache, backend=backend)
        return prefill_step

    def serve_step(params, tokens, cache):
        return M.decode_step(params, cfg, tokens, cache, backend=backend)
    return serve_step


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


# --------------------------------------------------------------------- analysis
@contextmanager
def fake_mesh(mesh: MeshSpec):
    """A "cuda" ``DeviceMesh`` with ``mesh``'s names and sizes over a fake
    process group of ``mesh.size`` ranks, this process rank 0; the group
    is destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own process group; one "
                           "is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield init_device_mesh("cuda", mesh.axis_sizes,
                               mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()


def _distribute(device_mesh, mesh, tree, specs):
    """Meta leaves -> DTensors whose local shards are meta tensors of the
    spec's ``shard_shape``. A mesh dim of size 1 is ``Replicate()``: a
    shard over it is the whole tensor, and DTensor would otherwise pick
    strategies that move it for nothing."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(tree, torch.Tensor):
        local = torch.empty(SH.shard_shape(mesh, tuple(tree.shape), specs),
                            dtype=tree.dtype, device="meta")
        placements = [p if n > 1 else Replicate() for p, n in zip(
            SH.to_placements(device_mesh, specs), mesh.axis_sizes)]
        return DTensor.from_local(local, device_mesh, placements,
                                  shape=tree.shape, stride=tree.stride(),
                                  run_check=False)
    if isinstance(tree, dict):
        return {k: _distribute(device_mesh, mesh, v, specs[k])
                for k, v in tree.items()}
    return [_distribute(device_mesh, mesh, v, s) for v, s in zip(tree, specs)]


def _fold_pods(mesh: MeshSpec, specs):
    """``mesh`` and ``specs`` with ("pod", "data") folded into one "data"
    mesh dim of pod x data devices, when every spec names "pod" only in
    that pair (the default rules: params replicated across pods, batch and
    cache split over both). A device's block is the same; DTensor then
    shards a batch over one mesh dim, where over two ([Shard(0), Shard(0)])
    most of its rules refuse, and a gradient is one all-reduce over the
    pod x data replicas, as XLA's."""
    if "pod" not in mesh.axis_names:
        return mesh, specs
    pair = ("pod", "data")

    def fold(spec):
        if isinstance(spec, dict):
            return {k: fold(v) for k, v in spec.items()}
        if isinstance(spec, list):
            return [fold(v) for v in spec]
        if "pod" in spec or "data" in spec:     # one of the pair alone
            raise ValueError(spec)
        return tuple("data" if a == pair else a for a in spec)
    try:
        folded = tuple(fold(tree) for tree in specs)
    except ValueError:
        return mesh, specs
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    names = [n for n in mesh.axis_names if n != "pod"]
    return MeshSpec(tuple(names), tuple(
        sizes["pod"] * sizes["data"] if n == "data" else sizes[n]
        for n in names)), folded


def _local(tree):
    """A tree's leaves as this device holds them (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in SC._tensors(tree)]


def count_step(step, args) -> Dict[str, Any]:
    """Run ``step(*args)`` once under ``StepCost`` and return one device's
    numbers; ``args`` (plain or DTensor leaves) are held by the caller
    throughout. A failure is raised with the op that failed as its
    ``failed_op``."""
    from torch.distributed.tensor.experimental import implicit_replication
    cost = SC.StepCost()
    held = cost.track(_local(args))
    try:
        with implicit_replication(), cost:
            out = step(*args)
    except Exception as e:
        e.failed_op = cost.failed_op
        raise
    coll = dict(cost.collectives)
    coll["counts"] = dict(cost.counts)
    return {"flops": cost.flops, "bytes_accessed": cost.bytes_accessed,
            "held_argument_bytes": held,
            "output_size_in_bytes": cost.live_bytes(_local(out)),
            "peak_bytes": cost.peak, "temp_size_in_bytes": cost.peak - held,
            "collectives": coll, "reshards": dict(cost.reshards)}


def analyze(cfg: ModelConfig, shape: InputShape,
            mesh: Optional[MeshSpec] = None) -> Dict[str, Any]:
    """One device's numbers for the step of ``shape`` on ``mesh`` (the
    module docstring lists them), counted on meta shards as DTensors over
    a fake process group; ``mesh=None`` runs plain meta tensors, one
    device. ``held_argument_bytes`` is what the run held: it exceeds
    ``argument_size_in_bytes`` only where ZeRO-1 splits a layer list by
    layer (``zero_layer_axis``), which no placement expresses. A mesh on a
    torch older than ``MESH_TORCH`` raises (``check_mesh_torch``)."""
    if mesh is not None:
        check_mesh_torch()
    t0 = time.perf_counter()
    cfg = ISPEC.adapt_config(cfg, shape)
    args = ISPEC.input_specs(cfg, shape)
    arg_bytes = argument_bytes(mesh or ONE_DEVICE, cfg, shape, args)
    step = make_step(cfg, shape)
    if mesh is None:
        out = count_step(step, args)
    else:
        run_mesh, specs = _fold_pods(
            mesh, shardings_for(mesh, cfg, shape, args))
        with fake_mesh(run_mesh) as device_mesh:
            dargs = tuple(_distribute(device_mesh, run_mesh, a, s)
                          for a, s in zip(args, specs))
            del args
            out = count_step(step, dargs)
            del dargs
    out["argument_size_in_bytes"] = arg_bytes["argument_size_in_bytes"]
    out["trace_s"] = time.perf_counter() - t0
    return out


def _median_ms(step, args, reps: int) -> float:
    """Median of ``reps`` calls' walls between CUDA events, after one
    call untimed."""
    out = step(*args)
    del out
    walls = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args)
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end))
        del out
    return sorted(walls)[len(walls) // 2]


def measure_step(cfg: ModelConfig, shape: InputShape, *,
                 reps: int = 3) -> Dict[str, Any]:
    """The card's check of ``analyze``'s prediction on one device: the step
    of ``shape`` run for real, its arguments built by ``input_specs`` on
    the card (token ids 0, frame and vision embeddings normal from seed
    0). One call on the ``ref`` path makes cuBLAS's and cuDNN's workspaces;
    the peak counters are reset and a second runs under
    ``FlopCounterMode``. Returns its ``flops``, ``temp_size_in_bytes``
    (the allocator's requested-bytes peak less the bytes in use before
    the call), that ``before``, and with ``reps`` the median walls (ms,
    CUDA events) of the ``ref`` path and of the kernel path
    (``backend="auto"``)."""
    import gc

    from torch.utils.flop_counter import FlopCounterMode
    cfg = ISPEC.adapt_config(cfg, shape)
    args = ISPEC.input_specs(cfg, shape, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    batch = args[2] if shape.kind == "train" else args[1]
    for t in SC._tensors(batch):
        if t.is_floating_point():
            t.normal_(generator=gen)
        else:
            t.zero_()
    ref = make_step(cfg, shape)
    out = ref(*args)
    del out
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    with FlopCounterMode(display=False) as counter:
        out = ref(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    del out
    got = {"flops": counter.get_total_flops(),
           "temp_size_in_bytes": peak - before, "before": before}
    if reps:
        got["ref_ms"] = _median_ms(ref, args, reps)
        got["kernel_ms"] = _median_ms(make_step(cfg, shape, backend="auto"),
                                      args, reps)
    del args, batch
    gc.collect()
    torch.cuda.empty_cache()
    return got


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
        rec["full"] = analyze(cfg, shape, mesh)
    except Exception as e:  # noqa: BLE001 — failures are the experiment result
        rec["status"] = "FAIL"
        rec["op"] = getattr(e, "failed_op", None)
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    flag = rec["status"]
    extra = ""
    if flag == "OK":
        full = rec["full"]
        mb = rec["per_device_bytes"]["argument_size_in_bytes"] / 2**20
        coll = {op: full["collectives"][op] for op in COLLECTIVE_OPS
                if full["collectives"][op]}
        extra = (f" trace={full['trace_s']:.1f}s args/dev={mb:.0f}MiB"
                 f" flops/dev={full['flops']:.4g}"
                 f" temp/dev={full['temp_size_in_bytes'] / 2**20:.0f}MiB"
                 f" coll={coll}")
    elif rec.get("op"):
        extra = f" at {rec['op']}"
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

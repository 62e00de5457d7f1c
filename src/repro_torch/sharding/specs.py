"""Partition specs for params, caches and batches (counterpart of
``repro/sharding/specs.py``).

Strategy (Megatron-style tensor parallel on the "model" axis, data parallel
on "data", pure replicas across "pod"):

  * embeddings / unembed: vocab dim on "model";
  * attention q/k/v: output (head) dim on "model" where divisible, o: input
    dim on "model";
  * mlp up/gate: d_ff on "model"; down: d_ff (input) on "model";
  * MoE: expert dim on "model" when expert count divides, else d_ff within
    experts on "model" (grok: 8 experts on a 16-way axis);
  * mamba: d_inner-shaped dims on "model";
  * batch dims on "data"; for decode shapes whose batch doesn't divide the
    axis, the KV-cache *sequence* dim shards on "data" instead (long-context
    mode).

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), a
mesh-axis name, or a tuple of names (the dim split over their product, in
mesh order). Every spec passes through ``_fit``: any dim not divisible by
its mesh axes is replicated, so one rule set serves all 10 architectures
and every shard is the same size. The rules are pure functions of shapes
and names; ``to_placements`` turns a spec into DTensor placements at the
edge.

A mesh is anything ``axis_sizes`` reads: an object whose ``.shape`` maps
axis names to sizes (``launch.mesh.MeshSpec``, a test's fake), or a
``torch.distributed.device_mesh.DeviceMesh``.

The port's params hold each stacked layer subtree as a list of per-layer
dicts, so a leaf's path reads ``layers/3/attn/q/w``: the layer index sits
above the names the rules read, and the leaf has no layer axis. Where the
reference's ZeRO-1 pick falls on that axis, ``zero_layer_axis`` says so.
"""
from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh-axis name -> size, in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                   # a DeviceMesh
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def _axis_size(mesh, name: Optional[str]) -> int:
    if name is None:
        return 1
    return axis_sizes(mesh).get(name, 1)


def _axes(ax: Axis) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


def model_axes(mesh) -> Union[str, Tuple[str, str]]:
    """The tensor-parallel axis group: "model", or ("expert","tp") on MoE
    meshes where the 16-way axis is factorized for expert parallelism."""
    return ("expert", "tp") if "expert" in axis_sizes(mesh) else "model"


def _remap(mesh, spec: Spec) -> Spec:
    """Replace the logical "model" axis with the mesh's TP axis group."""
    ma = model_axes(mesh)
    if ma == "model":
        return spec
    out = []
    for ax in spec:
        if ax == "model":
            out.append(ma)
        elif isinstance(ax, tuple):
            out.append(tuple(ma if a == "model" else a for a in ax))
        else:
            out.append(ax)
    return tuple(out)


def _fit(mesh, shape, spec: Spec) -> Spec:
    """Drop sharding on dims that the mesh axis doesn't divide."""
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            fixed.append(None)
            continue
        total = math.prod(_axis_size(mesh, a) for a in _axes(ax))
        fixed.append(ax if dim % total == 0 else None)
    return tuple(fixed)


# --------------------------------------------------------------------- params
def param_spec(cfg, path: str, shape, expert_mesh: bool = False) -> Spec:
    """Logical spec by param path (joined with '/'). Leading dims beyond
    the rule's (a stacked layer axis, where a tree has one) are never
    sharded."""
    n = path.split("/")
    leaf = n[-1]
    parent = n[-2] if len(n) >= 2 else ""
    gp = n[-3] if len(n) >= 3 else ""

    def base(spec: Spec) -> Spec:
        extra = len(shape) - len(spec)
        return (None,) * extra + spec if extra > 0 else spec

    if leaf == "emb":           # (V, d) token / (S, d) position embeddings
        if parent in ("dec_pos",):
            return base((None, None))
        return base(("model", None))
    if parent in ("q", "k", "v") or gp in ("q", "k", "v"):
        if leaf == "w":
            return base((None, "model"))
        return base(("model",))            # bias on the sharded output dim
    if parent == "o":
        return base(("model", None)) if leaf == "w" else base((None,))
    if parent in ("gate", "up"):
        return base((None, "model")) if leaf == "w" else base(("model",))
    if parent == "down":
        return base(("model", None)) if leaf == "w" else base((None,))
    if parent == "router":
        return base((None, None))
    if leaf in ("gate", "up") and "moe" in n:       # moe expert stacks (E, d, ff)
        if expert_mesh:
            return base(("expert", None, "tp"))
        return base(("model", None, None)) if shape_div(shape, -3) \
            else base((None, None, "model"))
    if leaf == "down" and "moe" in n:               # (E, ff, d)
        if expert_mesh:
            return base(("expert", "tp", None))
        return base(("model", None, None)) if shape_div(shape, -3) \
            else base((None, "model", None))
    if parent in ("zx_proj", "bc_proj"):            # mamba (d, 2di) / (d, 2N)
        return base((None, "model")) if leaf == "w" else base(("model",))
    if parent == "dt_proj":                         # (d, H): H rarely divides
        return base((None, None))
    if parent == "out_proj":                        # (di, d)
        return base(("model", None)) if leaf == "w" else base((None,))
    if leaf in ("conv_w", "conv_b"):
        return base(()) if leaf == "conv_b" else base((None, None))
    # norms, A_log, D, dt_bias, scalars
    return (None,) * len(shape)


def shape_div(shape, idx: int, by: int = 16) -> bool:
    try:
        return shape[idx] % by == 0
    except IndexError:
        return False


def param_spec_from_path(pstr: str, shape, expert_mesh: bool = False) -> Spec:
    # cfg not needed: rules are purely structural
    return param_spec(None, pstr, shape, expert_mesh)


def map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists, keeping its
    structure; ``path`` joins keys and list indices with '/'."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def params_shardings(mesh, params_tree) -> Any:
    """Spec tree matching a params tree (meta tensors do).

    REPRO_SHARDING=replicated switches to pure data parallelism (params
    replicated, batch sharded) — the right-sized strategy for models far
    smaller than the mesh (smollm-360m), where TP activation all-reduces
    dominate and per-chip weights are tiny anyway.
    """
    replicated = os.environ.get("REPRO_SHARDING") == "replicated"
    expert_mesh = "expert" in axis_sizes(mesh)

    def one(path, leaf):
        if replicated:
            return (None,) * leaf.dim()
        spec = param_spec_from_path(path, tuple(leaf.shape), expert_mesh)
        return _fit(mesh, leaf.shape, _remap(mesh, spec))
    return map_with_path(one, params_tree)


def zero_layer_axis(mesh, n_layers: int) -> bool:
    """Whether REPRO_ZERO=1 shards a stacked layer subtree of ``n_layers``
    over "data" by layer: the reference's ZeRO-1 pick falls on the first
    divisible unsharded dim, which for a stacked leaf is its layer axis
    when ``n_layers`` divides. A per-layer leaf then keeps its params spec,
    and each data rank holds ``n_layers / data`` of the list's moments."""
    return os.environ.get("REPRO_ZERO") == "1" \
        and n_layers % _axis_size(mesh, "data") == 0


def opt_state_shardings(mesh, mu_tree) -> Any:
    """Optimizer-moment shardings. REPRO_ZERO=1 adds ZeRO-1: each moment
    leaf additionally shards its first divisible, still-unsharded dim over
    "data" (moments are only touched at the update point, so slicing them
    across data ranks costs one reduce-scatter/all-gather pair per step but
    divides their 8-bytes/param residency by the data-axis size). A list of
    per-layer subtrees counts its length as that first dim
    (``zero_layer_axis``)."""
    base = params_shardings(mesh, mu_tree)
    if os.environ.get("REPRO_ZERO") != "1":
        return base
    dsize = _axis_size(mesh, "data")

    def zero(spec: Spec, leaf) -> Spec:
        out = list(spec)
        for i, (dim, ax) in enumerate(zip(leaf.shape, out)):
            if ax is None and dim % dsize == 0:
                out[i] = "data"
                break
        return tuple(out)

    def walk(specs, leaves):
        if isinstance(leaves, dict):
            return {k: walk(specs[k], v) for k, v in leaves.items()}
        if isinstance(leaves, list):
            if zero_layer_axis(mesh, len(leaves)):
                return specs
            return [walk(s, v) for s, v in zip(specs, leaves)]
        return zero(specs, leaves)
    return walk(base, mu_tree)


# --------------------------------------------------------------------- batch/cache
def _dp(mesh) -> Axis:
    return ("pod", "data") if "pod" in axis_sizes(mesh) else "data"


def batch_shardings(mesh, batch_tree, shape_kind: str = "train") -> Any:
    """Shard batch dims on ("pod","data") when divisible; else replicate."""
    dp = _dp(mesh)

    def one(_path, leaf):
        spec = tuple(dp if i == 0 else None for i in range(leaf.dim()))
        return _fit(mesh, leaf.shape, spec)
    return map_with_path(one, batch_tree)


def cache_shardings(mesh, cache_tree, *, seq_shard: bool = False) -> Any:
    """KV caches: (L, B, Hkv, S, D) — batch on data, heads on model.
    seq_shard=True (long-context, batch=1): shard the sequence dim on data
    instead of batch."""
    dp = _dp(mesh)

    def one(path, leaf):
        name = path.rsplit("/", 1)[-1]
        nd = leaf.dim()
        if name == "pos":
            spec = (dp,) if not seq_shard else (None,)
        elif name in ("k", "v", "ak", "av", "ck", "cv",
                      "k_scale", "v_scale") and nd == 5:
            # (L, B, Hkv, S, D)
            tp_total = math.prod(_axis_size(mesh, a)
                                 for a in _axes(model_axes(mesh)))
            if seq_shard:
                # long-context mode (batch < data axis): sequence on data
                spec = (None, None, "model", dp, None)
            elif leaf.shape[2] % tp_total == 0:
                spec = (None, dp, "model", None, None)
            else:
                # GQA head count doesn't divide the model axis: shard the
                # sequence dim on "model" instead of replicating 16x the cache
                spec = (None, dp, None, "model", None)
        elif name == "conv" and nd == 4:        # (L, B, W-1, ch)
            spec = (None, dp if not seq_shard else None, None, "model")
        elif name == "ssm" and nd == 5:         # (L, B, H, P, N)
            spec = (None, dp if not seq_shard else None, "model", None, None)
        else:
            spec = (None,) * nd
        return _fit(mesh, leaf.shape, _remap(mesh, spec))
    return map_with_path(one, cache_tree)


# --------------------------------------------------------------------- edge
def shard_shape(mesh, shape, spec: Spec) -> Tuple[int, ...]:
    """One device's block of a tensor of ``shape`` under a fitted spec
    (every sharded dim divides, so all blocks are this size)."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        total = math.prod(_axis_size(mesh, a) for a in _axes(ax))
        assert dim % total == 0, (shape, spec)
        out.append(dim // total)
    return tuple(out)


def to_placements(mesh, spec: Spec) -> list:
    """DTensor placements on ``mesh`` (a DeviceMesh) for a spec: a tensor
    dim whose entry names mesh axes gets ``Shard(dim)`` on each of those
    mesh dims; every other mesh dim is ``Replicate()``. A dim split over a
    tuple of axes is split major to minor, which is DTensor's order when
    the tuple is in mesh order, as every tuple the rules make is."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    placements = [Replicate() for _ in names]
    for dim, ax in enumerate(spec):
        idx = []
        for a in _axes(ax):
            if a not in names:
                raise ValueError(f"axis {a!r} of spec {spec} is not in the "
                                 f"mesh's {names}")
            idx.append(names.index(a))
        assert idx == sorted(idx), f"{ax} is not in mesh order {names}"
        for j in idx:
            assert isinstance(placements[j], Replicate), \
                f"mesh axis {names[j]!r} shards two dims of {spec}"
            placements[j] = Shard(dim)
    return placements

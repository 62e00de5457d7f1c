"""The port's dry run against the JAX package's: input specs on the meta
device, sharding rules, per-device argument bytes, and the CLI.

* ``repro_torch.launch.input_specs`` gives, for every arch x supported
  input shape, the leaves of ``repro.launch.input_specs.input_specs`` in
  shape and dtype (the reference's stacked layer axis unstacked as
  ``models/convert.py`` unstacks it), allocating nothing;
* ``repro_torch.sharding.specs`` holds every rule of tests/test_sharding.py
  and gives each leaf the spec JAX's rules give its stacked counterpart,
  layer axis dropped, on 16x16, 2x16x16 and grok-1's (16, 8, 2) expert
  mesh, under the default, REPRO_SHARDING=replicated and REPRO_ZERO=1;
* ``repro_torch.launch.dryrun.argument_bytes`` equals the sum of
  ``NamedSharding(AbstractMesh, spec).shard_shape`` x itemsize over JAX's
  abstract args, with no compile. ``shardings_for``'s few lines are
  rebuilt here from ``repro.sharding.specs``: ``repro.launch.dryrun`` sets
  XLA_FLAGS when imported and is never imported by the tests.
"""
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.launch import input_specs as JIS
from repro.sharding import specs as JSH
from repro_torch.configs import (INPUT_SHAPES, get_config, get_shape,
                                 list_archs, supports_shape)
from repro_torch.launch import dryrun as DR
from repro_torch.launch import input_specs as IS
from repro_torch.launch.mesh import MeshSpec, make_production_mesh
from repro_torch.models import convert

STACKED = set(convert.STACKED)
from repro_torch.sharding import specs as SH

SUPPORTED = [(a, s) for a in list_archs() for s in INPUT_SHAPES
             if supports_shape(get_config(a), get_shape(s))[0]]
MESHES = {  # name: (the port's MeshSpec, JAX's AbstractMesh)
    "16x16": (make_production_mesh(),
              AbstractMesh((16, 16), ("data", "model"))),
    "2x16x16": (make_production_mesh(multi_pod=True),
                AbstractMesh((2, 16, 16), ("pod", "data", "model"))),
    "16x8x2": (make_production_mesh(moe_experts=8),
               AbstractMesh((16, 8, 2), ("data", "expert", "tp"))),
}
ENVS = {"default": {}, "replicated": {"REPRO_SHARDING": "replicated"},
        "zero": {"REPRO_ZERO": "1"}}


class FakeMesh:
    """Mesh stub with arbitrary axis sizes for rule testing (no devices)."""
    def __init__(self, **axes):
        self.shape = axes


# ------------------------------------------------------------ tree helpers
def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", "")))
                     for p in path): leaf for path, leaf in flat}


def _port_flat(tree):
    out = {}
    SH.map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


def _unstack(path):
    """A port leaf's path -> (the reference's path, layer index or None)."""
    parts = path.split("/")
    for k in range(len(parts) - 1):
        if parts[k] in STACKED and parts[k + 1].isdigit():
            return "/".join(parts[:k + 1] + parts[k + 2:]), int(parts[k + 1])
    return path, None


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def _assert_leaves_match(port_tree, jax_tree):
    """Every port leaf has the reference leaf's shape (a stacked one's
    without its layer axis) and dtype; every reference leaf is covered."""
    jflat = _jax_flat(jax_tree)
    seen = {}
    for path, t in _port_flat(port_tree).items():
        assert t.is_meta, path
        jpath, i = _unstack(path)
        j = jflat[jpath]
        want = tuple(j.shape[1:]) if i is not None else tuple(j.shape)
        assert tuple(t.shape) == want, (path, t.shape, j.shape)
        assert _dtype(t) == str(j.dtype), (path, t.dtype, j.dtype)
        seen[jpath] = seen.get(jpath, 0) + 1
    for jpath, j in jflat.items():
        layered = bool(STACKED & set(jpath.split("/")))
        assert seen.get(jpath, 0) == (j.shape[0] if layered else 1), jpath


def _with_kv_quant(kv_quant, fn):
    old = os.environ.pop("REPRO_KV_QUANT", None)
    if kv_quant:
        os.environ["REPRO_KV_QUANT"] = "1"
    try:
        return fn()
    finally:
        os.environ.pop("REPRO_KV_QUANT", None)
        if old is not None:
            os.environ["REPRO_KV_QUANT"] = old


# both packages' args, built once per file (neither is modified by a test)
@functools.lru_cache(maxsize=None)
def _jax_args(arch, shape_name, kv_quant=False):
    shape = get_shape(shape_name)
    return _with_kv_quant(kv_quant, lambda: JIS.input_specs(
        JIS.adapt_config(jax_config(arch), shape), shape))


@functools.lru_cache(maxsize=None)
def _port_args(arch, shape_name, kv_quant=False):
    return _with_kv_quant(kv_quant, lambda: IS.input_specs(
        get_config(arch), get_shape(shape_name)))


# ------------------------------------------------------------ 10a
@pytest.mark.parametrize("arch,shape", SUPPORTED)
def test_input_specs_equal_jax(arch, shape):
    port, ref = _port_args(arch, shape), _jax_args(arch, shape)
    assert len(port) == len(ref) == 3
    for p, j in zip(port, ref):
        if isinstance(p, torch.Tensor):             # decode's tokens
            assert p.is_meta and tuple(p.shape) == j.shape
            assert _dtype(p) == str(j.dtype)
        else:
            _assert_leaves_match(p, j)
    if get_shape(shape).kind == "train":
        assert _dtype(port[1]["step"]) == "int32"


@pytest.mark.parametrize("arch,shape", SUPPORTED)
def test_cache_specs_under_kv_quant_equal_jax(arch, shape):
    kind = get_shape(shape).kind
    port = _port_args(arch, shape, kv_quant=True)
    ref = _jax_args(arch, shape, kv_quant=True)
    if kind == "train":
        assert set(port[2]) == set(ref[2])
        return
    _assert_leaves_match(port[2], ref[2])
    int8 = get_config(arch).family in ("dense", "moe", "vlm")
    k = port[2].get("k")
    assert (k is not None and k.dtype == torch.int8) == int8
    assert ("k_scale" in port[2]) == int8


def test_adapt_config_windows_long_500k_on_attention_archs():
    for arch in list_archs():
        cfg = get_config(arch)
        got = IS.adapt_config(cfg, get_shape("long_500k"))
        want = JIS.adapt_config(jax_config(arch), get_shape("long_500k"))
        assert got.sliding_window == want.sliding_window
        assert IS.adapt_config(cfg, get_shape("decode_32k")) == cfg


def test_meta_specs_of_grok_allocate_nothing():
    args = _port_args("grok-1-314b", "train_4k")
    leaves = [t for tree in args for t in _port_flat(tree).values()]
    assert all(t.is_meta for t in leaves)
    assert sum(t.numel() for t in _port_flat(args[0]).values()) \
        == 213_410_125_824


# ------------------------------------------------------------ 10b: rules
def test_fit_drops_nondivisible():
    mesh = FakeMesh(pod=2, data=16, model=16)
    assert SH._fit(mesh, (32, 64), ("data", "model")) == ("data", "model")
    assert SH._fit(mesh, (30, 64), ("data", "model")) == (None, "model")
    assert SH._fit(mesh, (32, 65), ("data", "model")) == ("data", None)
    assert SH._fit(mesh, (5,), (("pod", "data"),)) == (None,)


def test_fit_multi_axis_product():
    mesh = FakeMesh(pod=2, data=16)
    assert SH._fit(mesh, (64,), (("pod", "data"),)) == (("pod", "data"),)
    assert SH._fit(mesh, (16,), (("pod", "data"),)) == (None,)


@pytest.mark.parametrize("mesh", [FakeMesh(data=16, model=16),
                                  FakeMesh(pod=2, data=16, model=16)],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_cover_all_leaves(arch, mesh):
    """Every param leaf gets a spec whose ndim matches, and every sharded
    dim divides; the core matmul weights of every layer shard."""
    cfg = get_config(arch)
    params = IS.params_specs(cfg, get_shape("train_4k"))
    n_sharded = 0
    for path, leaf in _port_flat(params).items():
        spec = SH.param_spec_from_path(path, tuple(leaf.shape))
        fitted = SH._fit(mesh, leaf.shape, spec)
        assert len(fitted) == leaf.dim()
        for dim, ax in zip(leaf.shape, fitted):
            if ax is not None:
                n_sharded += 1
                assert dim % 16 == 0, (path, leaf.shape, fitted)
    # per-layer leaves: at least three sharded leaf-dims in every layer
    assert n_sharded >= 3 * cfg.num_layers, arch


def test_cache_shardings_modes():
    cfg = get_config("qwen2.5-3b")      # kv=2: heads don't divide 16
    cache = IS.cache_specs(cfg, get_shape("decode_32k"))
    mesh = FakeMesh(data=16, model=16)
    sh = SH.cache_shardings(mesh, cache)
    assert cache["k"].shape[2] == 2
    # heads dim not divisible -> the rule picks the sequence on "model"
    assert sh["k"] == (None, "data", None, "model", None)
    assert SH.cache_shardings(mesh, cache, seq_shard=True)["k"] \
        == (None, None, None, "data", None)
    assert sh["pos"] == ("data",)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-130m", "zamba2-1.2b",
                                  "whisper-base"])
def test_cache_shardings_on_a_1x1_mesh(arch):
    """On a 1x1 mesh the spec tree builds for every family, has the
    cache's structure, and shards nothing."""
    mesh = MeshSpec(("data", "model"), (1, 1))
    cfg = get_config(arch)
    cache = IS.cache_specs(cfg, get_shape("decode_32k"))
    sh = SH.cache_shardings(mesh, cache)
    assert set(sh) == set(cache)
    for k, t in cache.items():
        assert len(sh[k]) == t.dim()
        assert SH.shard_shape(mesh, t.shape, sh[k]) == tuple(t.shape)


def test_params_shardings_on_a_1x1_mesh():
    mesh = MeshSpec(("data", "model"), (1, 1))
    params = IS.params_specs(get_config("smollm-360m").reduced(),
                             get_shape("train_4k"))
    sh = SH.params_shardings(mesh, params)
    assert _port_flat(sh).keys() == _port_flat(params).keys()


def test_axis_sizes_reads_every_kind_of_mesh():
    fake = FakeMesh(data=4, model=2)
    spec = MeshSpec(("data", "model"), (4, 2))

    class _DeviceMeshLike:          # DeviceMesh's accessors
        mesh_dim_names = ("data", "model")
        shape = (4, 2)

        def size(self, i):
            return self.shape[i]
    for mesh in (fake, spec, _DeviceMeshLike()):
        assert SH.axis_sizes(mesh) == {"data": 4, "model": 2}
        assert SH.model_axes(mesh) == "model"
    assert SH.model_axes(make_production_mesh(moe_experts=8)) \
        == ("expert", "tp")


@pytest.mark.parametrize("experts,multi_pod,want", [
    (0, False, (("data", "model"), (16, 16))),
    (0, True, (("pod", "data", "model"), (2, 16, 16))),
    (8, False, (("data", "expert", "tp"), (16, 8, 2))),
    (16, True, (("pod", "data", "expert", "tp"), (2, 16, 16, 1))),
    (6, False, (("data", "expert", "tp"), (16, 1, 16))),
])
def test_production_mesh_factorisation(experts, multi_pod, want):
    mesh = make_production_mesh(multi_pod=multi_pod, moe_experts=experts)
    assert (mesh.axis_names, mesh.axis_sizes) == want
    assert list(mesh.shape) == list(want[0])
    assert mesh.size == int(np.prod(want[1]))


def test_device_mesh_needs_a_process_group_of_its_size():
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh().device_mesh("cpu")


# ------------------------------------------------------------ 10b: vs JAX
def _norm(spec, ndim):
    out = []
    for ax in tuple(spec):
        if isinstance(ax, tuple) and len(ax) == 1:
            ax = ax[0]
        out.append(ax if ax != () else None)
    return tuple(out) + (None,) * (ndim - len(out))


def _assert_specs_match(port_specs, port_tree, jax_shardings, jax_tree):
    jsh = _jax_flat(jax_shardings)
    jleaves = _jax_flat(jax_tree)
    specs = _port_flat(port_specs)
    n = 0
    for path, t in _port_flat(port_tree).items():
        jpath, i = _unstack(path)
        jl = jleaves[jpath]
        want = _norm(jsh[jpath].spec, len(jl.shape))
        if i is not None:
            want = want[1:]
        assert _norm(specs[path], t.dim()) == want, (path, specs[path], want)
        n += 1
    assert n >= len(jleaves)


def _jax_params(arch):
    return _jax_args(arch, "train_4k")[0]


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_jax(arch, mesh, env, monkeypatch):
    for k in ("REPRO_SHARDING", "REPRO_ZERO"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    pmesh, jmesh = MESHES[mesh]
    params, opt, _ = _port_args(arch, "train_4k")
    jparams, jopt, _ = _jax_args(arch, "train_4k")
    _assert_specs_match(SH.params_shardings(pmesh, params), params,
                        JSH.params_shardings(jmesh, jparams), jparams)
    for m in ("mu", "nu"):
        _assert_specs_match(SH.opt_state_shardings(pmesh, opt[m]), opt[m],
                            JSH.opt_state_shardings(jmesh, jopt[m]), jopt[m])
    for shape, seq_shard in (("decode_32k", False), ("long_500k", True)):
        if not supports_shape(get_config(arch), get_shape(shape))[0]:
            continue
        cache, jcache = _port_args(arch, shape)[2], _jax_args(arch, shape)[2]
        _assert_specs_match(
            SH.cache_shardings(pmesh, cache, seq_shard=seq_shard), cache,
            JSH.cache_shardings(jmesh, jcache, seq_shard=seq_shard), jcache)


def test_zero_splits_a_divisible_layer_list_by_layer(monkeypatch):
    """mistral-7b's 32 layers divide the 16-way data axis: the reference's
    ZeRO-1 shards the stacked layer axis, so the port's per-layer moments
    keep their params spec and the byte count splits the list."""
    monkeypatch.setenv("REPRO_ZERO", "1")
    mesh = make_production_mesh()
    _, opt, _ = _port_args("mistral-7b", "train_4k")
    assert SH.zero_layer_axis(mesh, len(opt["mu"]["layers"]))
    mu = SH.opt_state_shardings(mesh, opt["mu"])
    monkeypatch.delenv("REPRO_ZERO")
    assert mu["layers"] == SH.params_shardings(mesh, opt["mu"])["layers"]
    assert "data" in mu["embed"]["emb"]


def test_to_placements_order_and_refusals():
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:
        mesh_dim_names = ("pod", "data", "model")
    mesh = _Mesh()
    assert SH.to_placements(mesh, (("pod", "data"), None, "model")) == \
        [Shard(0), Shard(0), Shard(2)]
    assert SH.to_placements(mesh, (None, None)) == [Replicate()] * 3
    with pytest.raises(AssertionError):
        SH.to_placements(mesh, (("data", "pod"),))
    with pytest.raises(ValueError):
        SH.to_placements(mesh, ("expert",))


# ------------------------------------------------------------ 10c: bytes
def _jax_shardings_for(mesh, shape, args):
    """``repro.launch.dryrun.shardings_for``'s in_shardings, rebuilt."""
    seq_shard = (shape.kind == "decode"
                 and shape.global_batch % mesh.shape["data"] != 0)
    p_sh = JSH.params_shardings(mesh, args[0])
    if shape.kind == "train":
        o_sh = {"mu": JSH.opt_state_shardings(mesh, args[1]["mu"]),
                "nu": JSH.opt_state_shardings(mesh, args[1]["nu"]),
                "step": NamedSharding(mesh, P())}
        return p_sh, o_sh, JSH.batch_shardings(mesh, args[2])
    c_sh = JSH.cache_shardings(mesh, args[2], seq_shard=seq_shard)
    return p_sh, JSH.batch_shardings(mesh, args[1]), c_sh


def _jax_bytes(mesh, tree, shardings):
    leaves = jax.tree_util.tree_leaves(tree)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    return sum(int(np.prod(sh.shard_shape(l.shape))) * l.dtype.itemsize
               for l, sh in zip(leaves, shs))


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", SUPPORTED)
def test_argument_bytes_equal_jax(arch, shape, mesh, monkeypatch):
    for k in ("REPRO_SHARDING", "REPRO_ZERO", "REPRO_KV_QUANT"):
        monkeypatch.delenv(k, raising=False)
    pmesh, jmesh = MESHES[mesh]
    s = get_shape(shape)
    jargs = _jax_args(arch, shape)
    jsh = _jax_shardings_for(jmesh, s, jargs)
    names = (("params", "opt_state", "batch") if s.kind == "train"
             else ("params", "batch", "cache"))
    want = {"params": 0, "opt_state": 0, "batch": 0, "cache": 0}
    for name, tree, sh in zip(names, jargs, jsh):
        want[name] = _jax_bytes(jmesh, tree, sh)
    want["argument_size_in_bytes"] = sum(want.values())
    got = DR.argument_bytes(pmesh, get_config(arch), s,
                            args=_port_args(arch, shape))
    assert got == want


@pytest.mark.parametrize("arch", ["mistral-7b", "zamba2-1.2b"])
def test_argument_bytes_under_zero_equal_jax(arch, monkeypatch):
    """ZeRO-1 on moments: a layer list that divides the data axis is split
    by layer, as the reference splits its stacked layer axis."""
    monkeypatch.setenv("REPRO_ZERO", "1")
    pmesh, jmesh = MESHES["16x16"]
    s = get_shape("train_4k")
    jargs = _jax_args(arch, "train_4k")
    jsh = _jax_shardings_for(jmesh, s, jargs)
    got = DR.argument_bytes(pmesh, get_config(arch), s)
    assert got["opt_state"] == _jax_bytes(jmesh, jargs[1], jsh[1])
    assert got["params"] == _jax_bytes(jmesh, jargs[0], jsh[0])


def test_shardings_for_seq_shards_long_context_decode():
    mesh = make_production_mesh()
    cfg = IS.adapt_config(get_config("mistral-7b"), get_shape("long_500k"))
    args = _port_args("mistral-7b", "long_500k")
    _, t_sh, c_sh = DR.shardings_for(mesh, cfg, get_shape("long_500k"), args)
    assert t_sh == (None, None)             # batch 1 does not divide 16
    assert c_sh["k"] == (None, None, None, "data", None)
    assert c_sh["pos"] == (None,)


# ------------------------------------------------------------ 10c: the CLI
def test_run_one_writes_ok_and_skip_records(tmp_path, capsys):
    rec = DR.run_one("smollm-360m", "decode_32k", out_dir=str(tmp_path))
    assert rec["status"] == "OK" and rec["mesh"] == "16x16"
    assert rec["per_device_bytes"] == DR.argument_bytes(
        make_production_mesh(), get_config("smollm-360m"),
        get_shape("decode_32k"))
    path = tmp_path / "smollm-360m__decode_32k__16x16.json"
    assert json.loads(path.read_text()) == rec
    skip = DR.run_one("whisper-base", "long_500k", out_dir=str(tmp_path))
    want = supports_shape(get_config("whisper-base"), get_shape("long_500k"))
    assert skip == {"arch": "whisper-base", "shape": "long_500k",
                    "mesh": "16x16", "status": "SKIP", "reason": want[1]}
    out = capsys.readouterr().out
    assert "[dryrun] OK smollm-360m x decode_32k (16x16)" in out
    assert "[dryrun] SKIP whisper-base x long_500k" in out
    # cached unless forced
    path.write_text(json.dumps({"cached": True}))
    assert DR.run_one("smollm-360m", "decode_32k",
                      out_dir=str(tmp_path)) == {"cached": True}
    assert DR.run_one("smollm-360m", "decode_32k", out_dir=str(tmp_path),
                      force=True)["status"] == "OK"


def test_run_one_records_a_failure(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise ValueError("no")
    monkeypatch.setattr(DR, "argument_bytes", boom)
    rec = DR.run_one("smollm-360m", "train_4k", out_dir=str(tmp_path))
    assert rec["status"] == "FAIL" and rec["error"] == "ValueError: no"


def test_main_runs_the_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(DR, "RESULTS_DIR", str(tmp_path))
    DR.main(["--arch", "mamba2-130m", "--shape", "long_500k",
             "--both-meshes"])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["mamba2-130m__long_500k__16x16.json",
                     "mamba2-130m__long_500k__2x16x16.json"]
    for n in names:
        assert json.loads((tmp_path / n).read_text())["status"] == "OK"
    DR.main(["--arch", "whisper-base", "--shape", "train_4k", "--multi-pod",
             "--force"])
    assert (tmp_path / "whisper-base__train_4k__2x16x16.json").exists()
    assert capsys.readouterr().out.count("[dryrun] OK") == 3


@pytest.mark.parametrize("arch,kind", [("smollm-360m", "decode"),
                                       ("zamba2-1.2b", "train"),
                                       ("whisper-base", "prefill"),
                                       ("qwen2-vl-7b", "prefill")])
def test_input_specs_on_the_cpu_hold_the_dry_runs_bytes(arch, kind,
                                                        monkeypatch):
    """The CPU mirror of chip_smoke.py's phase 11a at reduced widths: the
    same functions on a real device give the meta leaves, and their
    storage is ``argument_size_in_bytes`` on a 1x1 mesh."""
    from repro_torch.configs.base import InputShape
    monkeypatch.delenv("REPRO_KV_QUANT", raising=False)
    cfg = get_config(arch).reduced()
    shape = InputShape(f"{kind}_64", 64, 2, kind)
    meta = IS.input_specs(cfg, shape)
    real = IS.input_specs(cfg, shape, device="cpu")
    m = {f"{i}/{p}": t for i, a in enumerate(meta)
         for p, t in _port_flat(a).items()}
    r = {f"{i}/{p}": t for i, a in enumerate(real)
         for p, t in _port_flat(a).items()}
    assert m.keys() == r.keys()
    for k in m:
        assert (m[k].shape, m[k].dtype) == (r[k].shape, r[k].dtype), k
    want = DR.argument_bytes(MeshSpec(("data", "model"), (1, 1)), cfg, shape,
                             args=meta)
    assert sum(t.untyped_storage().nbytes() for t in r.values()) \
        == want["argument_size_in_bytes"] > 0
    again = IS.input_specs(cfg, shape, device="cpu")[0]
    assert all(torch.equal(a, b) for a, b in zip(
        _port_flat(real[0]).values(), _port_flat(again).values()))

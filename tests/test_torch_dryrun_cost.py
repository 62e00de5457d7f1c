"""The dry run's step analysis (``repro_torch.launch.dryrun.analyze`` and
``launch.step_cost``) against the JAX package's step and on fake meshes.

* (a) FLOPs: on every family's reduced config, for each supported shape
  kind, the port's ``flops`` on one device equal the FLOPs of every
  ``dot_general`` and ``conv_general_dilated`` in ``jax.make_jaxpr`` of the
  reference's own step (built as ``repro/launch/dryrun.py``'s ``make_step``
  builds it), or differ by a pinned formula whose cause is named;
* (b) per-device invariants on fake process groups: a 1x1 mesh gives the
  plain-meta numbers, pure data parallelism divides FLOPs exactly, no
  device does less than its share, no collective where none is needed;
* (c) against the reference's compiled HLO, in a subprocess with 4
  forced host devices: collectives zero exactly where JAX's are zero, and
  the port's bytes per op pinned (they are DTensor's plan, op by op, not
  GSPMD's whole-program plan, so a change in DTensor's choices shows here);
  per-device FLOPs divided over a mesh wherever GSPMD divides them;
* (d) peak and temporary bytes of toy functions with a known answer;
* (e) the CLI's OK and FAIL records.

``repro.launch.dryrun`` sets XLA_FLAGS when imported, so only (c)'s
subprocess imports it.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch
from jax.extend import core as jcore

from repro.configs import get_config as jax_config
from repro.launch import input_specs as JIS
from repro.models import model as JM
from repro.training import optimizer as JOPT
from repro.training import train as JTR
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun as DR
from repro_torch.launch import step_cost as SC
from repro_torch.launch.mesh import MeshSpec

B, S = 2, 64          # S = 2 chunks of the reduced SSM configs' 32
FAMILIES = {"dense": "smollm-360m", "moe": "phi3.5-moe-42b-a6.6b",
            "vlm": "qwen2-vl-7b", "ssm": "mamba2-130m",
            "hybrid": "zamba2-1.2b", "audio": "whisper-base"}
KINDS = ("train", "prefill", "decode")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shape(kind, b=B, s=S):
    return InputShape(f"{kind}_{s}", s, b, kind)


# ------------------------------------------------------------ (a) FLOPs
def _jaxpr_flops(jaxpr, mult=1) -> int:
    """FLOPs of every dot_general (2 x output x contracted) and
    conv_general_dilated (2 x output x kernel in-features x window) in a
    jaxpr and the jaxprs nested in it, a scan body times its length."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        out = math.prod(eqn.outvars[0].aval.shape) if eqn.outvars else 0
        if name == "dot_general":
            (lhs_c, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += mult * 2 * out * math.prod(lhs[i] for i in lhs_c)
        elif name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            spec = eqn.params["dimension_numbers"].rhs_spec
            total += mult * 2 * out * rhs[spec[1]] * math.prod(
                rhs[d] for d in spec[2:])
        inner = mult * (eqn.params["length"] if name == "scan" else 1)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else [v]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    sub = sub.jaxpr
                if isinstance(sub, jcore.Jaxpr):
                    if name == "while" and _jaxpr_flops(sub):
                        raise ValueError("a while loop with products")
                    total += _jaxpr_flops(sub, inner)
    return total


def _jax_flops(arch, kind) -> int:
    """The reference's step, as its dry run's ``make_step`` builds it."""
    shape = _shape(kind)
    cfg = JIS.adapt_config(jax_config(arch).reduced(), shape)
    if kind == "train":
        step = JTR.make_train_step(cfg, JOPT.AdamWConfig(), backend="ref",
                                   remat=True)
    elif kind == "prefill":
        def step(p, b, c):
            return JM.prefill(p, cfg, b, c, backend="ref")
    else:
        def step(p, t, c):
            return JM.decode_step(p, cfg, t, c, backend="ref")
    return _jaxpr_flops(jax.make_jaxpr(step)(*JIS.input_specs(cfg, shape))
                        .jaxpr)


def _port_flops(arch, kind) -> int:
    return DR.analyze(get_config(arch).reduced(), _shape(kind))["flops"]


def _pinned(arch, kind) -> int:
    """port - JAX, and why.

    SSM layers (mamba2's, zamba2's Mamba layers), training: torch's
    ``conv_backward_flop`` counts a depthwise conv's weight gradient as if
    ungrouped (C times its products), and JAX's input-gradient conv runs
    over the padded length S + W - 1 where torch's formula counts S:
    2·B·C·W·(S·(C − 1) − (W − 1)) a layer, C = d_inner + 2N conv channels.

    SSM layers, decode: the state update ``einsum("bhp,bn->bhpn")``
    contracts nothing; torch runs it as a broadcast multiply (no matmul,
    no FLOPs counted), JAX as a dot_general: −2·B·H·P·N a layer.

    Every other family and kind: 0."""
    cfg = get_config(arch).reduced()
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    L, ssm = cfg.num_layers, cfg.ssm
    if kind == "train":
        C, W = cfg.d_inner + 2 * ssm.state_dim, ssm.conv_width
        return L * 2 * B * C * W * (S * (C - 1) - (W - 1))
    if kind == "decode":
        return -L * 2 * B * cfg.ssm_heads * ssm.head_dim * ssm.state_dim
    return 0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_flops_equal_the_references_products(family, kind):
    arch = FAMILIES[family]
    port, ref = _port_flops(arch, kind), _jax_flops(arch, kind)
    assert ref > 0
    assert port - ref == _pinned(arch, kind), (port, ref)


def test_the_depthwise_conv_backward_formula_is_torchs():
    """The first pinned term is FlopCounterMode's own: its count of one
    depthwise conv backward, and the products it really does."""
    from torch.utils.flop_counter import FlopCounterMode
    Bc, C, Sc, W = 2, 6, 5, 4
    x = torch.randn(Bc, C, Sc + W - 1, requires_grad=True)
    w = torch.randn(C, 1, W, requires_grad=True)
    out = torch.nn.functional.conv1d(x, w, groups=C)
    with FlopCounterMode(display=False) as fc:
        out.sum().backward()
    assert fc.get_total_flops() == 2 * Bc * C * Sc * W * (1 + C)


# ------------------------------------------------------------ (b) meshes
MESHES = [(1, 1), (4, 1), (1, 4), (2, 2)]
NUMBERS = ("flops", "bytes_accessed", "held_argument_bytes",
           "output_size_in_bytes", "peak_bytes", "temp_size_in_bytes",
           "argument_size_in_bytes", "collectives", "reshards")


def _mesh(data, model):
    return MeshSpec(("data", "model"), (data, model))


def _coll_bytes(rec):
    return sum(rec["collectives"][op] for op in SC.COLLECTIVE_OPS)


# a dense, an SSM and the MoE family (its serving steps: its train step
# takes the longest on DTensors and holds the same rules)
MESH_CASES = [(a, k) for a in ("smollm-360m", "mamba2-130m") for k in KINDS] \
    + [("phi3.5-moe-42b-a6.6b", k) for k in ("prefill", "decode")]


@pytest.mark.parametrize("arch,kind", MESH_CASES)
def test_per_device_numbers_on_fake_meshes(arch, kind):
    cfg, shape = get_config(arch).reduced(), _shape(kind, b=4, s=32)
    plain = DR.analyze(cfg, shape)
    recs = {m: DR.analyze(cfg, shape, _mesh(*m)) for m in MESHES}
    one = recs[(1, 1)]
    assert {k: one[k] for k in NUMBERS if k != "reshards"} == \
        {k: plain[k] for k in NUMBERS if k != "reshards"}
    assert _coll_bytes(one) == 0 and not any(
        one["collectives"]["counts"].values())
    for (data, model), rec in recs.items():
        n = data * model
        assert rec["flops"] * n >= plain["flops"], (data, model)
        assert 0 < rec["held_argument_bytes"] <= plain["held_argument_bytes"]
        assert rec["temp_size_in_bytes"] >= 0
        assert rec["peak_bytes"] >= rec["held_argument_bytes"]
    dp = recs[(4, 1)]
    if get_config(arch).family == "moe":
        # the dispatch writes into a buffer the step makes (implicitly
        # replicated), so every device routes every token; GSPMD keeps the
        # dispatch on every device too: 0.92 (prefill) and 0.95 (decode)
        # of the 1x1 HLO FLOPs on 4x1 (test_per_device_flops_divide_...)
        assert dp["flops"] >= 0.75 * plain["flops"]
    else:
        assert dp["flops"] * 4 == plain["flops"]
    if kind == "prefill" and get_config(arch).family != "moe":
        assert _coll_bytes(dp) == 0


def test_a_mesh_refuses_a_torch_it_is_not_held_on(monkeypatch):
    """Under torch 2.11 a 1x1 mesh is not plain meta (ROADMAP, Queue 3):
    ``analyze`` refuses a mesh there, naming the version, and still runs
    one device on plain meta tensors."""
    cfg, shape = get_config("smollm-360m").reduced(), _shape("decode")
    want = DR.analyze(cfg, shape)
    monkeypatch.setattr(torch, "__version__", "2.11.0+cu128")
    with pytest.raises(RuntimeError, match=r"not on 2\.11\.0\+cu128"):
        DR.analyze(cfg, shape, _mesh(1, 1))
    got = DR.analyze(cfg, shape)
    assert {k: got[k] for k in NUMBERS} == {k: want[k] for k in NUMBERS}
    DR.check_mesh_torch("2.13.0")
    DR.check_mesh_torch("3.0.1")
    with pytest.raises(RuntimeError, match="2.12.1"):
        DR.check_mesh_torch("2.12.1")


def test_collectives_are_named_as_xla_names_them():
    """A toy column- then row-parallel product on a (1, 4) mesh: its
    collectives counted by StepCost are those CommDebugMode sees, under
    XLA's names, each result's bytes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    mesh = _mesh(1, 4)
    with DR.fake_mesh(mesh) as dm:
        def dt(local, full, shard):
            pl = [Replicate(), Replicate() if shard is None else Shard(shard)]
            return DTensor.from_local(torch.empty(local, device="meta"), dm,
                                      pl, shape=torch.Size(full),
                                      stride=torch.empty(full, device="meta")
                                      .stride(), run_check=False)
        x = dt((8, 16), (8, 16), None)
        w1 = dt((16, 8), (16, 32), 1)          # column parallel
        w2 = dt((8, 16), (32, 16), 0)          # row parallel
        cost = SC.StepCost()
        with CommDebugMode() as comm, cost:
            y = (x @ w1) @ w2
        assert tuple(y.to_local().shape) == (8, 16)
        # the row-parallel product's partial sums are reduced at once
        assert cost.counts == {"all-reduce": 1, "all-gather": 0,
                               "reduce-scatter": 0, "all-to-all": 0,
                               "collective-permute": 0}
        assert comm.get_total_counts() == 1
        assert cost.collectives["all-reduce"] == 8 * 16 * 4
        # x @ w1: 2 * 8 * 16 * 8 on each device; @ w2: 2 * 8 * 8 * 16
        assert cost.flops == 2 * 8 * 16 * 8 * 2


_JAX_COLLECTIVES = textwrap.dedent('''
    import json, sys
    import jax
    jax.devices()               # 4 host devices, before the import below
    import numpy as np
    from repro.configs import get_config
    from repro.configs.base import InputShape
    from repro.launch import dryrun as JD
    out = {}
    for kind in ("prefill", "train"):
        for data, model in ((2, 2), (1, 4), (4, 1)):
            mesh = jax.sharding.Mesh(
                np.array(jax.devices()[:4]).reshape(data, model),
                ("data", "model"))
            shape = InputShape(f"{kind}_32", 32, 4, kind)
            compiled, _ = JD.lower_and_compile(
                get_config("smollm-360m").reduced(), shape, mesh)
            coll = JD.analyze(compiled)["collectives"]
            out[f"{kind} {data}x{model}"] = coll
    json.dump(out, sys.stdout)
''')


# the port's collective bytes by op for reduced smollm-360m, B 4, S 32
# (all-reduce, all-gather, reduce-scatter, all-to-all, collective-permute)
PORT_COLLECTIVES = {
    "prefill 2x2": (163840, 65536, 0, 8192, 0),
    "prefill 1x4": (327680, 131072, 0, 8192, 0),
    "prefill 4x1": (0, 0, 0, 0, 0),
    "train 2x2": (2102324, 324096, 0, 524288, 0),
    "train 1x4": (1310760, 581632, 0, 0, 0),
    "train 4x1": (2495500, 512, 0, 16384, 0),
}


def _jax_subprocess(code, *args, timeout=120):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout)


def test_collectives_are_zero_exactly_where_the_references_are():
    """Zero exactly where JAX's are zero; the bytes of every op pinned,
    with the gap to JAX's printed (``-s``)."""
    ref = _jax_subprocess(_JAX_COLLECTIVES)
    assert set(ref) == set(PORT_COLLECTIVES)
    cfg = get_config("smollm-360m").reduced()
    for key, jax_coll in ref.items():
        kind, m = key.split()
        data, model = (int(v) for v in m.split("x"))
        port = DR.analyze(cfg, _shape(kind, b=4, s=32), _mesh(data, model))
        jax_total = sum(jax_coll[op] for op in SC.COLLECTIVE_OPS)
        gap = {op: port["collectives"][op] - jax_coll[op]
               for op in SC.COLLECTIVE_OPS}
        print(f"{key}: JAX {jax_coll}; port {port['collectives']}; "
              f"port - JAX {gap}")
        assert (_coll_bytes(port) == 0) == (jax_total == 0), key
        assert tuple(port["collectives"][op] for op in SC.COLLECTIVE_OPS) \
            == PORT_COLLECTIVES[key], key


_JAX_FLOPS = textwrap.dedent('''
    import json, sys
    import jax
    jax.devices()               # 4 host devices, before the import below
    import numpy as np
    from repro.configs import get_config
    from repro.configs.base import InputShape
    from repro.launch import dryrun as JD
    out = {}
    for arch, kind in json.loads(sys.argv[1]):
        for data, model in ((1, 1), (4, 1), (1, 4)):
            mesh = jax.sharding.Mesh(
                np.array(jax.devices()[:data * model]).reshape(data, model),
                ("data", "model"))
            shape = InputShape(f"{kind}_32", 32, 4, kind)
            out[f"{arch} {kind} {data}x{model}"] = JD.component_analysis(
                get_config(arch).reduced(), shape, mesh)["hlo_flops"]
    json.dump(out, sys.stdout)
''')
# the MoE dispatch (phi3.5-moe on 4x1) and the view the model axis does not
# divide evenly (smollm-360m's 4 heads on 1 KV head, on 1x4)
RATIO_CASES = [("phi3.5-moe-42b-a6.6b", "prefill"),
               ("phi3.5-moe-42b-a6.6b", "decode"),
               ("smollm-360m", "prefill"), ("smollm-360m", "train")]


def test_per_device_flops_divide_where_the_references_do():
    """Each mesh's per-device FLOPs over the 1x1 mesh's: the reference's
    ``component_analysis`` ``hlo_flops`` (XLA's count, elementwise ops
    included) against the port's ``flops`` (products only). Where GSPMD
    divides the work by the 4 devices (a ratio within 0.05 of 1/4), the
    port does too; where GSPMD keeps most of it on every device (the MoE
    dispatch on 4x1: 0.92 and 0.95), so does the port (over 0.75)."""
    ref = _jax_subprocess(_JAX_FLOPS, json.dumps(RATIO_CASES), timeout=300)
    for arch, kind in RATIO_CASES:
        cfg, shape = get_config(arch).reduced(), _shape(kind, b=4, s=32)
        one = DR.analyze(cfg, shape, _mesh(1, 1))["flops"]
        for m in ((4, 1), (1, 4)):
            want = ref[f"{arch} {kind} {m[0]}x{m[1]}"] \
                / ref[f"{arch} {kind} 1x1"]
            got = DR.analyze(cfg, shape, _mesh(*m))["flops"] / one
            print(f"{arch} {kind} {m}: JAX {want:.4f}, port {got:.4f}")
            assert abs(want - 0.25) <= 0.05 or want >= 0.75, (arch, kind, m)
            if want >= 0.75:
                assert got >= 0.75, (arch, kind, m)
            else:
                assert abs(got - 0.25) <= 0.05, (arch, kind, m)


# ------------------------------------------------------------ (d) bytes
F32 = 4


def _count(fn, *args):
    return DR.count_step(fn, args)


def test_a_chain_of_matmuls():
    x = torch.empty(4, 8, device="meta")
    w1, w2 = torch.empty(8, 16, device="meta"), torch.empty(16, 2,
                                                            device="meta")
    got = _count(lambda x, a, b: (x @ a) @ b, x, w1, w2)
    held = (4 * 8 + 8 * 16 + 16 * 2) * F32
    assert got["held_argument_bytes"] == held
    # x @ a (4 x 16) is alive while (x @ a) @ b (4 x 2) is made
    assert got["temp_size_in_bytes"] == (4 * 16 + 4 * 2) * F32
    assert got["peak_bytes"] == held + (4 * 16 + 4 * 2) * F32
    assert got["output_size_in_bytes"] == 4 * 2 * F32
    assert got["flops"] == 2 * 4 * 8 * 16 + 2 * 4 * 16 * 2
    assert got["bytes_accessed"] == (4 * 8 + 8 * 16 + 4 * 16) * F32 \
        + (4 * 16 + 16 * 2 + 4 * 2) * F32


def test_views_and_in_place_ops_are_free():
    x = torch.empty(64, 64, device="meta")
    views = _count(lambda x: x.view(-1)[:100], x)
    assert views["temp_size_in_bytes"] == 0
    assert views["bytes_accessed"] == 0
    in_place = _count(lambda x: x.add_(1.0).mul_(2.0), x)
    assert in_place["temp_size_in_bytes"] == 0
    assert in_place["bytes_accessed"] == 2 * 2 * 64 * 64 * F32


def test_a_dead_tensor_is_freed():
    n = 64 * 64 * F32

    def step(x):
        a = x * 2.0
        b = a * 2.0
        del a                  # freed before c is made
        return b * 2.0
    got = _count(step, torch.empty(64, 64, device="meta"))
    assert got["temp_size_in_bytes"] == 2 * n
    out = _count(lambda x: (x * 2.0) * 2.0, torch.empty(64, 64, device="meta"))
    assert out["temp_size_in_bytes"] == 2 * n
    assert out["output_size_in_bytes"] == n


def test_an_expanded_operand_is_read_once():
    w = torch.empty(8, 16, device="meta")
    x = torch.empty(4, 5, 8, device="meta")
    got = _count(lambda x, w: torch.bmm(x, w.expand(4, 8, 16)), x, w)
    assert got["bytes_accessed"] == (4 * 5 * 8 + 8 * 16 + 4 * 5 * 16) * F32
    assert got["flops"] == 2 * 4 * 5 * 8 * 16


# ------------------------------------------------------------ (e) the CLI
@pytest.fixture
def small(monkeypatch):
    """run_one on reduced configs, short shapes and a 2x2 mesh."""
    monkeypatch.setattr(DR, "get_config", lambda a: get_config(a).reduced())
    monkeypatch.setattr(DR, "get_shape", lambda s: dataclasses.replace(
        DR.INPUT_SHAPES[s], seq_len=32, global_batch=4))
    monkeypatch.setattr(DR, "make_production_mesh",
                        lambda multi_pod=False: _mesh(2, 2))


def test_run_one_writes_the_step_analysis(tmp_path, small, capsys):
    rec = DR.run_one("smollm-360m", "train_4k", out_dir=str(tmp_path))
    assert rec["status"] == "OK" and rec["mesh"] == "2x2"
    full = rec["full"]
    assert full["flops"] > 0 and full["temp_size_in_bytes"] > 0
    assert full["argument_size_in_bytes"] == \
        rec["per_device_bytes"]["argument_size_in_bytes"]
    assert set(full["collectives"]) == set(SC.COLLECTIVE_OPS) | {"counts"}
    path = tmp_path / "smollm-360m__train_4k__2x2.json"
    assert json.loads(path.read_text()) == rec
    line = capsys.readouterr().out
    assert "[dryrun] OK smollm-360m x train_4k (2x2)" in line
    assert "flops/dev=" in line and "temp/dev=" in line and "coll={" in line


def test_run_one_records_what_the_step_refuses(tmp_path, small, capsys,
                                              monkeypatch):
    """A step with a data-dependent shape cannot run on meta tensors: the
    record is FAIL with the op and the message."""
    def make_step(cfg, shape):
        def step(params, batch, cache):
            return torch.nonzero(batch["tokens"])
        return step
    monkeypatch.setattr(DR, "make_step", make_step)
    rec = DR.run_one("smollm-360m", "prefill_32k", out_dir=str(tmp_path))
    assert rec["status"] == "FAIL" and "full" not in rec
    assert rec["op"] == "aten.nonzero.default"
    assert "nonzero" in rec["error"]
    assert "[dryrun] FAIL smollm-360m x prefill_32k (2x2) at " \
        "aten.nonzero.default" in capsys.readouterr().out
    saved = json.loads((tmp_path / "smollm-360m__prefill_32k__2x2.json")
                       .read_text())
    assert saved == rec

"""Production mesh descriptions (counterpart of ``repro/launch/mesh.py``).

``make_production_mesh`` returns a ``MeshSpec``: axis names and sizes and
nothing else, so describing a 512-device mesh touches no device and needs
no process group. ``MeshSpec.device_mesh`` and ``make_debug_mesh`` build a
``torch.distributed`` ``DeviceMesh`` on the current process group, whose
world size must be the mesh's size.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MeshSpec:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> "OrderedDict[str, int]":
        """Axis name -> size, in mesh order (as a JAX mesh's ``shape``)."""
        return OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def tag(self) -> str:
        return "x".join(str(n) for n in self.axis_sizes)

    def device_mesh(self, device_type: str = "cuda"):
        """This mesh as a ``DeviceMesh`` over the current process group;
        raises unless one of exactly ``size`` ranks exists."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized():
            raise RuntimeError(f"mesh {self.tag()} needs a process group of "
                               f"{self.size} ranks; none is initialized")
        if dist.get_world_size() != self.size:
            raise RuntimeError(f"mesh {self.tag()} needs {self.size} ranks; "
                               f"the process group has "
                               f"{dist.get_world_size()}")
        return init_device_mesh(device_type, self.axis_sizes,
                                mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         moe_experts: int = 0) -> MeshSpec:
    """16x16 = 256 devices per pod; 2 pods = 512 devices multi-pod.

    moe_experts > 0 factorizes the 16-way model axis into
    (expert = num_experts, tp = 16 // num_experts) so expert weights shard on
    their own axis (expert parallelism) and d_ff shards on the remainder —
    for MoE whose expert count doesn't divide 16 (grok: 8x2).
    """
    if moe_experts:
        e = min(moe_experts, 16)
        while 16 % e:
            e //= 2
        tp = 16 // e
        if multi_pod:
            return MeshSpec(("pod", "data", "expert", "tp"), (2, 16, e, tp))
        return MeshSpec(("data", "expert", "tp"), (16, e, tp))
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_debug_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A small ("data", "model") ``DeviceMesh`` on the current process
    group (of ``data * model`` ranks); the CPU tests pass ``"cpu"``."""
    return MeshSpec(("data", "model"), (data, model)).device_mesh(device_type)

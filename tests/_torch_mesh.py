"""DTensor round trips of a params tree, shared by the port's process-group
tests (tests/test_torch_mesh_dist.py on the CPU, tests/test_torch_gpu.py on
the card). Imports no JAX."""
import json
import os

import torch
import torch.distributed as dist

from repro_torch.sharding import specs as SH


def round_trip(mesh, params):
    """Distribute every leaf of ``params`` on ``mesh`` with the placements
    of its ``params_shardings`` spec, then gather it back. Returns this
    rank's local shape per leaf path, and whether every leaf came back bit
    for bit. ``full_tensor`` is a collective: every rank runs every leaf,
    in the same order."""
    from torch.distributed.tensor import distribute_tensor
    specs = {}
    SH.map_with_path(specs.__setitem__, SH.params_shardings(mesh, params))
    local, same = {}, True

    def one(path, t):
        nonlocal same
        d = distribute_tensor(t, mesh, SH.to_placements(mesh, specs[path]))
        local[path] = list(d.to_local().shape)
        same = torch.equal(d.full_tensor(), t) and same
    SH.map_with_path(one, params)
    return local, same


def gloo_worker(rank, world, init_file, out_dir, data, model):
    """One rank of a CPU gloo group: reduced smollm-360m's bf16 params from
    seed 0 through ``round_trip`` on a (data, model) mesh; writes
    ``rank<r>.json``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh(data, model, device_type="cpu")
        cfg = get_config("smollm-360m").reduced()
        params = M.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.bfloat16, "cpu")
        local, same = round_trip(mesh, params)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"local": local, "same": same,
                       "coordinate": mesh.get_coordinate()}, f)
    finally:
        dist.destroy_process_group()

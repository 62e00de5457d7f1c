"""K7: the routed experts of a dropless MoE layer grouped by expert — the
Hopper kernel's wrapper, its plain version, and the routing tables both
read.

Replaces no Pallas kernel: the JAX package computes its MoE FFN as one
product over an (experts, capacity) buffer, and so does the port's
capacity path (``models/moe.py``); served dropless, that buffer holds a
slot of every expert for every token. The CUDA source is
``csrc/moe_experts.cu``; its header note says what bounds it.

``route_table`` sorts the (token, choice) rows by expert on the device
(rows of dead lanes go to no expert) and gives each expert's first row;
nothing is read on the host, so a decode step that routes stays one
captured CUDA graph. ``moe_experts`` then computes, for the routed rows
only, ``gate · down_e(relu(up_e x)²)`` into the row's slot t·k + j; the
caller sums a token's k slots in a fixed order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

TILE = 64            # rows and columns of a kernel tile; d and f its multiples


class Routes(NamedTuple):
    """The routed rows of T tokens x k choices, sorted by expert."""
    token: torch.Tensor     # (R,) int32: the token of sorted row r
    slot: torch.Tensor      # (R,) int32: its place t·k + j
    offsets: torch.Tensor   # (E + 1,) int32: each expert's first sorted row;
    #                         offsets[E] = the routed rows
    gate: torch.Tensor      # (R,) float32 by slot: the row's weight


def route_table(expert_idx: torch.Tensor, gate: torch.Tensor, E: int,
                live: Optional[torch.Tensor] = None) -> Routes:
    """expert_idx (T, k) ids, gate (T, k) weights; ``live`` (T,) bool: a
    token that is not live routes to no expert (its rows sort past every
    expert's and are never computed)."""
    T, k = expert_idx.shape
    flat = expert_idx.reshape(-1).long()
    if live is not None:
        flat = torch.where(live.repeat_interleave(k), flat, E)
    order = torch.argsort(flat, stable=True)
    sorted_e = flat.index_select(0, order)
    offsets = torch.searchsorted(
        sorted_e, torch.arange(E + 1, device=flat.device, dtype=flat.dtype))
    return Routes(token=(order // k).to(torch.int32),
                  slot=order.to(torch.int32),
                  offsets=offsets.to(torch.int32),
                  gate=gate.reshape(-1).float().contiguous())


def experts_touched(r: Routes) -> torch.Tensor:
    """How many experts have at least one routed row (0-d int, device)."""
    return (r.offsets[1:] > r.offsets[:-1]).sum()


def moe_experts_ref(x: torch.Tensor, w_up: torch.Tensor,
                    w_down: torch.Tensor, r: Routes) -> torch.Tensor:
    """The plain version of K7, expert by expert (reads the offsets on the
    host): (T·k, d) float32, row t·k + j the weighted output of token t's
    j-th expert, zeros for rows that routed nowhere."""
    R, d = r.slot.shape[0], x.shape[1]
    out = torch.zeros((R, d), dtype=torch.float32, device=x.device)
    off = r.offsets.tolist()
    for e in range(w_up.shape[0]):
        a, b = off[e], off[e + 1]
        if a == b:
            continue
        rows = x.index_select(0, r.token[a:b].long())
        h = torch.relu(rows @ w_up[e].T).square()
        slots = r.slot[a:b].long()
        y = (h @ w_down[e].T).float() * r.gate.index_select(0, slots)[:, None]
        out.index_copy_(0, slots, y)
    return out


def _check(x, w_up, w_down, r: Routes) -> None:
    name = "moe_experts"
    if x.dtype != torch.bfloat16 or w_up.dtype != x.dtype \
            or w_down.dtype != x.dtype:
        raise ValueError(f"{name}: the kernel takes bfloat16 x and weights, "
                         f"got {x.dtype}, {w_up.dtype}, {w_down.dtype}")
    E, f, d = w_up.shape
    if x.dim() != 2 or x.shape[1] != d or w_down.shape != (E, d, f):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w_up "
                         f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)}")
    if d % TILE or f % TILE:
        raise ValueError(f"{name}: d {d} and f {f} must be multiples of "
                         f"{TILE}")
    for t in (x, w_up, w_down, *r):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on "
                             f"{x.device}")
    for t in (r.token, r.slot, r.offsets):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: routing tables must be int32")
    if r.offsets.shape != (E + 1,) or r.gate.shape != r.slot.shape:
        raise ValueError(f"{name}: offsets {tuple(r.offsets.shape)} for {E} "
                         f"experts, gate {tuple(r.gate.shape)}")


def grid_tiles(R: int, E: int) -> int:
    """The grid's bound on (expert, 64-row) tiles: sum_e ceil(n_e / 64) <=
    R / 64 + (experts with a row) and <= R."""
    return min(R, R // TILE + E)


def moe_experts(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                r: Routes, *, passes: int = 3) -> torch.Tensor:
    """K7. x (T, d); w_up (E, f, d) and w_down (E, d, f), each expert's rows
    its output channels; ``r`` from ``route_table``. Returns (T·k, d)
    float32 as ``moe_experts_ref``. CUDA tensors launch the kernel (two
    device kernels, one count) or raise; CPU tensors take the plain
    version. ``passes`` (1 up, 2 down) times one product alone."""
    if x.device.type == "cpu":
        return moe_experts_ref(x, w_up, w_down, r)
    _check(x, w_up, w_down, r)
    E, f, d = w_up.shape
    R = r.slot.shape[0]
    y = torch.zeros((R, d), dtype=torch.float32, device=x.device)
    if R == 0:
        return y
    h = torch.empty((R, f), dtype=torch.bfloat16, device=x.device)
    n = r.offsets[1:] - r.offsets[:-1]
    tile_start = torch.zeros((E + 1,), dtype=torch.int32, device=x.device)
    tile_start[1:] = torch.cumsum((n + TILE - 1) // TILE, 0)
    code = _build.library().repro_moe_experts(
        x.data_ptr(), w_up.data_ptr(), w_down.data_ptr(), r.token.data_ptr(),
        r.slot.data_ptr(), r.gate.data_ptr(), r.offsets.data_ptr(),
        tile_start.data_ptr(), h.data_ptr(), y.data_ptr(), E, d, f,
        grid_tiles(R, E), passes,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "moe_experts")
    if passes == 3:
        moe_experts.launches += 1
    return y


moe_experts.launches = 0

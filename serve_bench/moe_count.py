"""K7's work a call (``repro_torch``'s grouped expert kernel, one MoE layer
of one step): FLOPs 4·rows·d·f (the up and the down product of each
routed row), bytes each touched expert's up and down weights once (2·d·f
bf16 values) plus the rows in (bf16) and out (float32). The h rows K7
keeps between its two products are not counted: a kernel need not write
them."""
from __future__ import annotations

from serve_bench import flops as F


def flops(rows: float, d: int, f: int) -> float:
    return 4.0 * rows * d * f


def nbytes(touched: float, rows: float, d: int, f: int) -> float:
    return touched * 2 * d * f * 2 + rows * d * (2 + 4)


def bound_s(touched: float, rows: float, d: int, f: int) -> float:
    """The least time one call could take on the card."""
    return F.bound_s(flops(rows, d, f), nbytes(touched, rows, d, f))


def expected_touched(E: int, k: int, lanes: int) -> float:
    """Distinct experts one layer reads when ``lanes`` tokens each pick k
    of E uniformly: E·(1 - (1 - k/E)^lanes)."""
    return E * (1.0 - (1.0 - k / E) ** lanes)

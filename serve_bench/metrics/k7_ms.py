"""k7_ms: K7's (the grouped expert kernel's) device ms per decode-only
tick, over the ticks of the profiled slice that hold its kernels in full
(``_k7.py``): the experts' share of a decode step, all MoE layers."""
from serve_bench.metrics._k7 import decode_ticks


def read(t):
    got = decode_ticks(t)
    if not got:
        return None
    return sum(dev for _, dev, _ in got) / len(got) * 1e-3

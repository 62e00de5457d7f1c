"""k7_roofline: K7 (the grouped expert kernel) against its roofline over
the decode-only ticks of the profiled slice that hold its kernels in full
(``_k7.py``). A call's bound is max(FLOPs / 989e12, bytes / 3.35e12)
(``moe_count.py``: FLOPs 4·rows·d·f; bytes each touched expert's weights
once plus the rows in and out), from the tick's routed rows and experts
touched (the program's tick log), split evenly over its MoE layers. The
share is the bounds' sum over the K7 kernels' device time."""
from serve_bench import moe_count as MC
from serve_bench.metrics._k7 import decode_ticks


def read(t):
    got = decode_ticks(t)
    if not got:
        return None
    m = t.model
    n_e = m["block_pattern"].count("E")
    d, f = m["d_model"], m["d_ff"]
    want = sum(n_e * MC.bound_s(r.experts_touched / n_e,
                                r.routed_rows / n_e, d, f)
               for r, _, _ in got)
    return want / (sum(dev for _, dev, _ in got) * 1e-6) * 100.0

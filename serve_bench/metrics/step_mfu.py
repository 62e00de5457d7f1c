"""step_mfu: the whole model step's share of the card's bf16 peak over
the profiled slice: the model FLOPs of every prefill and decode call that
ran in it (valid tokens only, ``flops.py``) over slice seconds times
989e12."""
import sys

from serve_bench import flops as F


def read(t):
    m = t.model
    total = 0
    for kind, _, a, b, meta in t.calls:
        if not t.in_slice(a, b):
            continue
        if kind in ("prefill_chunk", "prefill"):
            start, n, last = meta
            total += F.prefill_flops(m, start, n, last)
        else:
            total += sum(F.decode_flops(m, kv) for kv in meta)
    if not total:
        return None
    print(f"step_mfu: {total} model FLOPs in {t.slice_s:.6f} s; card power "
          f"limit {t.power_limit_w} W", file=sys.stderr)
    return total / (t.slice_s * F.PEAK_BF16_FLOPS) * 100.0

"""chunk_attn_ms: the paged chunk attention's (K6's) device ms per prefill
chunk, over the ticks whose K6 kernels the profiled slice holds in full:
one kernel a layer for each ``prefill_chunk`` call of the tick
(``_steps.py``). The harness's launch counts do not name K6, so its
kernels in the profile are what is checked against layers x chunks. None
where no K6 kernel runs (a program that attends on the plain path)."""
import re

from serve_bench.metrics._steps import ticks

KERNEL = re.compile(r"paged_chunk_(wgmma|f32)")


def _k6(name):
    return 2 if KERNEL.search(name) else 0


def read(t):
    got = ticks(t, "prefill_chunk", _k6, t.model["num_layers"],
                lambda kind, meta: meta)
    if not got:
        return None
    chunks = sum(len(ms) for ms, _ in got)
    return sum(d for _, d in got) / chunks * 1e-3

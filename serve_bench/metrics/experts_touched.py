"""experts_touched: the mean number of distinct experts one MoE layer
reads in a decode tick, over the program's tick records in the window,
clear of the profiled slice, that decoded (``trace.Tick.experts_touched``
summed over the step's MoE layers, over their number). Beside it, on
standard error, what uniform routing of the tick's live lanes would touch,
E·(1 - (1 - k/E)^lanes): a dead lane that routed would lift the reading
above it. None where the program counts no routed experts."""
import sys

from serve_bench import moe_count as MC
from serve_bench.metrics._program import ticks


def read(t):
    m = t.model
    n_e = m.get("block_pattern", "").count("E")
    got = [k for k in ticks(t) or ()
           if k.decode_lanes and getattr(k, "experts_touched", 0)]
    if not n_e or not got:
        return None
    mo = m["moe"]
    E, k = mo["num_experts"], mo["num_experts_per_tok"]
    mean = sum(x.experts_touched for x in got) / len(got) / n_e
    exp = sum(MC.expected_touched(E, k, x.decode_lanes)
              for x in got) / len(got)
    bad = sum(1 for x in got if x.routed_rows != n_e * k * x.decode_lanes)
    print(f"experts_touched: {mean:.3f} a layer over {len(got)} decode ticks"
          f"; uniform routing of their live lanes {exp:.3f}; routed rows != "
          f"{n_e} x {k} x lanes in {bad}", file=sys.stderr)
    return mean

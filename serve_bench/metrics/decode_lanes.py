"""decode_lanes: the mean number of lanes in a tick's decode step, over
the program's tick records in the window, clear of the profiled slice,
that decoded (the batch each weight read of the decode is shared by)."""
from serve_bench.metrics._program import ticks


def read(t):
    d = [k.decode_lanes for k in ticks(t) or () if k.decode_lanes]
    return sum(d) / len(d) if d else None

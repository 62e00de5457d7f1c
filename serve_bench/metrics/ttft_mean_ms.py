"""ttft_mean_ms: the mean, over every request due in the window, of the
time from its due time to its first token (none by the window's end, or
refused: its age then), as the end-to-end metric of that name defines it,
read in the traced run (spans on, the profiler over the window's last
slice). A cell whose TTFT swings too widely to gate end to end reports
it here, without a bound."""
from serve_bench import harness as H


def read(t):
    tt = H.ttfts(t.served)
    return sum(tt) / len(tt) * 1e3 if tt else None

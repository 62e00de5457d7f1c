"""tick_host_ms: the host's own work per tick: the mean, over the program's
tick records in the window and clear of the profiled slice, of ``end -
start - sync_s`` (a ``step()`` less the time it waited in its host syncs
for the card). Standard error gets the host ms per tick by the number of
requests the tick admitted."""
import sys

from serve_bench.metrics._program import ticks


def read(t):
    ks = ticks(t)
    if not ks:
        return None
    by = {}
    for k in ks:
        by.setdefault(k.admitted, []).append(k.end - k.start - k.sync_s)
    print("tick_host_ms: by requests admitted in the tick (ticks, host ms "
          "mean): " + ", ".join(
              f"{a}: ({len(v)}, {sum(v) / len(v) * 1e3:.3f})"
              for a, v in sorted(by.items())), file=sys.stderr)
    host = [h for v in by.values() for h in v]
    return sum(host) / len(host) * 1e3

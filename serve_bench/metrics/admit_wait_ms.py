"""admit_wait_ms: the median, over requests that reached their batcher's
queue and got a lane in the window, clear of the profiled slice, of the
program's own stamps ``admitted - queued`` (set by the batcher itself, not
polled). Standard error gets each pool's ticks, those whose admission
stopped on memory, and the p50 and max of the queue at a tick's end; the
requests that waited at the queue's head on memory (``times.blocked``)
and their ticks there; and, over the requests that finished in the same
span, the median first token after admission (``emitted[0] - admitted``)
and life (``done - arrived``)."""
import statistics
import sys

from serve_bench.metrics._program import clear, stamps, ticks


def _p50_ms(v):
    return statistics.median(v) * 1e3 if v else float("nan")


def read(t):
    ts = [tm for tm in stamps(t)
          if tm.admitted is not None and tm.queued is not None
          and clear(t, tm.queued, tm.admitted)]
    logged = ticks(t) or []
    for pool in sorted({k.pool for k in logged}):
        ks = [k for k in logged if k.pool == pool]
        q = sorted(k.queued for k in ks)
        print(f"admit_wait_ms: pool {pool}: {len(ks)} ticks, "
              f"{sum(k.blocked for k in ks)} stopped on memory; queue at a "
              f"tick's end p50 {q[len(q) // 2]}, max {q[-1]}", file=sys.stderr)
    if not ts:
        return None
    waited = [tm.blocked for tm in ts if tm.blocked]
    done = [tm for tm in ts if tm.done is not None and tm.emitted
            and clear(t, tm.arrived, tm.done)]
    print(f"admit_wait_ms: {len(ts)} admitted, {len(waited)} waited on "
          f"memory ({sum(waited)} ticks, at most {max(waited, default=0)}); "
          f"{len(done)} done: first token after admission p50 "
          f"{_p50_ms([tm.emitted[0] - tm.admitted for tm in done]):.3f} ms, "
          f"life p50 {_p50_ms([tm.done - tm.arrived for tm in done]):.3f} ms",
          file=sys.stderr)
    return _p50_ms([tm.admitted - tm.queued for tm in ts])

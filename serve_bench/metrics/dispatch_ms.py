"""dispatch_ms: the mean, over requests submitted in the window and clear
of the profiled slice, of the program's own stamps ``routed - arrived``:
``FleetRouter.submit`` from its entry to the resolved plan (the fleet
snapshot where the policy reads it, ``scheduler.dispatch``,
``resolve_plan``, ``observe``), without the booking and the enqueue that
``route_ms`` also holds. Standard error gets those two beside it: the
means of ``booked - routed`` (the ``PoolStats`` booking) and of ``queued -
booked`` (the ``Request`` built and queued)."""
import sys

from serve_bench.metrics._program import clear, stamps


def _mean_ms(v):
    return sum(v) / len(v) * 1e3


def read(t):
    ts = [tm for tm in stamps(t) if tm.queued is not None
          and clear(t, tm.arrived, tm.queued)]
    if not ts:
        return None
    print(f"dispatch_ms: {len(ts)} submits; booking "
          f"{_mean_ms([tm.booked - tm.routed for tm in ts]):.4f} ms, enqueue "
          f"{_mean_ms([tm.queued - tm.booked for tm in ts]):.4f} ms",
          file=sys.stderr)
    return _mean_ms([tm.routed - tm.arrived for tm in ts])

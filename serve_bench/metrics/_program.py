"""What the program records itself (``repro_torch.serving.trace``): each
request's ``times`` and the process's tick log, both ``time.perf_counter``
stamps, the harness's own clock, so a window time is a stamp less
``served.t0``. A program that keeps no such records gives nothing here,
and its readers return None.

The readers count only what lies in the window and clear of the profiled
slice: under the profiler the card waits inside each ``cudaGraphLaunch``
for milliseconds, so a record that overlaps the slice would mix traced
host time with untraced (``clear``)."""


def clear(t, a, b):
    """Whether the program stamps ``a`` <= ``b`` lie in the window and
    outside the profiled slice."""
    a, b = a - t.served.t0, b - t.served.t0
    s0, s1 = t.served.slice_t0, t.served.slice_t1
    return t.in_window(a, b) and (s0 is None or b < s0 or a > s1)


def stamps(t):
    """The ``times`` of every request the run submitted, where the program
    keeps them."""
    out = []
    for r in t.served.reqs:
        tm = getattr(r.req, "times", None)
        if tm is not None:
            out.append(tm)
    return out


def ticks(t):
    """The program's tick records (``trace.Tick``) that lie in the window,
    clear of the profiled slice; None when the program keeps no tick log."""
    try:
        from repro_torch.serving import trace
    except ImportError:
        return None
    return [k for k in trace.TICKS if clear(t, k.start, k.end)]

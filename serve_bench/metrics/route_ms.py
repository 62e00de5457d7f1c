"""route_ms: host milliseconds inside ``FleetRouter.submit`` per submit,
over the window (the router layer: ``serving/router.py`` and the
``core`` scheduler, pricing and settlement it calls)."""


def read(t):
    d = [b - a for n, a, b, _ in t.spans
         if n == "router.submit" and t.in_window(a, b)]
    return sum(d) / len(d) * 1e3 if d else None

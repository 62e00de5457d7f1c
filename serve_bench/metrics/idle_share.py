"""idle_share: the share of the time inside ``batcher.step`` spans in
which no operation ran on the card: the host holding the card back
inside a tick, not slack from the offered load. A device op belongs to
the tick whose span holds its launch (the tick ends in a host sync, so
it also ran inside that tick); the busy time is the union of the tick's
ops."""
from serve_bench import harness as H


def read(t):
    p = t.profile
    steps = H.spans_of(p, "batcher.step")
    total = sum(b - a for a, b in steps)
    if not total:
        return None
    mine = {}
    for ts, te, at in p.device:
        i = H.place(steps, at)
        if i >= 0:
            mine.setdefault(i, []).append((ts, te))
    busy = sum(b - a for iv in mine.values() for a, b in H.union(iv))
    return (1.0 - busy / total) * 100.0
